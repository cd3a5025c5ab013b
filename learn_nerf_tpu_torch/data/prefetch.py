"""Host-to-device input prefetch for the training hot loop (in place of
``learn_nerf_tpu.data.prefetch``).

Each host batch is staged in pinned memory and copied with
``non_blocking=True``, which only enqueues the transfer; keeping ``depth``
batches in flight overlaps the upload of batch ``i + 1`` with step ``i``.
On the CPU the batches pass through as tensors.
"""

from collections import deque
from typing import Iterable, Iterator, Union

import numpy as np
import torch


def to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host batch as a float32 tensor on ``device`` (through pinned
    memory and an asynchronous copy when that is a CUDA device)."""
    tensor = torch.from_numpy(np.ascontiguousarray(batch, dtype=np.float32))
    if device.type != "cuda":
        return tensor.to(device)
    return tensor.pin_memory().to(device, non_blocking=True)


def prefetch_to_device(
    iterator: Iterable[np.ndarray], device: Union[str, torch.device], depth: int = 2
) -> Iterator[torch.Tensor]:
    """Yield each batch on ``device`` with ``depth`` transfers dispatched
    ahead (2 = double buffering)."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    device = torch.device(device)
    buf = deque()
    for item in iterator:
        buf.append(to_device(item, device))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
