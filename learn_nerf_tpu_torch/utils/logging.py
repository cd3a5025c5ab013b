"""Training metric logging (port of ``learn_nerf_tpu.utils.logging``).

Emits the line ``step {i}: k=v ...`` with a throughput counter
(``rays_per_sec``, a running mean of rays per step over the interval
between calls).

Reading the loss tensors of the step just queued would synchronise the
card every step.  The logger instead starts one non-blocking copy of all
the step's metrics into pinned host memory when they are logged, and
prints each step's line one step late, when the copy has long landed.
Call :meth:`MetricLogger.flush` after the loop to emit the final line.
"""

import sys
import time
from typing import Dict, List, Optional

import torch


class _Pending:
    """One step's metrics on their way to the host."""

    def __init__(self, step: int, values: Dict[str, object], rate: Optional[float]):
        self.step, self.rate = step, rate
        self.keys: List[str] = list(values)
        self.event = None
        cuda = [v for v in values.values() if isinstance(v, torch.Tensor) and v.is_cuda]
        if cuda:
            device = cuda[0].device
            stacked = torch.stack([
                torch.as_tensor(v, dtype=torch.float32, device=device).detach().reshape(())
                for v in values.values()
            ])
            self.host = torch.empty(stacked.shape, dtype=torch.float32, pin_memory=True)
            self.host.copy_(stacked, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = [float(v) for v in values.values()]

    def floats(self) -> List[float]:
        if self.event is not None:
            self.event.synchronize()
            return self.host.tolist()
        return self.host


class MetricLogger:
    def __init__(self, rays_per_step: Optional[int] = None, out=None):
        self.rays_per_step = rays_per_step
        self.out = out if out is not None else sys.stdout
        self._last_time: Optional[float] = None
        self._ema_rate: Optional[float] = None
        self._pending: Optional[_Pending] = None

    def log_step(self, step: int, values: Dict[str, object]) -> None:
        # The interval between calls is the step's wall time, attached to
        # the producing step's own line when it prints.
        now = time.monotonic()
        if self.rays_per_step is not None and self._last_time is not None:
            dt = now - self._last_time
            if dt > 0:
                rate = self.rays_per_step / dt
                self._ema_rate = rate if self._ema_rate is None else 0.9 * self._ema_rate + 0.1 * rate
        self._last_time = now

        pending, self._pending = self._pending, _Pending(step, values, self._ema_rate)
        if pending is not None:
            self._emit(pending)

    def flush(self) -> None:
        """Print the deferred final line (call once after the loop)."""
        if self._pending is not None:
            self._emit(self._pending)
            self._pending = None

    def _emit(self, pending: _Pending) -> None:
        parts = [f"{k}={v:.05}" for k, v in zip(pending.keys, pending.floats())]
        if pending.rate is not None:
            parts.append(f"rays_per_sec={pending.rate:.05}")
        print(f"step {pending.step}: {' '.join(parts)}", file=self.out, flush=True)
