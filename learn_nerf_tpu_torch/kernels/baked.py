"""The baked Instant-NGP lookup: the CUDA kernel and its plain version.

The JAX package's ``BakedInstantNGP.__call__`` evaluates its spatial field
with one trilinear lookup in a dense vertex lattice, an XLA gather and sum
(``learn_nerf_tpu/baked.py:118-158``); here ``csrc/baked.cu``,
``baked_lookup_kernel`` (in one of two thread layouts, by the table's type
and pack).  Points ``x [N, 3]`` in an ``r^3`` lattice over
the bbox, the table ``grid [r^3, pack * F]`` (bf16 or f32, x-major rows,
segment ``s`` of a row = the corner whose low bits are ``s``, see
:mod:`..baked`) give ``[N, F]`` f32: each point reads the ``8 / pack``
rows of the corners ``0, pack, 2 pack, ...`` and sums the 8 weighted
corners in f32.

:func:`baked_lookup` runs the plain version for CPU tensors and the kernel
for CUDA tensors, with no fallback between the two.  The table is for
inference only: with grad enabled, a ``grid`` or ``x`` that requires grad
raises (a kernel result written into ``torch.empty`` would come back
detached from them).
"""

from typing import Sequence

import torch

from ..ops.hashgrid import corner_weights_and_coords
from . import build
from .hashgrid import bbox_floats

Tensor = torch.Tensor

counter = build.LaunchCounter()

PACKS = (1, 2, 4, 8)
# The features a row segment holds in the kernel (the NGP density_dim).
KERNEL_FEATURES = 16
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def baked_lookup_reference(
    grid: Tensor, x: Tensor, resolution: int, pack: int, bbox_min, bbox_max
) -> Tensor:
    """Plain PyTorch version of the kernel (``baked.py:118-158``): the row
    corners at a stride of ``pack``, their rows gathered, reshaped to the
    standard ``[N, 8, F]`` corner order, the weighted sum in f32."""
    r = resolution
    coords, weights = corner_weights_and_coords(x, r, bbox_min, bbox_max, smooth=False)
    rows = coords[:, ::pack]  # [N, 8 / pack, 3]
    idx = rows[..., 0] + r * (rows[..., 1] + r * rows[..., 2])
    feats = grid.index_select(0, idx.reshape(-1)).float().view(x.shape[0], 8, -1)
    return (weights[..., None] * feats).sum(dim=-2)


def check_lookup(grid: Tensor, x: Tensor, resolution: int, pack: int) -> None:
    """What both routes take: ``grid [r^3, pack * F]``, ``x [N, 3]`` on one
    device, and nothing that requires grad while grad is enabled."""
    if pack not in PACKS:
        raise ValueError(f"pack must be one of {PACKS}; got {pack}")
    if resolution < 2:
        raise ValueError(f"the lattice needs at least 2 vertices a side; got {resolution}")
    if grid.dim() != 2 or grid.shape[0] != resolution**3 or grid.shape[1] % pack:
        raise ValueError(
            f"want grid [{resolution}^3, pack * F] for pack {pack}; got {tuple(grid.shape)}"
        )
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"want points [N, 3]; got {tuple(x.shape)}")
    if grid.device != x.device:
        raise ValueError(f"grid on {grid.device}, points on {x.device}")
    if torch.is_grad_enabled() and (grid.requires_grad or x.requires_grad):
        raise NotImplementedError(
            "the baked table is for inference only: its lookup has no gradient "
            "(detach the table and the points, or run under torch.no_grad())"
        )


def _check_card_operands(grid: Tensor, x: Tensor) -> None:
    """Raise on what the kernel does not take (no check reads the device)."""
    if grid.device.type != "cuda":
        raise ValueError(f"want tensors on a CUDA device; got {grid.device}")
    if grid.dtype not in KERNEL_DTYPES or x.dtype != torch.float32:
        raise ValueError(f"want a bf16 or f32 table and f32 points; got {grid.dtype}, {x.dtype}")
    if not (grid.is_contiguous() and x.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands")
    if grid.data_ptr() % 16:
        raise ValueError("the table must be aligned to 16 bytes")
    build.require_hopper(grid.device)


def launch_lookup(
    grid: Tensor, x: Tensor, resolution: int, pack: int, bbox_min, bbox_max
) -> Tensor:
    """Launch the kernel on the current stream (operands as
    :func:`check_lookup` takes them; F must be ``KERNEL_FEATURES``)."""
    _check_card_operands(grid, x)
    features = grid.shape[1] // pack
    if features != KERNEL_FEATURES:
        raise ValueError(f"the kernel takes F = {KERNEL_FEATURES} features a corner; got {features}")
    n = x.shape[0]
    out = torch.empty((n, features), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    lib = build.library()
    with build.launch_context(x.device):
        err = lib.nerf_baked_lookup(
            grid.data_ptr(), int(grid.dtype == torch.bfloat16), pack, features,
            x.data_ptr(), n, resolution, *bbox_floats(bbox_min), *bbox_floats(bbox_max),
            out.data_ptr(), build.current_stream(x.device),
        )
    build.check_launch(lib, err, "baked_lookup")
    counter.launches += 1
    return out


# The launch behind every call on a device other than the CPU; a CPU test
# swaps in a stand-in to see which route a call takes.
_cuda_launcher = launch_lookup


def baked_lookup(
    grid: Tensor,
    x: Tensor,
    resolution: int,
    pack: int,
    bbox_min: Sequence[float],
    bbox_max: Sequence[float],
) -> Tensor:
    """Trilinear lookup of ``x [N, 3]`` in the baked table: ``[N, F]`` f32.

    ``bbox_min``/``bbox_max`` are three floats each (a CUDA tensor costs a
    device sync).
    """
    check_lookup(grid, x, resolution, pack)
    x = x.float().contiguous()
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return baked_lookup_reference(grid, x, resolution, pack, bbox_min, bbox_max)
    return _cuda_launcher(grid.contiguous(), x, resolution, pack, bbox_min, bbox_max)
