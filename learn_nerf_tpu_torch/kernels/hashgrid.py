"""Hash-grid corner indices and weights for all levels: the CUDA kernel and
its plain version.

The forward index half of the hash-grid encoding, which the JAX package
leaves to XLA (``learn_nerf_tpu/ops/hashgrid.py:43-99``,
``corner_weights_and_coords`` + ``level_indices``): for points ``[N, 3]``
and L levels, the table row ``idx [L, N, 8]`` (int32) and the trilinear
weight ``w [L, N, 8]`` (f32) of each cell corner, in one launch
(``csrc/hashgrid.cu``, ``hashgrid_corners_kernel``).  The kernel's f32
operations round as the plain version's (no contracted multiply-adds), so
its indices equal the plain version's.

:func:`hashgrid_corners` runs the plain version for CPU tensors and the
kernel for CUDA tensors, with no fallback between the two.  Serving runs
the all-level encode kernel (:mod:`.hashgrid_encode`), which shares this
kernel's corner math (``csrc/hashgrid.cuh``) and keeps indices and weights
in registers; this kernel is for what needs them in memory.
"""

import ctypes
from typing import Sequence, Tuple

import torch

from ..ops.hashgrid import corner_weights_and_coords, level_indices
from . import build

Tensor = torch.Tensor

counter = build.LaunchCounter()

# Levels the kernel takes in one launch (csrc/hashgrid.cu kMaxLevels).
MAX_LEVELS = 32


def hashgrid_corners_reference(
    x: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min: Tensor,
    bbox_max: Tensor,
    smooth: bool,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel.

    :param x: ``[N, 3]`` f32 points.
    :return: ``(idx [L, N, 8] int32, w [L, N, 8] f32)``.
    """
    idx, w = [], []
    for g, t in zip(grid_sizes, table_sizes):
        coords, weights = corner_weights_and_coords(x, g, bbox_min, bbox_max, smooth)
        idx.append(level_indices(coords, g, t))
        w.append(weights)
    return torch.stack(idx), torch.stack(w)


def check_level_sizes(grid_sizes: Sequence[int], table_sizes: Sequence[int]) -> None:
    """Raise on level lists the kernels do not take."""
    levels = len(grid_sizes)
    if not 1 <= levels <= MAX_LEVELS or len(table_sizes) != levels:
        raise ValueError(f"want 1 to {MAX_LEVELS} levels with one table size each")
    if min(grid_sizes) < 2 or max(grid_sizes) >= 2**31 or not 1 <= min(table_sizes) <= max(table_sizes) < 2**31:
        raise ValueError(f"grid sizes {list(grid_sizes)} / table sizes {list(table_sizes)} out of range")


def bbox_floats(bbox) -> list:
    """Three floats of a bbox corner given as a tensor or a sequence (pass
    a sequence on the hot path: a CUDA tensor costs a device sync)."""
    values = [float(v) for v in (bbox.tolist() if isinstance(bbox, Tensor) else bbox)]
    if len(values) != 3:
        raise ValueError(f"want a [3] bbox corner, got {values}")
    return values


def hashgrid_corners_cuda(
    x: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min: Tensor,
    bbox_max: Tensor,
    smooth: bool,
) -> Tuple[Tensor, Tensor]:
    """Launch the kernel on the current stream (shapes as the reference)."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"want contiguous f32 points [N, 3]; got {x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"want points on a CUDA device; got {x.device}")
    check_level_sizes(grid_sizes, table_sizes)
    build.require_hopper(x.device)
    levels = len(grid_sizes)
    n = x.shape[0]
    idx = torch.empty((levels, n, 8), dtype=torch.int32, device=x.device)
    w = torch.empty((levels, n, 8), dtype=torch.float32, device=x.device)
    if n == 0:
        return idx, w
    grids = (ctypes.c_int * levels)(*grid_sizes)
    tables = (ctypes.c_int * levels)(*table_sizes)
    hashed = (ctypes.c_int * levels)(*(int(g**3 > t) for g, t in zip(grid_sizes, table_sizes)))
    lib = build.library()
    with build.launch_context(x.device):
        err = lib.nerf_hashgrid_corners(
            x.data_ptr(), n, grids, tables, hashed, levels,
            *bbox_floats(bbox_min), *bbox_floats(bbox_max), int(bool(smooth)),
            idx.data_ptr(), w.data_ptr(), build.current_stream(x.device),
        )
    build.check_launch(lib, err, "hashgrid_corners")
    counter.launches += 1
    return idx, w


def hashgrid_corners(
    x: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min: Tensor,
    bbox_max: Tensor,
    smooth: bool,
) -> Tuple[Tensor, Tensor]:
    """Corner rows and weights of every level: ``x [N, 3]`` ->
    ``(idx [L, N, 8] int32, w [L, N, 8] f32)``."""
    x = x.float().contiguous()
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return hashgrid_corners_reference(x, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
    return hashgrid_corners_cuda(x, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
