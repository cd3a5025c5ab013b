"""The whole hash-grid encoding of all levels in one launch: the CUDA
kernel, its plain route, and the argument it takes.

The JAX package's ``hash_grid_encode`` (``learn_nerf_tpu/ops/hashgrid.py:135``,
non-fused path), which it leaves to XLA: points ``x [N, 3]`` and per-level
f32 tables ``[rows_l, F]`` (F from 1 to 4, up to 32 levels) give
``[N, L * F]``, level ``l``'s features at columns ``[l*F, (l+1)*F)``
(``csrc/hashgrid_encode.cu``, ``hashgrid_encode_kernel``).  The kernel
computes indices and weights with the corner kernel's own code
(``csrc/hashgrid.cuh``) and keeps them in registers.

Its work items are the JAX package's level runs (``_level_groups``:
consecutive levels of equal grid and table size share corners and weights),
cut into pieces of at most two levels.  :func:`pack_args` packs the levels,
the items and the table pointers into :class:`EncodeArgs`, the struct the
kernel takes by value; :func:`hashgrid_encode_cuda` packs it once per
model, keyed on the tables' data pointers, dtypes, shapes and strides (a
table moved or changed packs anew, with its checks), so a call builds no
ctypes arrays.

:func:`hashgrid_encode` runs the plain version for CPU tensors
(``ops.hashgrid.hash_grid_encode_reference``, level by level, under plain
autograd) and the kernel for CUDA tensors, with no fallback between the
two.  For tables that require grad the launch goes through
:class:`HashGridEncode`, whose backward is the table-gradient kernel of
:mod:`.hashgrid_backward`: a result of the kernel never comes back detached
from parameters that train.
"""

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from ..ops.hashgrid import check_levels, hash_grid_encode_reference
from . import build
from .hashgrid import MAX_LEVELS, bbox_floats, check_level_sizes
from .table_gather import MAX_COLUMNS

Tensor = torch.Tensor

counter = build.LaunchCounter()

# Levels of one run that one work item covers (csrc kLevelsPerItem).
LEVELS_PER_ITEM = 2
# Alignment of a table by F: the kernel reads a pair of rows as one vector
# of 2F floats at F <= 2, a row as one vector at F = 4.
ROW_ALIGNMENT = {1: 8, 2: 16, 3: 4, 4: 16}


class EncodeArgs(ctypes.Structure):
    """``csrc/hashgrid_encode.cu``'s ``EncodeArgs``, field for field."""

    _fields_ = [
        ("table", ctypes.c_void_p * MAX_LEVELS),
        ("grid", ctypes.c_int * MAX_LEVELS),
        ("size", ctypes.c_uint * MAX_LEVELS),
        ("hashed", ctypes.c_int * MAX_LEVELS),
        ("paired", ctypes.c_int * MAX_LEVELS),
        ("item_level", ctypes.c_int * MAX_LEVELS),
        ("item_levels", ctypes.c_int * MAX_LEVELS),
        ("items", ctypes.c_int),
        ("levels", ctypes.c_int),
        ("features", ctypes.c_int),
        ("smooth", ctypes.c_int),
        ("lo", ctypes.c_float * 3),
        ("hi", ctypes.c_float * 3),
    ]


def level_runs(grid_sizes: Sequence[int], table_sizes: Sequence[int]) -> List[Tuple[int, int]]:
    """Runs ``[i, j)`` of consecutive levels with equal (grid, table size),
    whose corners and weights are the same."""
    runs: List[Tuple[int, int]] = []
    i = 0
    while i < len(grid_sizes):
        j = i + 1
        while j < len(grid_sizes) and (grid_sizes[j], table_sizes[j]) == (grid_sizes[i], table_sizes[i]):
            j += 1
        runs.append((i, j))
        i = j
    return runs


def work_items(grid_sizes: Sequence[int], table_sizes: Sequence[int]) -> List[Tuple[int, int]]:
    """``(first level, levels)`` of each work item: the level runs cut into
    pieces of at most LEVELS_PER_ITEM levels."""
    return [
        (start, min(LEVELS_PER_ITEM, j - start))
        for i, j in level_runs(grid_sizes, table_sizes)
        for start in range(i, j, LEVELS_PER_ITEM)
    ]


def pack_args(
    tables: Sequence[Tensor],
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min,
    bbox_max,
    smooth: bool,
) -> EncodeArgs:
    """The kernel's by-value argument for these levels (no device work)."""
    check_levels(tables, grid_sizes, table_sizes)
    check_level_sizes(grid_sizes, table_sizes)
    levels = len(grid_sizes)
    items = work_items(grid_sizes, table_sizes)
    args = EncodeArgs()
    for level, (table, g, t) in enumerate(zip(tables, grid_sizes, table_sizes)):
        args.table[level] = table.data_ptr()
        args.grid[level] = g
        args.size[level] = t
        args.hashed[level] = int(g**3 > t)
        args.paired[level] = int(table.shape[0] % 2 == 0)
    for i, (first, count) in enumerate(items):
        args.item_level[i] = first
        args.item_levels[i] = count
    args.items, args.levels = len(items), levels
    args.features = tables[0].shape[1]
    args.smooth = int(bool(smooth))
    args.lo[:] = bbox_floats(bbox_min)
    args.hi[:] = bbox_floats(bbox_max)
    return args


def _check_tables(tables: Sequence[Tensor], device: torch.device) -> None:
    features = tables[0].shape[-1]
    if not 1 <= features <= MAX_COLUMNS:
        raise ValueError(f"the kernel takes 1 <= F <= {MAX_COLUMNS} features, got {features}")
    for level, table in enumerate(tables):
        if table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != features:
            raise ValueError(
                f"level {level}: want an f32 table [rows, {features}]; got {table.dtype} "
                f"{tuple(table.shape)}"
            )
        if not table.is_contiguous() or table.device != device:
            raise ValueError(f"level {level}: want a contiguous table on {device}; got {table.device}")
        if table.data_ptr() % ROW_ALIGNMENT[features]:
            raise ValueError(
                f"level {level}: the table must be aligned to {ROW_ALIGNMENT[features]} bytes "
                f"at F = {features}"
            )


_args_cache: Dict[tuple, EncodeArgs] = {}
_ARGS_CACHE_SIZE = 16


def args_key(tables, device, grid_sizes, table_sizes, bbox_min, bbox_max, smooth) -> tuple:
    """What a packed argument is cached on: everything its checks read,
    since the caching allocator hands a freed table's address to the next
    tensor."""
    return (
        device, tuple((v.data_ptr(), v.dtype, v.shape, v.stride(), v.device) for v in tables),
        tuple(grid_sizes), tuple(table_sizes), tuple(bbox_floats(bbox_min)),
        tuple(bbox_floats(bbox_max)), bool(smooth),
    )


def encode_args(
    tables: Sequence[Tensor],
    device: torch.device,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min,
    bbox_max,
    smooth: bool,
) -> EncodeArgs:
    """The packed argument for these tables, from the cache or packed (and
    checked) anew."""
    key = args_key(tables, device, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
    args = _args_cache.get(key)
    if args is None:
        args = _new_args(tables, device, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
        if len(_args_cache) >= _ARGS_CACHE_SIZE:
            _args_cache.clear()
        _args_cache[key] = args
    return args


def check_points(x: Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous():
        raise ValueError(f"want contiguous f32 points [N, 3]; got {x.dtype} {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"want points on a CUDA device; got {x.device}")


def launch_encode(args: EncodeArgs, x: Tensor) -> Tensor:
    """Launch the kernel on the current stream with a packed argument."""
    n, device = x.shape[0], x.device
    if n * args.items >= 2**31:
        raise ValueError(f"{n} points x {args.items} work items exceed the kernel's 2^31 threads")
    out = torch.empty((n, args.levels * args.features), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lib = build.library()
    with build.launch_context(device):
        err = lib.nerf_hashgrid_encode(
            x.data_ptr(), n, ctypes.byref(args), out.data_ptr(), build.current_stream(device),
        )
    build.check_launch(lib, err, "hashgrid_encode")
    counter.launches += 1
    return out


def hashgrid_encode_cuda(
    tables: Sequence[Tensor],
    x: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min,
    bbox_max,
    smooth: bool,
) -> Tensor:
    """Launch the kernel on the current stream: ``x [N, 3]`` -> ``[N, L*F]``.
    The result carries no graph: :func:`hashgrid_encode` wraps the launch
    for tables that require grad.

    ``bbox_min``/``bbox_max`` are three floats each (a CUDA tensor costs a
    device sync).
    """
    check_points(x)
    return _cuda_launcher(
        encode_args(tables, x.device, grid_sizes, table_sizes, bbox_min, bbox_max, smooth), x
    )


def _new_args(tables, device, grid_sizes, table_sizes, bbox_min, bbox_max, smooth) -> EncodeArgs:
    """Check the tables and the device, then pack the argument (once per
    model and device)."""
    args = pack_args(tables, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
    _check_tables(tables, device)
    build.require_hopper(device)
    size = build.library().nerf_hashgrid_encode_args_size()
    if size != ctypes.sizeof(EncodeArgs):
        raise RuntimeError(f"EncodeArgs is {ctypes.sizeof(EncodeArgs)} bytes here, {size} in the kernel")
    return args


class HashGridEncode(torch.autograd.Function):
    """The encode kernel with its gradient in the tables: forward is one
    launch of ``hashgrid_encode_kernel``, backward one launch of
    ``hashgrid_backward_kernel`` (:mod:`.hashgrid_backward`), which
    recomputes the corners from the saved points.  Not differentiable in
    the points."""

    @staticmethod
    def forward(ctx, x, config, *tables):
        grid_sizes, table_sizes, bbox_min, bbox_max, smooth = config
        check_points(x)
        args = encode_args(tables, x.device, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
        out = _cuda_launcher(args, x)
        if any(ctx.needs_input_grad[2:]):
            ctx.save_for_backward(x)
            ctx.args = args
        return out

    @staticmethod
    def backward(ctx, grad_out):
        from .hashgrid_backward import hashgrid_backward_cuda

        (x,) = ctx.saved_tensors
        grads = hashgrid_backward_cuda(x, grad_out.float().contiguous(), ctx.args)
        needed = ctx.needs_input_grad[2:]
        return (None, None, *(g if need else None for g, need in zip(grads, needed)))


# The launch behind every call on the card; a CPU test swaps in the plain
# version to hold the autograd wiring where there is no card.
_cuda_launcher = launch_encode


def hashgrid_encode(
    tables: Sequence[Tensor],
    x: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min,
    bbox_max,
    smooth: bool,
) -> Tensor:
    """All levels' features: ``x [N, 3]`` -> ``[N, L * F]`` f32.

    On a CUDA tensor the result is differentiable in the tables (through
    :class:`HashGridEncode`) and not in the points: points that require
    grad raise (the gradient in the points is :mod:`.hashgrid_dx`'s).  With no table requiring grad (serving, the occupancy
    grid's refresh) the kernel is launched directly and nothing is saved.
    """
    x = x.float().contiguous()
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return hash_grid_encode_reference(tables, x, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
    return _encode_on_card(tables, x, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)


def _encode_on_card(tables, x, grid_sizes, table_sizes, bbox_min, bbox_max, smooth) -> Tensor:
    if torch.is_grad_enabled():
        if x.requires_grad:
            raise NotImplementedError(
                "the encode kernel has no gradient in the points: Ref-NeRF's normals take "
                "it as the encoding's VJP in the points, ops.hashgrid.hash_grid_encode_dx "
                "(the hashgrid_dx kernels, differentiable in the cotangent and the tables); "
                "detach the points, or encode on the CPU"
            )
        if any(t.requires_grad for t in tables):
            config = (
                tuple(grid_sizes), tuple(table_sizes), tuple(bbox_floats(bbox_min)),
                tuple(bbox_floats(bbox_max)), bool(smooth),
            )
            return HashGridEncode.apply(x, config, *tables)
    return hashgrid_encode_cuda(tables, x, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
