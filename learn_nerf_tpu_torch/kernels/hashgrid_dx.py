"""The hash-grid encoding's gradient in the points, and that gradient's own
backward: the CUDA kernels, their plain versions and the wrappers.

Ref-NeRF's normal is the negative gradient of the density in the points,
which the JAX package takes with ``jax.vjp`` through the hash-grid
encoding (``learn_nerf_tpu/models/ref_nerf.py:71-74`` over
``learn_nerf_tpu/ops/hashgrid.py:135``), and its ``normal_mse`` loss
differentiates that gradient once more, into the tables and the MLP.  Both
are XLA ops there; here they are two kernels of ``csrc/hashgrid_dx.cu``:

* ``hashgrid_dx_kernel``: points ``x [N, 3]`` and the encoding's cotangent
  ``g [N, L * F]`` give ``dx [N, 3]``, the encoding's VJP in the points
  (on the encode kernel's thread grid where a level hashes, a thread a
  point where none does);
* ``hashgrid_dx_backward_kernel``: that function's VJP for a cotangent
  ``h [N, 3]``, in ``g`` (``[N, L * F]``) and in every table (one padded
  flat buffer, laid out as :mod:`.hashgrid_backward`'s), in one launch (the
  table-gradient kernel's layout, run combining and pair atomics).

:class:`HashGridDx` joins them for autograd: its forward launches the first
kernel, its backward the second.  It is differentiable in ``g`` and the
tables, not in the points: points that require grad raise (no path needs
the second derivative in the points, and a silent ``None`` would train
wrong).

:func:`hashgrid_dx` runs the plain version for CPU tensors
(``ops.hashgrid.hash_grid_encode_dx_reference``, under plain autograd) and
the kernels for CUDA tensors, with no fallback between the two.  The plain
version of the backward is ``ops.hashgrid.hash_grid_encode_dx_backward_reference``.
Both launches go through module-level launchers (:data:`_cuda_launcher`,
:data:`_backward_launcher`), which a CPU test swaps for the plain versions
to hold the autograd wiring where there is no card.
"""

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..ops.hashgrid import dense_level_rows, hash_grid_encode_dx_reference
from . import build
from .hashgrid import bbox_floats
from .hashgrid_backward import level_offsets
from .hashgrid_encode import EncodeArgs, check_points, encode_args

Tensor = torch.Tensor

counter = build.LaunchCounter()
backward_counter = build.LaunchCounter()

# Points of the backward kernel's block tile (csrc/encode_args.cuh
# kTilePoints): it takes fewer than 2^31 tiles.
TILE_POINTS = 32


def _check_cotangent(t: Tensor, n: int, width: int, device: torch.device, what: str) -> None:
    if t.dtype != torch.float32 or t.shape != (n, width) or not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"want a contiguous f32 {what} [{n}, {width}] on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )


def run_dx(entry, args: EncodeArgs, x: Tensor, g: Tensor) -> Tensor:
    """``dx [N, 3]`` by the C entry point ``entry`` (the built library's
    ``nerf_hashgrid_dx``, or a measured variant's, such as
    ``nerf_hashgrid_dx_parent``) on operands that passed
    :func:`launch_dx`'s checks; counts nothing."""
    n, device = x.shape[0], x.device
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    if n == 0:
        return out
    with build.launch_context(device):
        err = entry(x.data_ptr(), g.data_ptr(), n, ctypes.byref(args), out.data_ptr(), build.current_stream(device))
    build.check_launch(build.library(), err, "hashgrid_dx")
    return out


def run_dx_backward(entry, args: EncodeArgs, x: Tensor, g: Tensor, h: Tensor) -> Tuple[Tensor, List[Tensor]]:
    """``(grad_g, per-level table gradients)`` by the C entry point
    ``entry`` (``nerf_hashgrid_dx_backward`` or a variant's) on operands
    that passed :func:`launch_dx_backward`'s checks; counts nothing."""
    n, device = x.shape[0], x.device
    levels, features = args.levels, args.features
    rows = [dense_level_rows(args.grid[level], args.size[level]) for level in range(levels)]
    flat = torch.zeros((level_offsets(args)[-1], features), dtype=torch.float32, device=device)
    grads = list(flat.split([piece for r in rows for piece in (r, r % 2)])[::2])
    grad_g = torch.empty((n, levels * features), dtype=torch.float32, device=device)
    if n == 0:
        return grad_g, grads
    with build.launch_context(device):
        err = entry(
            x.data_ptr(), g.data_ptr(), h.data_ptr(), n, ctypes.byref(args), grad_g.data_ptr(),
            flat.data_ptr(), build.current_stream(device),
        )
    build.check_launch(build.library(), err, "hashgrid_dx_backward")
    return grad_g, grads


def launch_dx(args: EncodeArgs, x: Tensor, g: Tensor) -> Tensor:
    """Launch ``hashgrid_dx_kernel`` on the current stream with a packed
    argument: ``x [N, 3]``, ``g [N, L * F]`` -> ``dx [N, 3]``."""
    check_points(x)
    n = x.shape[0]
    _check_cotangent(g, n, args.levels * args.features, x.device, "cotangent g")
    if n >= 2**31:
        raise ValueError(f"{n} points: the kernel takes fewer than 2^31")
    out = run_dx(build.library().nerf_hashgrid_dx, args, x, g)
    if n:
        counter.launches += 1
    return out


def launch_dx_backward(args: EncodeArgs, x: Tensor, g: Tensor, h: Tensor) -> Tuple[Tensor, List[Tensor]]:
    """Launch ``hashgrid_dx_backward_kernel`` on the current stream.

    :return: ``(grad_g [N, L * F], per level [rows_l, F])``: the table
        gradients are views of one zeroed flat buffer.
    """
    check_points(x)
    n, device = x.shape[0], x.device
    _check_cotangent(g, n, args.levels * args.features, device, "cotangent g")
    _check_cotangent(h, n, 3, device, "cotangent h")
    tiles = -(-n // TILE_POINTS)
    if tiles >= 2**31:
        raise ValueError(f"{n} points make {tiles} tiles of {TILE_POINTS}, past the kernel's 2^31")
    out = run_dx_backward(build.library().nerf_hashgrid_dx_backward, args, x, g, h)
    if n:
        backward_counter.launches += 1
    return out


# The launches behind every call on the card; a CPU test swaps in the
# plain versions to hold the autograd wiring where there is no card.
_cuda_launcher = launch_dx
_backward_launcher = launch_dx_backward


class HashGridDx(torch.autograd.Function):
    """The encoding's VJP in the points with its own gradient in ``g`` and
    the tables: forward is one launch of ``hashgrid_dx_kernel``, backward
    one launch of ``hashgrid_dx_backward_kernel``."""

    @staticmethod
    def forward(ctx, x, g, config, *tables):
        grid_sizes, table_sizes, bbox_min, bbox_max, smooth = config
        args = encode_args(tables, x.device, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
        out = _cuda_launcher(args, x, g)
        ctx.save_for_backward(x, g, *tables)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, g, *_ = ctx.saved_tensors
        grad_g, grads = _backward_launcher(ctx.args, x, g, grad_out.float().contiguous())
        needed = ctx.needs_input_grad
        return (
            None, grad_g if needed[1] else None, None,
            *(t if need else None for t, need in zip(grads, needed[3:])),
        )


def hashgrid_dx(
    tables: Sequence[Tensor],
    x: Tensor,
    g: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min,
    bbox_max,
    smooth: bool,
) -> Tensor:
    """The encoding's VJP in the points: ``x [N, 3]``, ``g [N, L * F]`` ->
    ``[N, 3]`` f32, differentiable in ``g`` and the tables (through
    :class:`HashGridDx` on the card).  Points that require grad raise on
    either device.  With nothing requiring grad, or grad off (serving, the
    occupancy grid's refresh), the kernel is launched directly and nothing
    is saved."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "the encoding's gradient in the points has no gradient in the points itself (no path "
            "needs it); detach the points"
        )
    x = x.float().contiguous()
    g = g.float().contiguous()
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return hash_grid_encode_dx_reference(tables, x, g, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
    return _dx_on_card(tables, x, g, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)


def _dx_on_card(tables, x, g, grid_sizes, table_sizes, bbox_min, bbox_max, smooth) -> Tensor:
    if torch.is_grad_enabled() and (g.requires_grad or any(t.requires_grad for t in tables)):
        config = (
            tuple(grid_sizes), tuple(table_sizes), tuple(bbox_floats(bbox_min)),
            tuple(bbox_floats(bbox_max)), bool(smooth),
        )
        return HashGridDx.apply(x, g, config, *tables)
    args = encode_args(tables, x.device, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
    return _cuda_launcher(args, x, g)
