"""The table gradients of the hash-grid encoding in one launch: the CUDA
kernel, its plain version and the wrapper.

The vector-Jacobian product of the JAX package's ``hash_grid_encode`` in
its tables (``learn_nerf_tpu/ops/hashgrid.py:198-203`` under ``jax.grad``,
which XLA lowers to one scatter-add per level): points ``x [N, 3]`` and the
encoding's cotangent ``g [N, L * F]`` give, per level, ``grad_l [rows_l, F]``
with ``grad_l[row_c] += w_c * g[p, l*F:(l+1)*F]`` over the 8 corners of
each point's cell (``csrc/hashgrid_backward.cu``,
``hashgrid_backward_kernel``).  The kernel recomputes rows and weights with
the encode kernel's own code, so the forward saves only ``x``.  A warp
takes one work item for 32 consecutive points and sums the points of one
cell before it adds, so callers that feed points along rays (the renderers
do) cost fewer atomics; any order gives the same result to rounding.

All levels' gradients are views of ONE flat zeroed buffer (one memset), in
level order, each from an even row on: the kernel adds two neighbouring
rows with one vector atomic of 2F floats, which must be aligned to its own
size.  :func:`level_offsets` is the layout, which the C entry point
computes the same way.  Sums are f32 atomics, whose order changes from run
to run: two runs agree to rounding, not bit for bit.

:func:`hashgrid_backward` runs the plain version for CPU tensors (autograd
through ``ops.hashgrid.hash_grid_encode_reference``) and the kernel for
CUDA tensors, with no fallback between the two.
:class:`~.hashgrid_encode.HashGridEncode` is what training runs.
"""

import ctypes
from typing import List, Sequence

import torch

from ..ops.hashgrid import dense_level_rows, hash_grid_encode_reference
from . import build
from .hashgrid_encode import EncodeArgs, check_points, encode_args

Tensor = torch.Tensor

counter = build.LaunchCounter()


def level_offsets(args: EncodeArgs) -> List[int]:
    """Row offset of each level's gradient in the flat buffer, and the
    buffer's rows as the last entry (multiply by F for floats).  A level of
    an odd row count is followed by one row of padding, so every level
    starts at an even row."""
    offsets = [0]
    for level in range(args.levels):
        rows = dense_level_rows(args.grid[level], args.size[level])
        offsets.append(offsets[-1] + rows + rows % 2)
    return offsets


def hashgrid_backward_reference(
    tables: Sequence[Tensor],
    x: Tensor,
    grad_out: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min,
    bbox_max,
    smooth: bool,
) -> List[Tensor]:
    """Plain PyTorch version: autograd through the plain encoding
    (``index_select``'s own backward).  The encoding is linear in the
    tables, so only their shapes are read."""
    leaves = [torch.zeros_like(t).requires_grad_() for t in tables]
    with torch.enable_grad():
        out = hash_grid_encode_reference(
            leaves, x.detach(), grid_sizes, table_sizes, bbox_min, bbox_max, smooth
        )
    return list(torch.autograd.grad(out, leaves, grad_out))


def hashgrid_backward_cuda(x: Tensor, grad_out: Tensor, args: EncodeArgs) -> List[Tensor]:
    """Launch the kernel on the current stream.

    :param x: ``[N, 3]`` contiguous f32 points on the card.
    :param grad_out: ``[N, L * F]`` contiguous f32 cotangent.
    :param args: the encode kernel's packed argument for these levels
        (:func:`~.hashgrid_encode.encode_args`).
    :return: per level, ``[rows_l, F]`` f32: views of one flat buffer.
    """
    check_points(x)
    n, device = x.shape[0], x.device
    levels, features = args.levels, args.features
    if (grad_out.dtype != torch.float32 or grad_out.shape != (n, levels * features)
            or not grad_out.is_contiguous() or grad_out.device != device):
        raise ValueError(
            f"want a contiguous f32 cotangent [{n}, {levels * features}] on {device}; got "
            f"{grad_out.dtype} {tuple(grad_out.shape)} on {grad_out.device}"
        )
    rows = [dense_level_rows(args.grid[level], args.size[level]) for level in range(levels)]
    flat = torch.zeros((level_offsets(args)[-1], features), dtype=torch.float32, device=device)
    # One call for all views: each level, then its row of padding (if any).
    grads = list(flat.split([piece for r in rows for piece in (r, r % 2)])[::2])
    if n == 0:
        return grads
    lib = build.library()
    with build.launch_context(device):
        err = lib.nerf_hashgrid_backward(
            x.data_ptr(), grad_out.data_ptr(), n, ctypes.byref(args), flat.data_ptr(),
            build.current_stream(device),
        )
    build.check_launch(lib, err, "hashgrid_backward")
    counter.launches += 1
    return grads


def hashgrid_backward(
    tables: Sequence[Tensor],
    x: Tensor,
    grad_out: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min,
    bbox_max,
    smooth: bool,
) -> List[Tensor]:
    """Per-level table gradients of the encoding of ``x [N, 3]`` for the
    cotangent ``grad_out [N, L * F]``."""
    x = x.detach().float().contiguous()
    grad_out = grad_out.float().contiguous()
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return hashgrid_backward_reference(
            tables, x, grad_out, grid_sizes, table_sizes, bbox_min, bbox_max, smooth
        )
    args = encode_args(tables, x.device, grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
    return hashgrid_backward_cuda(x, grad_out, args)
