"""Row gather from a feature table: the CUDA kernels and their plain version.

Port of ``tools/exp_gather.py`` (``pallas_gather``, the single-level form
of the hash-grid lookup): ``out[m, :] = table[idx[m], :]`` for an f32
``table [T, C]`` (C from 1 to 4) and int32 ``idx [M]`` of any length
(``csrc/table_gather.cu``).

Out-of-range indices follow ``jnp.take``'s default: an index in
``[-T, -1]`` wraps to ``T + idx``; any other index outside ``[0, T)``
gives a row of NaN.  The hash-grid path only makes in-range indices.

The TPU kernel held the whole table in VMEM.  The card has two kernels
for it (routes): the block route holds the whole table in every block's
own shared memory; the L2 route reads rows through the caches.
:func:`gather_route` picks one from the table's shape alone, by a
threshold measured on an H100: the block route for tables of at most
``BLOCK_TABLE_BYTES``, the L2 route for the rest.  A route is a rule of
shape, not a fallback: a launch that fails raises.

:func:`table_gather` runs the plain version for CPU tensors and the kernel
for CUDA tensors, with no fallback between the two.
"""

import torch

from . import build

Tensor = torch.Tensor

counter = build.LaunchCounter()

MAX_COLUMNS = 4
# The threshold, from scripts/hashgrid_ablations.py's sweep on an NVIDIA
# H100 80GB HBM3 at 700 W (999,424 indices, C = 2, graph replay, two
# turns): the block route took 4.4-4.5 / 4.7-4.8 / 5.0-5.1 / 5.7-5.8 /
# 6.4-6.6 us on tables of 16 / 32 / 64 / 128 / 192 KiB, where the L2 route
# took 4.8 / 5.7-5.8 / 5.6-5.8 / 6.8 / 7.9-8.0 us: the block route takes
# tables up to the largest size measured.  Past it the table's slices held
# across a thread block cluster (csrc/ablations/table_gather_cluster.cu)
# took 12.3-22.4 us on tables of 256 KiB to 2 MiB where the L2 route took
# 8.7-10.0 us (the same sweep): every larger table takes the L2 route.
BLOCK_TABLE_BYTES = 192 << 10


def gather_route(rows: int, columns: int) -> str:
    """The route for a ``[rows, columns]`` f32 table, from its shape alone:
    "block" where the table has rows and fits in ``BLOCK_TABLE_BYTES``,
    else "l2"."""
    if not 1 <= columns <= MAX_COLUMNS or rows < 0:
        raise ValueError(f"want a [T, C] table with T >= 0 and 1 <= C <= {MAX_COLUMNS}; got [{rows}, {columns}]")
    return "block" if 0 < rows * 4 * columns <= BLOCK_TABLE_BYTES else "l2"


def table_gather_reference(table: Tensor, idx: Tensor) -> Tensor:
    """Plain PyTorch version of the kernel (``jnp.take(table, idx, 0)``).

    :param table: ``[T, C]`` f32.
    :param idx: ``[M]`` integer row indices.
    :return: ``[M, C]`` rows; NaN rows for indices outside ``[-T, T)``.
    """
    rows = table.shape[0]
    idx = idx.to(torch.int64)
    wrapped = torch.where(idx < 0, idx + rows, idx)
    valid = (wrapped >= 0) & (wrapped < rows)
    out = table.index_select(0, torch.where(valid, wrapped, 0))
    return torch.where(valid[:, None], out, float("nan"))


def _check_operands(table: Tensor, idx: Tensor) -> None:
    """Raise on what the kernel does not take (no check reads the device)."""
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"want an f32 table and int32 indices; got {table.dtype}, {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1 or not 1 <= table.shape[1] <= MAX_COLUMNS:
        raise ValueError(
            f"want table [T, C] with 1 <= C <= {MAX_COLUMNS} and idx [M]; "
            f"got {tuple(table.shape)}, {tuple(idx.shape)}"
        )
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands")
    device = table.device
    if device.type != "cuda" or idx.device != device:
        raise ValueError(f"want both operands on one CUDA device; got {device}, {idx.device}")
    if table.shape[1] in (2, 4) and table.data_ptr() % (4 * table.shape[1]):
        raise ValueError("the table's rows must be aligned to their width (2 or 4 floats)")
    build.require_hopper(device)


def launch_route(table: Tensor, idx: Tensor, route: str, lib=None) -> Tensor:
    """The kernel of ``route`` ("block" or "l2"; from ``lib``, default the
    built library) on operands that passed the checks; counts nothing.  For
    measurements of a route or a variant beside the one the wrapper picks."""
    lib = build.library() if lib is None else lib
    m, c = idx.shape[0], table.shape[1]
    out = torch.empty((m, c), dtype=torch.float32, device=table.device)
    if m == 0:
        return out
    with build.launch_context(table.device):
        err = lib.nerf_table_gather(
            table.data_ptr(), table.shape[0], c, idx.data_ptr(), m, out.data_ptr(), int(route == "block"),
            build.current_stream(table.device),
        )
    build.check_launch(build.library(), err, f"table_gather ({route} route)")  # its error strings
    return out


def table_gather_cuda(table: Tensor, idx: Tensor) -> Tensor:
    """Launch the kernel of the table's route on the current stream
    (shapes as the reference)."""
    _check_operands(table, idx)
    out = launch_route(table, idx, gather_route(*table.shape))
    if idx.shape[0]:
        counter.launches += 1
    return out


def table_gather(table: Tensor, idx: Tensor) -> Tensor:
    """``table [T, C]`` rows at ``idx [M]`` -> ``[M, C]`` (see the module
    doc for out-of-range indices)."""
    if table.device.type == "cpu":
        counter.plain_calls += 1
        return table_gather_reference(table, idx)
    return table_gather_cuda(table.contiguous(), idx.contiguous())
