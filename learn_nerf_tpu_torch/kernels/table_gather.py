"""Row gather from a feature table: the CUDA kernel and its plain version.

Port of ``tools/exp_gather.py`` (``pallas_gather``, the single-level form
of the hash-grid lookup): ``out[m, :] = table[idx[m], :]`` for an f32
``table [T, C]`` (C from 1 to 4) and int32 ``idx [M]`` of any length
(``csrc/table_gather.cu``, ``table_gather_kernel``).

Out-of-range indices follow ``jnp.take``'s default: an index in
``[-T, -1]`` wraps to ``T + idx``; any other index outside ``[0, T)``
gives a row of NaN.  The hash-grid path only makes in-range indices.

:func:`table_gather` runs the plain version for CPU tensors and the kernel
for CUDA tensors, with no fallback between the two.
"""

import torch

from . import build

Tensor = torch.Tensor

counter = build.LaunchCounter()

MAX_COLUMNS = 4


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


def table_gather_cuda(table: Tensor, idx: Tensor) -> Tensor:
    """Launch the kernel on the current stream (shapes as the reference)."""
    _check_operands(table, idx)
    m, c = idx.shape[0], table.shape[1]
    out = torch.empty((m, c), dtype=torch.float32, device=table.device)
    if m == 0:
        return out
    lib = build.library()
    with build.launch_context(table.device):
        err = lib.nerf_table_gather(
            table.data_ptr(), table.shape[0], c, idx.data_ptr(), m, out.data_ptr(),
            build.current_stream(table.device),
        )
    build.check_launch(lib, err, "table_gather")
    counter.launches += 1
    return out


def table_gather(table: Tensor, idx: Tensor) -> Tensor:
    """``table [T, C]`` rows at ``idx [M]`` -> ``[M, C]`` (see the module
    doc for out-of-range indices)."""
    if table.device.type == "cpu":
        counter.plain_calls += 1
        return table_gather_reference(table, idx)
    return table_gather_cuda(table.contiguous(), idx.contiguous())
