"""Multiresolution hash-grid encoding (Instant NGP), port of
``learn_nerf_tpu.ops.hashgrid``.

* per level, trilinear interpolation over the 8 cell corners of a virtual
  ``grid^3`` lattice normalized to the scene bbox;
* levels whose dense lattice fits the table (``grid^3 <= table_size``)
  index directly (x-major: ``x + g*(y + g*z)``); larger levels use the
  spatial hash ``x ^ (19349663*y) ^ (83492791*z) mod T`` in uint32
  arithmetic;
* ``smooth`` mode shifts the lattice by half a cell (``0.5 + (g-2)*frac``)
  and applies smoothstep to the interpolation weights.

Torch's uint32 support is partial, so the plain version computes in int64
and masks with ``& 0xFFFFFFFF``: the same wrap-around.  The
clip, floor and ``min(floor, g-2)`` run in the JAX order, one f32 op at a
time, so indices are bit-equal to the JAX package's.

:func:`hash_grid_encode` runs :mod:`..kernels.hashgrid_encode`: for CUDA
tensors one kernel launch for all levels (corners, gathers and weighted
sums); for CPU tensors the plain route, level by level.  The JAX package's
``fuse_levels`` is left out; the kernel computes corners once for each
pair of levels of a level run (``_level_groups``), whose indices and
weights are the same.  :func:`hash_grid_encode_reference` is the plain
version of the whole encoding, for tests.
"""

from typing import List, Sequence, Tuple

import torch

Tensor = torch.Tensor

HASH_PRIME_Y = 19_349_663
HASH_PRIME_Z = 83_492_791
UINT32_MASK = 0xFFFFFFFF

# The 8 cell corners as binary offsets: corner c has x = bit 2, y = bit 1,
# z = bit 0 (the JAX package's _CORNERS order).
CORNERS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def corner_weights_and_coords(
    x: Tensor, grid_size: int, bbox_min: Tensor, bbox_max: Tensor, smooth: bool
) -> Tuple[Tensor, Tensor]:
    """Trilinear corner lattice coordinates and interpolation weights.

    :param x: ``[..., 3]`` world-space points (f32).
    :param grid_size: lattice resolution ``g``.
    :param bbox_min: ``[3]``, a tensor or three floats.
    :param bbox_max: ``[3]``, likewise.
    :param smooth: half-cell shift + smoothstep weights.
    :return: ``(coords [..., 8, 3] int64, weights [..., 8] f32)``.
    """
    bbox_min = torch.as_tensor(bbox_min, dtype=torch.float32, device=x.device)
    bbox_max = torch.as_tensor(bbox_max, dtype=torch.float32, device=x.device)
    frac = torch.clamp((x - bbox_min) / (bbox_max - bbox_min), 0.0, 1.0)
    if smooth:
        findex = 0.5 + float(grid_size - 2) * frac
    else:
        findex = float(grid_size - 1) * frac
    floored = torch.floor(findex)
    floored = torch.clamp(floored, max=float(grid_size - 2))
    cf = findex - floored
    if smooth:
        cf = cf * cf * (3.0 - 2.0 * cf)

    offs = torch.tensor(CORNERS, dtype=torch.int64, device=x.device)  # [8, 3]
    coords = floored.to(torch.int64)[..., None, :] + offs
    wpa = torch.where(offs > 0, cf[..., None, :], 1.0 - cf[..., None, :])
    weights = wpa[..., 0] * wpa[..., 1] * wpa[..., 2]
    return coords, weights


def level_indices(coords: Tensor, grid_size: int, table_size: int) -> Tensor:
    """Table row index for integer lattice coordinates: dense when the
    lattice fits, hashed otherwise.

    :param coords: ``[..., 3]`` int64 lattice coordinates in ``[0, 2^32)``.
    :return: ``[...]`` int32 row indices.
    """
    # Products of 32-bit values stay below 2^63, and + * ^ commute with
    # taking the low 32 bits, so one mask gives uint32's wrap-around.
    cx, cy, cz = coords[..., 0], coords[..., 1], coords[..., 2]
    if grid_size**3 > table_size:
        idx = ((cx ^ (HASH_PRIME_Y * cy) ^ (HASH_PRIME_Z * cz)) & UINT32_MASK) % table_size
    else:
        idx = (cx + grid_size * (cy + grid_size * cz)) & UINT32_MASK
    return idx.to(torch.int32)


def dense_level_rows(grid_size: int, table_size: int) -> int:
    """Number of table rows a level allocates (dense lattice or hashed)."""
    return grid_size**3 if grid_size**3 <= table_size else table_size


def check_levels(
    tables: Sequence[Tensor], grid_sizes: Sequence[int], table_sizes: Sequence[int]
) -> None:
    """The JAX package's two ``ValueError`` checks: one entry per level in
    every list, and each table sized as its level implies."""
    if not (len(tables) == len(grid_sizes) == len(table_sizes)):
        raise ValueError(
            f"level lists disagree: {len(tables)} tables, "
            f"{len(grid_sizes)} grid_sizes, {len(table_sizes)} table_sizes"
        )
    for level, (table, g, t) in enumerate(zip(tables, grid_sizes, table_sizes)):
        rows = dense_level_rows(g, t)
        if table.shape[0] != rows:
            raise ValueError(
                f"level {level}: table has {table.shape[0]} rows, but "
                f"grid {g} / table_size {t} implies {rows}"
            )


def interpolate(weights: Tensor, feats: Tensor) -> Tensor:
    """``[N, 8]`` weights x ``[N, 8, F]`` corner features -> ``[N, F]``."""
    return (weights[..., None] * feats).sum(dim=-2)


def hash_grid_encode(
    tables: Sequence[Tensor],
    x: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min: Tensor,
    bbox_max: Tensor,
    smooth: bool = False,
) -> Tensor:
    """Encode points with all hash-grid levels, concatenated.

    :param tables: per-level ``[rows_l, F]`` f32 feature tables.
    :param x: ``[..., 3]`` points.
    :param grid_sizes: per-level lattice resolutions.
    :param table_sizes: per-level maximum table rows.
    :param bbox_min: ``[3]``, a tensor or three floats (floats keep the
        kernel route free of a device sync).
    :param bbox_max: ``[3]``, likewise.
    :param smooth: C1 interpolation mode.
    :return: ``[..., L * F]`` features (f32).
    """
    from ..kernels.hashgrid_encode import hashgrid_encode

    check_levels(tables, grid_sizes, table_sizes)
    lead = x.shape[:-1]
    out = hashgrid_encode(tables, x.reshape(-1, 3), grid_sizes, table_sizes, bbox_min, bbox_max, smooth)
    return out.reshape(*lead, out.shape[-1])


def hash_grid_encode_reference(
    tables: Sequence[Tensor],
    x: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min: Tensor,
    bbox_max: Tensor,
    smooth: bool = False,
) -> Tensor:
    """Plain PyTorch version of :func:`hash_grid_encode` on any device: the
    JAX package's per-level chain with ``index_select`` gathers."""
    check_levels(tables, grid_sizes, table_sizes)
    lead = x.shape[:-1]
    flat = x.reshape(-1, 3)
    outs: List[Tensor] = []
    for table, g, t in zip(tables, grid_sizes, table_sizes):
        coords, weights = corner_weights_and_coords(flat, g, bbox_min, bbox_max, smooth)
        idx = level_indices(coords, g, t)  # [N, 8]
        feats = table.index_select(0, idx.reshape(-1)).view(flat.shape[0], 8, table.shape[1])
        outs.append(interpolate(weights, feats))
    out = torch.cat(outs, dim=-1)
    return out.reshape(*lead, out.shape[-1])
