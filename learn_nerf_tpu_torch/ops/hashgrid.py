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

:func:`hash_grid_encode_dx` is the encoding's vector-Jacobian product in
the points, which the JAX package takes with ``jax.vjp`` for Ref-NeRF's
normals (``learn_nerf_tpu/models/ref_nerf.py:71-74``): for a cotangent
``g [N, L*F]``, ``dx[p] = sum_l sum_c grad(w_c)(x_p) <g[p, l], T_l[row_c]>``.
It runs :mod:`..kernels.hashgrid_dx` (one launch for CUDA tensors, with a
second kernel for its own backward in ``g`` and the tables).  Its plain
version, :func:`hash_grid_encode_dx_reference`, and the plain version of
its backward, :func:`hash_grid_encode_dx_backward_reference`, follow the
JAX package's derivative where it is not smooth: ``jnp.clip``'s gradient
is 1/2 where the clipped value sits exactly on a bound (``torch.clamp``'s
is 1), so a point on a face of the bbox gets half the slope along that
axis, as in JAX; ``floor`` has no gradient.
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
        outs.append(interpolate(weights, _corner_features(table, coords, g, t)[1]))
    out = torch.cat(outs, dim=-1)
    return out.reshape(*lead, out.shape[-1])


def corner_weight_gradients(
    x: Tensor, grid_size: int, bbox_min: Tensor, bbox_max: Tensor, smooth: bool
) -> Tuple[Tensor, Tensor]:
    """The cell corners of :func:`corner_weights_and_coords` and the
    gradient of each corner's weight in the point, as JAX differentiates
    the weights.

    Along axis ``a`` the interpolation coordinate moves at
    ``slope_a = clip'(frac_a) * scale / (hi_a - lo_a)``, with ``scale`` the
    lattice scale (``g - 2`` in smooth mode, ``g - 1`` otherwise) and
    ``clip'`` ``jnp.clip``'s gradient (1 inside, 1/2 on a bound, 0
    outside), times the smoothstep's ``6c(1 - c)`` in smooth mode.  Corner
    c's weight is a product of one factor per axis (``cf`` or ``1 - cf``),
    so ``d w_c / d x_a`` is that product with axis ``a``'s factor replaced
    by ``+-slope_a``.

    :return: ``(coords [..., 8, 3] int64, grads [..., 8, 3])``: ``grads``
        in ``x``'s dtype (f64 for the gradient checks).
    """
    coords, _ = corner_weights_and_coords(x, grid_size, bbox_min, bbox_max, smooth)
    bbox_min = torch.as_tensor(bbox_min, dtype=torch.float32, device=x.device)
    bbox_max = torch.as_tensor(bbox_max, dtype=torch.float32, device=x.device)
    span = bbox_max - bbox_min
    raw = (x - bbox_min) / span
    frac = torch.clamp(raw, 0.0, 1.0)
    clip_slope = ((raw > 0) & (raw < 1)).to(x.dtype) + 0.5 * ((raw == 0) | (raw == 1)).to(x.dtype)
    scale = float(grid_size - 2) if smooth else float(grid_size - 1)
    findex = 0.5 + scale * frac if smooth else scale * frac
    floored = torch.clamp(torch.floor(findex), max=float(grid_size - 2))
    c = findex - floored
    slope = clip_slope * (torch.full_like(span, scale) / span)
    if smooth:
        slope = slope * (6.0 * c * (1.0 - c))
        cf = c * c * (3.0 - 2.0 * c)
    else:
        cf = c
    offs = torch.tensor(CORNERS, dtype=torch.bool, device=x.device)  # [8, 3]
    wpa = torch.where(offs, cf[..., None, :], 1.0 - cf[..., None, :])  # [..., 8, 3]
    dwpa = torch.where(offs, slope[..., None, :], -slope[..., None, :])
    grads = torch.stack(
        [
            dwpa[..., 0] * wpa[..., 1] * wpa[..., 2],
            wpa[..., 0] * dwpa[..., 1] * wpa[..., 2],
            wpa[..., 0] * wpa[..., 1] * dwpa[..., 2],
        ],
        dim=-1,
    )
    return coords, grads


def _corner_features(table: Tensor, coords: Tensor, grid_size: int, table_size: int) -> Tuple[Tensor, Tensor]:
    """Level rows of the 8 corners ``[N, 8]`` and their features ``[N, 8, F]``."""
    idx = level_indices(coords, grid_size, table_size)  # [N, 8]
    feats = table.index_select(0, idx.reshape(-1)).view(idx.shape[0], 8, table.shape[1])
    return idx, feats


def hash_grid_encode_dx(
    tables: Sequence[Tensor],
    x: Tensor,
    g: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min: Tensor,
    bbox_max: Tensor,
    smooth: bool = False,
) -> Tensor:
    """The encoding's vector-Jacobian product in the points: ``x [..., 3]``
    and a cotangent ``g [..., L * F]`` give ``[..., 3]`` (f32).
    Differentiable in ``g`` and the tables; points that require grad
    raise (no path needs the second derivative in the points)."""
    from ..kernels.hashgrid_dx import hashgrid_dx

    check_levels(tables, grid_sizes, table_sizes)
    lead = x.shape[:-1]
    out = hashgrid_dx(
        tables, x.reshape(-1, 3), g.reshape(-1, g.shape[-1]), grid_sizes, table_sizes, bbox_min,
        bbox_max, smooth,
    )
    return out.reshape(*lead, 3)


def hash_grid_encode_dx_reference(
    tables: Sequence[Tensor],
    x: Tensor,
    g: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min: Tensor,
    bbox_max: Tensor,
    smooth: bool = False,
) -> Tensor:
    """Plain PyTorch version of :func:`hash_grid_encode_dx` on any device,
    level by level (``index_select`` gathers): for points ``x [N, 3]`` and
    a cotangent ``g [N, L * F]``, ``[N, 3]``.  Autograd differentiates it in
    ``g`` and the tables."""
    check_levels(tables, grid_sizes, table_sizes)
    features = tables[0].shape[1]
    dx = None
    for level, (table, gs, ts) in enumerate(zip(tables, grid_sizes, table_sizes)):
        coords, grads = corner_weight_gradients(x, gs, bbox_min, bbox_max, smooth)
        _, feats = _corner_features(table, coords, gs, ts)
        g_l = g[:, level * features:(level + 1) * features]
        dots = (feats * g_l[:, None, :]).sum(dim=-1)  # [N, 8]
        term = (grads * dots[..., None]).sum(dim=1)
        dx = term if dx is None else dx + term
    return dx


def hash_grid_encode_dx_backward_reference(
    tables: Sequence[Tensor],
    x: Tensor,
    g: Tensor,
    h: Tensor,
    grid_sizes: Sequence[int],
    table_sizes: Sequence[int],
    bbox_min: Tensor,
    bbox_max: Tensor,
    smooth: bool = False,
) -> Tuple[Tensor, List[Tensor]]:
    """Plain version of the backward of :func:`hash_grid_encode_dx` for a
    cotangent ``h [N, 3]``: with ``a_c = grad(w_c) . h_p``,
    ``grad_g[p, l] = sum_c a_c T_l[row_c]`` (the encoding with weights
    ``a_c``) and ``grad_T_l[row_c] += a_c g[p, l]`` (``index_add_``).

    :return: ``(grad_g [N, L * F], [grad_T_l [rows_l, F]])``.
    """
    check_levels(tables, grid_sizes, table_sizes)
    features = tables[0].shape[1]
    grad_g, grad_tables = [], []
    for level, (table, gs, ts) in enumerate(zip(tables, grid_sizes, table_sizes)):
        coords, grads = corner_weight_gradients(x, gs, bbox_min, bbox_max, smooth)
        idx, feats = _corner_features(table, coords, gs, ts)
        a = (grads * h[:, None, :]).sum(dim=-1)  # [N, 8]
        grad_g.append(interpolate(a, feats))
        g_l = g[:, level * features:(level + 1) * features]
        rows = (a[..., None] * g_l[:, None, :]).reshape(-1, features)
        grad_tables.append(torch.zeros_like(table).index_add_(0, idx.reshape(-1).long(), rows))
    return torch.cat(grad_g, dim=-1), grad_tables
