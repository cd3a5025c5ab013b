"""The occupancy renderer's sample selection and its pooled packing: the
CUDA kernels and their plain versions.

The JAX package leaves both to XLA.  The selection is its candidate test
and strided compaction (``learn_nerf_tpu/occ_render.py:279-327``
``_select_candidates``, with ``ops/geometry.py:21-62``,
``ops/sampling.py:31``, ``acceleration.py:114-131`` and ``:389-428``
``compact_occupied_strided``): per ray of ``rays [N, 2, 3]`` and uniforms
``u [N, C]``, the slab test, C stratified candidates, their cells' grid
densities and the warmup-or-threshold rule, the optional transmittance
prune, the bbox mask, and K survivors at the strided ranks ``floor(k *
max(c, K) / K)`` of the ``c`` occupied candidates (:class:`Selection`).
The packing is the pooled pass's (``occ_render.py:586-606``): the
survivors ray-major into one pool of ``budget`` samples, slots past the
budget dropped, the unused tail at the last ray's origin
(:class:`Pool`).

``csrc/selection.cu``: ``select_strided_kernel`` (a warp a ray, its
occupancy test one bit a cell from the grid's packed words,
:meth:`~..acceleration.OccupancyGrid.occupancy_words`, built once per grid
state; with the prune, the density the prune reads anyway) and
``pool_pack_kernel`` (one launch from the selection's counts: it clamps and
scans them itself, a lane group a ray).  Every scalar goes by
value and every shape is static: a launch makes no host copy and no host
sync.  With the prune off both are bit-equal to their plain versions on
the card; the prune's prefix sum adds in another order than
``torch.cumsum``, so its decisions may differ where ``exp(-acc_prev)``
lies within a few ulps of ``eps``.

:func:`select_strided` and :func:`pool_pack` run the plain versions for
CPU tensors and the kernels for CUDA tensors, with no fallback between the
two.  Nothing here has a gradient: rays that require grad are refused while
grad is enabled.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..acceleration import BLOCK_DIMS, OccupancyGrid, OccupancyGridState, bbox_tensors, compact_occupied_strided
from ..ops.geometry import ray_bbox_range
from ..ops.sampling import stratified_ts
from . import build

Tensor = torch.Tensor
Span = Tuple[Tensor, Tensor, Tensor]

# select_strided_kernel's and pool_pack_kernel's launches and plain calls.
counter = build.LaunchCounter()
pack_counter = build.LaunchCounter()

# The kernels take K <= 64 samples a ray (the pooled composite kernels'
# limit), up to 48 KiB of one ray's candidate ballots: C <= 393,216, grids
# of fewer than 2^31 cells and pools of fewer than 2^31 rows.
MAX_SAMPLES = 64
MAX_CANDIDATES = 48 * 1024 * 8
MAX_CELLS = 1 << 31
MAX_BUDGET = (1 << 31) - 1


class Selection(NamedTuple):
    """K strided survivors a ray: ``ts [N, K]`` (valid entries lead each
    row, t-sorted), ``sample_mask [N, K]``, ``dt [N, 1]`` (the candidate bin
    width times ``max(c/K, 1)``), ``mask [N]`` (the ray meets the bbox and,
    with a span, an occupied supercell), ``count [N]`` int32 (``c``, the
    occupied candidates, not clamped) and ``points [N, K, 3]`` or None."""

    ts: Tensor
    sample_mask: Tensor
    dt: Tensor
    mask: Tensor
    count: Tensor
    points: Optional[Tensor]


class Pool(NamedTuple):
    """A tile's survivors packed ray-major: ``t [budget]``, ``ray [budget]``
    int64, ``points`` and ``dirs [budget, 3]``, ``starts [N + 1]`` int32 (ray
    r owns rows ``starts[r] .. starts[r+1] - 1``), and the 0-dim int64
    ``selected`` (survivors) and ``dropped`` (those past the budget)."""

    t: Tensor
    ray: Tensor
    points: Tensor
    dirs: Tensor
    starts: Tensor
    selected: Tensor
    dropped: Tensor


def select_candidates_reference(
    rays: Tensor,
    u: Tensor,
    grid: OccupancyGrid,
    grid_state: OccupancyGridState,
    min_t_range: float,
    transmittance_eps: float = 0.0,
    span: Optional[Span] = None,
    occupancy: Optional[Callable[[Tensor], Tuple[Tensor, Tensor]]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The candidate test as plain ops: the slab test (the ``span``'s range
    and ``hit`` in its place when given), the stratified candidates of
    ``u``, the occupancy test (``occupancy(points) -> (occ, d_grid)`` in
    place of the per-cell gather: the block-word lever), the optional
    transmittance prune and the bbox mask.

    :return: ``(cand_ts [N, C], occ [N, C] bool, dt [N, 1], mask [N])``.
    """
    bbox_min, bbox_max = bbox_tensors(grid, rays.device)
    origins, dirs = rays[:, 0], rays[:, 1]
    t_min, t_max, mask = ray_bbox_range(origins, dirs, bbox_min, bbox_max, min_t_range)
    if span is not None:
        t_min, t_max, hit = span
        mask = mask & hit
    candidates = u.shape[1]
    cand_ts = stratified_ts(t_min, t_max, candidates, u=u)
    cand_pts = origins[:, None, :] + dirs[:, None, :] * cand_ts[..., None]
    if occupancy is None:
        d_grid = grid_state.densities.detach()[grid.cell_indices(cand_pts)]
        occ = grid.occupied_from_densities(grid_state, d_grid)
    else:
        occ, d_grid = occupancy(cand_pts)
    dt = (t_max - t_min)[:, None] / candidates  # [N, 1]
    if transmittance_eps > 0.0:
        # Exclusive scan of the grid's own EMA densities: a small eps
        # prunes only candidates behind essentially opaque matter.
        approx = torch.where(occ, d_grid, 0.0) * dt
        acc_prev = torch.cumsum(approx, dim=1) - approx
        occ = occ & (torch.exp(-acc_prev) > transmittance_eps)
    occ = occ & mask[:, None]
    return cand_ts, occ, dt, mask


def compact_reference(
    rays: Tensor, cand_ts: Tensor, occ: Tensor, dt: Tensor, mask: Tensor, samples: int, with_points: bool
) -> Selection:
    """The strided compaction of a candidate test's output as plain ops."""
    sel_ts, sel_mask, delta_scale = compact_occupied_strided(cand_ts, occ, samples)
    points = rays[:, None, 0, :] + rays[:, None, 1, :] * sel_ts[..., None] if with_points else None
    count = occ.sum(dim=1, dtype=torch.int32)
    return Selection(sel_ts, sel_mask, dt * delta_scale, mask, count, points)


def select_strided_reference(
    rays: Tensor,
    u: Tensor,
    grid: OccupancyGrid,
    grid_state: OccupancyGridState,
    samples: int,
    min_t_range: float,
    transmittance_eps: float = 0.0,
    span: Optional[Span] = None,
    with_points: bool = False,
) -> Selection:
    """Plain PyTorch version of ``select_strided_kernel``."""
    cand_ts, occ, dt, mask = select_candidates_reference(
        rays, u, grid, grid_state, min_t_range, transmittance_eps, span)
    return compact_reference(rays, cand_ts, occ, dt, mask, samples, with_points)


def pack_pool_reference(rays: Tensor, ts: Tensor, sample_mask: Tensor, budget: int) -> Pool:
    """The pooled pass's packing as plain ops, from a selection's ``ts``
    and ``sample_mask``."""
    n, k = ts.shape
    origins, dirs = rays[:, 0], rays[:, 1]
    # Ray-major slots keep each ray's samples contiguous and t-sorted.
    flat_occ = sample_mask.reshape(-1)  # [N*K]
    slots = torch.cumsum(flat_occ.to(torch.int64), dim=0) - 1
    kept = flat_occ & (slots < budget)
    # Scatter each kept survivor's flat position into its slot; every other
    # entry lands in the spare slot `budget`, which is cut off.
    flat_pos = torch.arange(flat_occ.shape[0], device=rays.device)
    pool_src = torch.full((budget + 1,), flat_occ.shape[0], dtype=torch.int64, device=rays.device)
    pool_src.scatter_(0, torch.where(kept, slots, budget), flat_pos)
    pool_src = pool_src[:budget]
    pool_ray = torch.clamp(pool_src // k, max=n - 1)
    pool_t = torch.cat([ts.reshape(-1), ts.new_zeros(1)])[pool_src]
    dirs_p = dirs[pool_ray]
    points = origins[pool_ray] + dirs_p * pool_t[:, None]
    # Ray r owns rows starts[r] .. starts[r+1] - 1: its kept survivors.
    counts = torch.cumsum(sample_mask.sum(dim=1), dim=0)
    starts = torch.cat([counts.new_zeros(1), torch.clamp(counts, max=budget)]).to(torch.int32)
    selected = flat_occ.sum()
    dropped = torch.clamp(selected - budget, min=0)
    return Pool(pool_t, pool_ray, points, dirs_p, starts, selected, dropped)


def pack_pool_from_counts_reference(rays: Tensor, ts: Tensor, count: Tensor, budget: int) -> Pool:
    """Plain PyTorch version of ``pool_pack_kernel``, from the selection's
    ``ts [N, K]`` and ``count [N]``: :func:`pack_pool_reference` on the
    sample mask the counts imply, ``arange(K) < min(count, K)`` (a
    selection's ``sample_mask`` is exactly that, on every route)."""
    k = ts.shape[1]
    sample_mask = torch.arange(k, device=ts.device)[None, :] < torch.clamp(count, max=k)[:, None]
    return pack_pool_reference(rays, ts, sample_mask, budget)


def _check_rays(rays: Tensor) -> None:
    if rays.dim() != 3 or rays.shape[1:] != (2, 3):
        raise ValueError(f"want rays [N, 2, 3]; got {tuple(rays.shape)}")
    if torch.is_grad_enabled() and rays.requires_grad:
        raise NotImplementedError("the selection has no gradient: detach the rays")


def _check_card_rays(rays: Tensor) -> None:
    """The kernels read a ray as six floats at ``rays.stride(0)``."""
    if rays.dtype != torch.float32:
        raise ValueError(f"the kernels take f32 rays; got {rays.dtype}")
    if rays.stride(2) != 1 or rays.stride(1) != 3:
        raise ValueError(f"the kernels take rays whose (origin, direction) rows are contiguous; "
                         f"got strides {rays.stride()}")


def _check_card_device(device: torch.device, *tensors: Optional[Tensor]) -> None:
    if any(t is not None and t.device != device for t in tensors):
        raise ValueError(f"want every operand on {device}")
    if device.type != "cuda":
        raise ValueError(f"want tensors on a CUDA device; got {device}")
    build.require_hopper(device)


def _reciprocal(value: int) -> float:
    """``1 / value`` rounded to f32, as PyTorch's CUDA division by a CPU
    scalar forms it before it multiplies."""
    return float(np.float32(1.0) / np.float32(value))


def _span_reciprocals(grid: OccupancyGrid) -> Tuple[float, float, float]:
    """Per axis ``1 / (hi - lo)``, the difference and the quotient each
    rounded to f32: the kernel's residual steps turn ``x * inv`` into the
    rounded ``x / (hi - lo)``."""
    span = np.float32(grid.bbox_max) - np.float32(grid.bbox_min)
    if not ((span >= np.float32(2.0**-60)) & (span <= np.float32(2.0**60))).all():
        raise ValueError(f"the selection kernel takes bbox sides in [2^-60, 2^60]; got {span.tolist()}")
    return tuple(float(np.float32(1.0) / s) for s in span)


def word_count(resolution: int) -> int:
    """The packed words of a grid of ``resolution^3`` cells
    (:func:`~..acceleration.pack_occupancy_words`)."""
    return int(np.prod([-(-resolution // d) for d in BLOCK_DIMS]))


def launch_select_strided(
    rays: Tensor,
    u: Tensor,
    grid: OccupancyGrid,
    grid_state: OccupancyGridState,
    samples: int,
    min_t_range: float,
    transmittance_eps: float = 0.0,
    span: Optional[Span] = None,
    with_points: bool = False,
    words: Optional[Tensor] = None,
    lib=None,
) -> Selection:
    """Launch ``select_strided_kernel`` on the current stream, with the
    packed words of ``grid_state`` (``words``: those words built already,
    as :meth:`~..occ_render.OccupancyRenderer.selection_tables` builds them
    once a frame; ``lib``: a build of ``csrc/selection.cu`` other than the
    package's)."""
    _check_card_rays(rays)
    densities = grid_state.densities.detach()
    n, c = u.shape
    if grid.resolution**3 >= MAX_CELLS:
        raise ValueError(f"the selection kernel takes grids of fewer than 2^31 cells; got {grid.resolution}^3")
    if not 1 <= samples <= MAX_SAMPLES:
        raise ValueError(f"the selection kernel takes 1 to {MAX_SAMPLES} samples a ray; got {samples}")
    if not 1 <= c <= MAX_CANDIDATES or c * samples >= 1 << 31:
        raise ValueError(f"the selection kernel takes 1 to {MAX_CANDIDATES} candidates, and fewer than 2^31 "
                         f"candidates times samples; got {c} x {samples}")
    if u.dtype != torch.float32 or densities.dtype != torch.float32:
        raise ValueError(f"the selection kernel takes f32 uniforms and densities; got {u.dtype}, {densities.dtype}")
    if not (u.is_contiguous() and densities.is_contiguous()):
        raise ValueError("the selection kernel takes contiguous uniforms and densities")
    if span is not None:
        t_lo, t_hi, hit = span
        if t_lo.dtype != torch.float32 or t_hi.dtype != torch.float32 or hit.dtype != torch.bool:
            raise ValueError(f"want an f32 span and a bool hit; got {t_lo.dtype}, {t_hi.dtype}, {hit.dtype}")
        if not all(v.is_contiguous() and v.shape == (n,) for v in span):
            raise ValueError(f"want a contiguous [{n}] span and hit")
    inv_span = _span_reciprocals(grid)
    if words is None:
        words = grid.occupancy_words(grid_state)
    elif words.dtype != torch.int32 or not words.is_contiguous() or words.numel() != word_count(grid.resolution):
        raise ValueError(f"want the grid's {word_count(grid.resolution)} contiguous int32 words; got "
                         f"{words.dtype} {tuple(words.shape)}")
    _check_card_device(rays.device, u, densities, words, *(span or ()))
    device = rays.device
    ts = torch.empty((n, samples), dtype=torch.float32, device=device)
    sample_mask = torch.empty((n, samples), dtype=torch.bool, device=device)
    dt = torch.empty((n, 1), dtype=torch.float32, device=device)
    mask = torch.empty((n,), dtype=torch.bool, device=device)
    count = torch.empty((n,), dtype=torch.int32, device=device)
    points = torch.empty((n, samples, 3), dtype=torch.float32, device=device) if with_points else None
    selection = Selection(ts, sample_mask, dt, mask, count, points)
    if n == 0:
        return selection
    lib = lib or build.library()
    span_ptrs = [v.data_ptr() for v in span] if span is not None else [None] * 3
    with build.launch_context(device):
        err = lib.nerf_select_strided(
            rays.data_ptr(), rays.stride(0), u.data_ptr(), words.data_ptr(), densities.data_ptr(), *span_ptrs, n, c,
            samples, grid.resolution, *map(float, grid.bbox_min), *map(float, grid.bbox_max), float(grid.threshold),
            int(grid.in_warmup(grid_state)), float(min_t_range), float(transmittance_eps), _reciprocal(c),
            _reciprocal(samples), *inv_span, ts.data_ptr(), sample_mask.data_ptr(), dt.data_ptr(), mask.data_ptr(),
            count.data_ptr(), points.data_ptr() if points is not None else None, build.current_stream(device),
        )
    build.check_launch(lib, err, "select_strided")
    counter.launches += 1
    return selection


def launch_pool_pack(
    rays: Tensor, ts: Tensor, count: Tensor, budget: int, out: Optional[Pool] = None, lib=None
) -> Pool:
    """Launch ``pool_pack_kernel`` on the current stream, from the
    selection's ``ts [N, K]`` and ``count [N]`` (int32, not clamped: the
    kernel clamps and scans them itself; ``out``: buffers to write in place
    of new ones)."""
    _check_card_rays(rays)
    n, k = ts.shape
    if n < 1 or budget < 1:
        raise ValueError(f"a pool needs a ray and a slot; got {n} rays, budget {budget}")
    if budget > MAX_BUDGET:
        raise ValueError(f"the pack kernel takes a budget under 2^31; got {budget}")
    if not 1 <= k <= MAX_SAMPLES:
        raise ValueError(f"the pack kernel takes 1 to {MAX_SAMPLES} samples a ray; got {k}")
    if ts.dtype != torch.float32 or count.dtype != torch.int32 or count.shape != (n,):
        raise ValueError(f"want f32 ts and int32 [{n}] counts; got {ts.dtype}, {count.dtype} {tuple(count.shape)}")
    if not (ts.is_contiguous() and count.is_contiguous()):
        raise ValueError("the pack kernel takes contiguous ts and counts")
    _check_card_device(rays.device, ts, count)
    device = rays.device
    if out is None:
        out = Pool(
            t=torch.empty((budget,), dtype=torch.float32, device=device),
            ray=torch.empty((budget,), dtype=torch.int64, device=device),
            points=torch.empty((budget, 3), dtype=torch.float32, device=device),
            dirs=torch.empty((budget, 3), dtype=torch.float32, device=device),
            starts=torch.empty((n + 1,), dtype=torch.int32, device=device),
            selected=torch.empty((), dtype=torch.int64, device=device),
            dropped=torch.empty((), dtype=torch.int64, device=device),
        )
    lib = lib or build.library()
    with build.launch_context(device):
        err = lib.nerf_pool_pack(
            rays.data_ptr(), rays.stride(0), ts.data_ptr(), count.data_ptr(), n, k, budget, out.t.data_ptr(),
            out.ray.data_ptr(), out.points.data_ptr(), out.dirs.data_ptr(), out.starts.data_ptr(),
            out.selected.data_ptr(), out.dropped.data_ptr(), build.current_stream(device),
        )
    build.check_launch(lib, err, "pool_pack")
    pack_counter.launches += 1
    return out


# The launches behind every call on a device other than the CPU; a CPU test
# swaps in stand-ins to see which route a call takes.
_cuda_launcher = launch_select_strided
_cuda_pack_launcher = launch_pool_pack


def select_strided(
    rays: Tensor,
    u: Tensor,
    grid: OccupancyGrid,
    grid_state: OccupancyGridState,
    samples: int,
    min_t_range: float,
    transmittance_eps: float = 0.0,
    span: Optional[Span] = None,
    with_points: bool = False,
    words: Optional[Tensor] = None,
) -> Selection:
    """K strided survivors a ray of C candidates (``C = u.shape[1]``).

    :param rays: ``[N, 2, 3]`` (origin, direction).
    :param u: ``[N, C]`` uniforms of the stratified draw.
    :param span: optional ``(t_lo [N], t_hi [N], hit [N] bool)`` of the
        two-phase span lever: the range the candidates fill.
    :param with_points: also return the survivors' points.
    :param words: the state's packed cell bits for the kernel, built
        already (else it takes the state's own,
        :meth:`~..acceleration.OccupancyGrid.occupancy_words`); the plain
        version reads the densities.
    """
    _check_rays(rays)
    if u.dim() != 2 or u.shape[0] != rays.shape[0]:
        raise ValueError(f"want uniforms [{rays.shape[0]}, C]; got {tuple(u.shape)}")
    if grid_state.densities.shape != (grid.resolution**3,):
        raise ValueError(f"want grid densities [{grid.resolution}^3]; got {tuple(grid_state.densities.shape)}")
    if rays.device.type == "cpu":
        counter.plain_calls += 1
        return select_strided_reference(rays, u, grid, grid_state, samples, min_t_range, transmittance_eps, span,
                                        with_points)
    return _cuda_launcher(rays, u, grid, grid_state, samples, min_t_range, transmittance_eps, span, with_points,
                          words)


def pool_pack(rays: Tensor, selection: Selection, budget: int) -> Pool:
    """Pack a selection's survivors ray-major into ``budget`` pool rows;
    slots at or past ``budget`` are dropped, never clamped (the trailing
    rays lose samples), and the unused tail holds the last ray at t = 0.
    On the card one launch, from the selection's ``ts`` and ``count``."""
    _check_rays(rays)
    if budget < 1:
        raise ValueError(f"a pool needs at least one sample, got budget {budget}")
    if rays.device.type == "cpu":
        pack_counter.plain_calls += 1
        return pack_pool_from_counts_reference(rays, selection.ts, selection.count, budget)
    return _cuda_pack_launcher(rays, selection.ts, selection.count, budget)
