"""Occupancy-grid accelerated renderer (port of ``learn_nerf_tpu.occ_render``:
the fixed-K path, the pooled inference path and the selection levers).

1. stratify C cheap candidate ts per ray over the bbox range,
2. occupancy-test every candidate against the grid,
3. compact K occupied candidates per ray, evenly strided over the occupied
   span (``acceleration.compact_occupied_strided``); steps 1-3 are one
   kernel on the card (:mod:`.kernels.selection`),
4. evaluate the field model on ``[N, K]`` points and composite, each
   survivor standing for ``c/K`` candidate bins.

The pooled path (:meth:`OccupancyRenderer.render_rays_pooled`, the CLIs'
``--occ_budget_per_ray``) packs a tile's survivors into one pool of
``budget`` samples (on the card one more kernel), so the field model runs
on the samples that exist and not on the ``N * K`` worst case;
:class:`OccupancyFrameSession` sizes the pool from measured demand.

Three inference levers of the selection, all off by default as in the JAX
package: two-phase span selection (``span_candidates``: probe a max-pooled,
dilated supergrid to bound each ray's occupied span, then place the C
candidates inside it), block-word occupancy gathers
(``block_gather_stride``: one packed row of a 4x4x2 block's 32 occupancy
bits answers every candidate that falls in the block) and the same words
for the span probes (``span_block_gather``).  They are plain tensor code:
the span's range goes into the selection kernel, and with block words the
whole candidate test stays plain ops, by decision;
:meth:`OccupancyRenderer.selection_tables` builds their tables once a
frame.

Both paths (:meth:`OccupancyRenderer.render_rays` and
:meth:`OccupancyRenderer.render_rays_pooled`, which training
differentiates) run step 4's scan, weights and blends (colour, coords, aux)
through :mod:`.kernels.composite`: on the card one kernel, with a backward
kernel (the pooled path in the pool's own layout).

On the fixed-K frame path a ``bfloat16`` :class:`~.models.vanilla.NeRFModel`
runs step 4's per-sample chain (points -> MLP -> scan -> composite) as one
fused kernel (:mod:`.kernels.fused_render`), as
``tools/pallas_recipe/fused_render.fused_render_occupancy`` does.

With ``mesh=`` a frame spreads its tiles over several devices, each with
its replica of the field, the background, the grid and its tables
(:func:`occupancy_replicas`; :class:`OccupancyFrameSession` makes them
once), as the JAX package's ``shard_map`` over the data axis does.
"""

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .acceleration import (
    BLOCK_DIMS,
    OccupancyGrid,
    OccupancyGridState,
    auto_budget_from_demand,
    dilate_supercells,
    next_budget_bucket,
    pack_block_table,
    superpool_densities,
)
from .kernels import build
from .kernels.composite import render_composite_pooled
from .kernels.fused_render import fused_render
from .kernels.selection import (Selection, compact_reference, pool_pack, select_candidates_reference,
                                select_strided)
from .models.base import FieldModel
from .models.vanilla import NeRFModel
from .ops.geometry import ray_bbox_range
from .ops.sampling import uniform
from .parallel.mesh import Mesh, replicate
from .render import composite_samples, pad_rays_to_tiles, tile_devices

Tensor = torch.Tensor

# The selections whose candidate test ran as plain ops because the block-word
# lever is on (plain_calls), on any device.
block_word_counter = build.LaunchCounter()


@functools.lru_cache(maxsize=None)
def _bracket_columns(n_cand: int, stride: int, device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    """The probe columns of :func:`_bracketed_block_words` and each
    column's two bracketing probes, built on the host once per shape and
    device."""
    probe_sel = np.arange(0, n_cand, stride)
    n_probe = probe_sel.shape[0]
    j0 = np.minimum(np.arange(n_cand) // stride, n_probe - 1)
    j1 = np.minimum(j0 + 1, n_probe - 1)
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device) for a in (probe_sel, j0, j1))


def _bracketed_block_words(
    widx_c: Tensor, bit_c: Tensor, table: Tensor, stride: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Answer per-column block-word lookups from strided probe gathers.

    Gathers one packed row (:func:`~.acceleration.pack_block_table`) per
    ``stride`` columns and answers every column from whichever bracketing
    probe's word has its block index.  The rows are read as int32, so no
    word passes through float arithmetic.

    :param widx_c: ``[N, C]`` flat block-word index per column.
    :param bit_c: ``[N, C]`` bit index within the word.
    :param table: ``[nblocks, 2]`` packed table.
    :return: ``(bit, dmax, matched)``, each ``[N, C]``: the column's
        occupancy bit (valid where ``matched``), the answering probe's
        block-max density, and whether either bracketing probe shares the
        column's block (callers count unmatched columns occupied).
    """
    probe_sel, j0, j1 = _bracket_columns(widx_c.shape[1], stride, widx_c.device)
    widx_p = widx_c[:, probe_sel]
    rows = table.view(torch.int32)[widx_p]  # [N, P, 2]: the gather
    words_p = rows[..., 0]
    dmax_p = rows[..., 1].view(torch.float32)
    m0 = widx_c == widx_p[:, j0]
    m1 = widx_c == widx_p[:, j1]
    words_c = torch.where(m0, words_p[:, j0], words_p[:, j1])
    dmax = torch.where(m0, dmax_p[:, j0], dmax_p[:, j1])
    bit = ((words_c >> bit_c.to(torch.int32)) & 1).to(torch.bool)
    return bit, dmax, m0 | m1


def min_span_candidates(resolution: int, span_pool_factor: int, bbox_min, bbox_max) -> int:
    """Minimum span probe count for conservative two-phase selection: the
    probe spacing at most half the shortest supercell side over the
    bbox's diagonal chord; ``ceil(2*sqrt(3)*rs)`` for a cubic bbox."""
    rs = resolution // span_pool_factor
    span = np.asarray(bbox_max, np.float64) - np.asarray(bbox_min, np.float64)
    diag = float(np.linalg.norm(span))
    return math.ceil(2.0 * diag * rs / float(span.min()))


@dataclass(frozen=True, eq=False)
class OccupancyRenderer:
    model: FieldModel
    grid: OccupancyGrid
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    candidates: int = 192
    samples: int = 32
    min_t_range: float = 1e-3
    # Two-phase span selection (0 = off): `span_candidates` midpoints of
    # equal bins are tested against the supergrid (the grid max-pooled by
    # `span_pool_factor`, then dilated by one supercell) to bound each
    # ray's occupied span, padded by one bin; the C candidates are placed
    # inside it.  Needs span_candidates >= min_span_candidates(...) (64
    # at 128 / 8 on a cube).
    span_candidates: int = 0
    span_pool_factor: int = 8
    # Block-word occupancy gathers (0 = off): one packed row (a 4x4x2
    # block's 32 occupancy bits and its max density) is gathered at every
    # k-th candidate and answers each candidate whose block matches a
    # bracketing probe; an unmatched candidate counts occupied.  The
    # transmittance prune sees the block's max density.  With the prune
    # off, stride 1 selects exactly what the per-cell gather selects.
    block_gather_stride: int = 0
    # The same words for the span probes (0 = off; needs span_candidates
    # > 0): a mismatched probe counts occupied, which only widens a span.
    # Falls back to per-cell probes when the supergrid does not tile into
    # 4x4x2 blocks.  Stride 1 gives the per-cell span exactly.
    span_block_gather: int = 0

    def __post_init__(self):
        # The renderer bbox drives ray t-ranges and span probes; the grid's
        # drives cell quantization.  They must agree or culling silently
        # misplaces cells.
        if tuple(map(float, self.bbox_min)) != tuple(map(float, self.grid.bbox_min)) or tuple(
            map(float, self.bbox_max)
        ) != tuple(map(float, self.grid.bbox_max)):
            raise ValueError(
                f"OccupancyRenderer bbox {self.bbox_min}..{self.bbox_max} "
                f"must equal its grid's bbox "
                f"{self.grid.bbox_min}..{self.grid.bbox_max}"
            )

    @property
    def fused(self) -> bool:
        """Whether the frame path runs the fused render kernel."""
        return isinstance(self.model, NeRFModel) and self.model.compute_dtype == "bfloat16"

    def selection_tables(self, grid_state: OccupancyGridState) -> Dict[str, Tensor]:
        """The frame-invariant tables of the levers that are on: ``block``
        (the packed grid), ``span_sup`` (the dilated supergrid) and
        ``span_block`` (the supergrid packed); and on the card, where the
        selection kernel runs, ``words`` (its packed cell bits,
        :meth:`~.acceleration.OccupancyGrid.occupancy_words`: once a frame
        even for a state made under ``torch.inference_mode``, whose
        densities keep no version to cache on).  Empty with every lever
        off on the CPU; each consumer builds its table itself when its key
        is absent."""
        tables: Dict[str, Tensor] = {}
        densities = grid_state.densities.detach()
        r = self.grid.resolution
        if self.block_gather_stride > 0:
            tables["block"] = pack_block_table(densities, r, self.grid.threshold)
        elif densities.device.type != "cpu":
            tables["words"] = self.grid.occupancy_words(grid_state)
        if self.span_candidates > 0 and r % self.span_pool_factor == 0:
            rs = r // self.span_pool_factor
            sup = superpool_densities(densities, r, self.span_pool_factor)
            tables["span_sup"] = dilate_supercells(sup, rs)
            if self.span_block_gather > 0 and all(rs % d == 0 for d in BLOCK_DIMS):
                tables["span_block"] = pack_block_table(tables["span_sup"], rs, self.grid.threshold)
        return tables

    def _select_candidates(
        self,
        rays: Tensor,
        grid_state: OccupancyGridState,
        transmittance_eps: float = 0.0,
        u: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
        tables: Optional[Dict[str, Tensor]] = None,
    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """The candidate test as plain ops: stratified candidates (inside
        the occupied span with ``span_candidates``), occupancy test (incl.
        warmup; block words with ``block_gather_stride``), optional
        grid-transmittance prune, bbox mask.

        :param u: optional ``[N, candidates]`` uniforms for the draw.
        :param tables: optional :meth:`selection_tables` (frame callers
            build them once, outside their tile loop).
        :return: ``(cand_ts [N,C], occ [N,C] bool, dt [N,1], mask [N])``.
        """
        if u is None:
            u = uniform((rays.shape[0], self.candidates), rays.device, generator)
        occupancy = None
        if self.block_gather_stride > 0:
            occupancy = functools.partial(self._block_word_occupancy, grid_state=grid_state,
                                          table=(tables or {}).get("block"))
        return select_candidates_reference(rays, u, self.grid, grid_state, self.min_t_range, transmittance_eps,
                                           self._span(rays, grid_state, tables), occupancy)

    def _span(
        self, rays: Tensor, grid_state: OccupancyGridState, tables: Optional[Dict[str, Tensor]]
    ) -> Optional[Tuple[Tensor, Tensor, Tensor]]:
        """:meth:`_occupied_span` of the rays' bbox ranges with
        ``span_candidates``, else None."""
        if self.span_candidates == 0:
            return None
        bbox_min = torch.tensor(self.bbox_min, dtype=torch.float32, device=rays.device)
        bbox_max = torch.tensor(self.bbox_max, dtype=torch.float32, device=rays.device)
        origins, dirs = rays[:, 0], rays[:, 1]
        t_min, t_max, _ = ray_bbox_range(origins, dirs, bbox_min, bbox_max, self.min_t_range)
        return self._occupied_span(origins, dirs, t_min, t_max, grid_state, tables)

    def _select(
        self,
        rays: Tensor,
        grid_state: OccupancyGridState,
        transmittance_eps: float,
        u: Optional[Tensor],
        generator: Optional[torch.Generator],
        tables: Optional[Dict[str, Tensor]] = None,
        with_points: bool = False,
    ) -> Selection:
        """Candidates -> K strided occupied samples a ray: the selection
        kernel on the card (:func:`~.kernels.selection.select_strided`; the
        span's range, from plain ops, as its input).  With
        ``block_gather_stride`` the candidate test stays plain ops, by
        decision (block words do not pay on the card, ``PERF.md`` §7), and
        each such call counts in ``block_word_counter``."""
        if u is None:
            u = uniform((rays.shape[0], self.candidates), rays.device, generator)
        if self.block_gather_stride > 0:
            block_word_counter.plain_calls += 1
            cand_ts, occ, dt, mask = self._select_candidates(rays, grid_state, transmittance_eps, u=u, tables=tables)
            return compact_reference(rays, cand_ts, occ, dt, mask, self.samples, with_points)
        return select_strided(rays, u, self.grid, grid_state, self.samples, self.min_t_range, transmittance_eps,
                              self._span(rays, grid_state, tables), with_points, words=(tables or {}).get("words"))

    def _block_word_occupancy(
        self, cand_pts: Tensor, grid_state: OccupancyGridState, table: Optional[Tensor] = None
    ) -> Tuple[Tensor, Tensor]:
        """Candidate occupancy and prune densities from packed block words:
        ``ceil(C/k)`` row gathers a ray in place of C.

        :param cand_pts: ``[N, C, 3]`` candidate points.
        :return: ``(occ [N, C] bool, d_grid [N, C])``; ``d_grid`` is the
            block's max density, 0 where unoccupied.
        """
        if table is None:
            table = pack_block_table(grid_state.densities.detach(), self.grid.resolution, self.grid.threshold)
        widx_c, bit_c = self.grid.block_indices(cand_pts)  # [N, C] each
        bit, d_c, matched = _bracketed_block_words(widx_c, bit_c, table, self.block_gather_stride)
        # Unmatched counts occupied, with the nearest probe's block max
        # standing in for the prune density.
        occ = self.grid.occupied_from_bits(grid_state, torch.where(matched, bit, True))
        return occ, torch.where(occ, d_c, 0.0)

    def _occupied_span(
        self,
        origins: Tensor,
        dirs: Tensor,
        t_min: Tensor,
        t_max: Tensor,
        grid_state: OccupancyGridState,
        tables: Optional[Dict[str, Tensor]] = None,
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """Phase 1 of two-phase selection: tighten ``[t_min, t_max]`` to the
        occupied span of the max-pooled supergrid.

        Conservative, for corner-grazing chords and anisotropic bboxes
        too: with ``s`` the shortest supercell side, the probe spacing ``w
        <= s/2`` (the probe count check below) puts a probe within ``s/4``
        of every chord's midpoint along each axis; the supergrid's one-cell
        dilation makes that probe test positive; so the first and last
        detected probes lie within ``3w/2`` of every chord's ends, and the
        one-bin pad covers them.  In warmup every probe passes and the span
        is the whole range.

        :return: ``(t_lo [N], t_hi [N], hit [N] bool)``; rays with no
            occupied supercell keep their range, with ``hit`` false.
        """
        factor = self.span_pool_factor
        if self.grid.resolution % factor:
            raise ValueError(
                f"span_pool_factor {factor} must divide the occupancy grid "
                f"resolution {self.grid.resolution}"
            )
        rs = self.grid.resolution // factor
        span = np.asarray(self.bbox_max, np.float64) - np.asarray(self.bbox_min, np.float64)
        needed = min_span_candidates(self.grid.resolution, factor, self.bbox_min, self.bbox_max)
        if self.span_candidates < needed:
            raise ValueError(
                f"occ_span_candidates={self.span_candidates} is too few "
                f"probes for a {rs}^3 supergrid (occupancy grid "
                f"{self.grid.resolution}, span_pool_factor {factor}, "
                f"bbox span {tuple(span.tolist())}): "
                f"need >= {needed} to guarantee no occupied supercell is "
                f"skipped. Raise --occ_span_candidates or raise "
                f"--occ_span_pool_factor."
            )
        n_coarse = self.span_candidates
        tables = tables or {}
        sup = tables.get("span_sup")
        if sup is None:
            sup = superpool_densities(grid_state.densities.detach(), self.grid.resolution, factor)
            sup = dilate_supercells(sup, rs)

        # Midpoints of n_coarse equal bins.
        i = (torch.arange(n_coarse, dtype=torch.float32, device=origins.device) + 0.5) / n_coarse
        ts = t_min[:, None] + (t_max - t_min)[:, None] * i[None, :]  # [N, Cc]
        pts = origins[:, None, :] + dirs[:, None, :] * ts[..., None]

        # The supergrid's flat index is cell_indices' at the pooled
        # resolution: one convention with superpool_densities.
        supergrid = dataclasses.replace(self.grid, resolution=rs)
        if self.span_block_gather > 0 and all(rs % d == 0 for d in BLOCK_DIMS):
            table = tables.get("span_block")
            if table is None:
                table = pack_block_table(sup, rs, self.grid.threshold)
            widx, bitidx = supergrid.block_indices(pts)
            bit, _, matched = _bracketed_block_words(widx, bitidx, table, self.span_block_gather)
            occ = self.grid.occupied_from_bits(grid_state, torch.where(matched, bit, True))
        else:
            occ = self.grid.occupied_from_densities(grid_state, sup[supergrid.cell_indices(pts)])

        # argmax returns the first maximal index: the first occupied bin,
        # and on the flipped row the last.
        hit = occ.any(dim=1)
        occ_i = occ.to(torch.uint8)
        first = occ_i.argmax(dim=1)
        last = n_coarse - 1 - occ_i.flip(1).argmax(dim=1)
        w = (t_max - t_min) / n_coarse
        pad = w  # one bin: exactly enough after the dilation (docstring)
        t_lo = t_min + first.to(torch.float32) * w - pad
        t_hi = t_min + (last.to(torch.float32) + 1.0) * w + pad
        t_lo = torch.maximum(t_lo, t_min)
        t_hi = torch.minimum(t_hi, t_max)
        t_lo = torch.where(hit, t_lo, t_min)
        t_hi = torch.where(hit, t_hi, t_max)
        return t_lo, t_hi, hit

    def _select_samples(
        self,
        rays: Tensor,
        grid_state: OccupancyGridState,
        transmittance_eps: float,
        u: Optional[Tensor],
        generator: Optional[torch.Generator],
        tables: Optional[Dict[str, Tensor]] = None,
    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
        """Candidates -> K strided occupied samples per ray (:meth:`_select`).

        :return: ``(points [N,K,3], ts [N,K], sample_mask [N,K], dt [N,1],
                 mask [N])``; every survivor stands for ``dt`` (the
                 candidate bin width times ``c/K`` on strided rays).
        """
        sel = self._select(rays, grid_state, transmittance_eps, u, generator, tables, with_points=True)
        return sel.points, sel.ts, sel.sample_mask, sel.dt, sel.mask

    def render_rays(
        self,
        rays: Tensor,
        background: Tensor,
        grid_state: OccupancyGridState,
        transmittance_eps: float = 0.0,
        u: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
        tables: Optional[Dict[str, Tensor]] = None,
    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """Render rays with occupancy-culled sampling (fixed ``[N, K]``).

        :param rays: ``[N, 2, 3]`` (origin, direction).
        :param u: optional ``[N, candidates]`` uniforms for the candidate
            draw; drawn from ``generator`` when absent.
        :param tables: optional :meth:`selection_tables`.
        :return: ``(out, aux_means)``; out keys: ``outputs [N,3]``,
                 ``densities [N,K]``, ``alphas [N,1]``, ``coords [N,3]``,
                 ``weights [N,K+1]``, ``ts [N,K]``, ``sample_mask [N,K]``,
                 ``rgbs [N,K,3]``.
        """
        points, sel_ts, sel_mask, dt, mask = self._select_samples(
            rays, grid_state, transmittance_eps, u, generator, tables
        )
        density, rgbs, aux = self.model(points, rays[:, None, 1, :].expand(points.shape))
        densities = density[..., 0] * sel_mask  # padding slots contribute 0
        # Scan, weights and blends (colour, coords, aux): one kernel on the
        # card (and one more in the backward), the plain ops of ops.volume
        # on the CPU.
        outputs, weights, alphas, coords, aux_means = composite_samples(
            densities, dt, rgbs, background, mask, points, aux)
        return (
            dict(
                outputs=outputs,
                densities=densities,
                alphas=alphas,
                coords=coords,
                weights=weights,
                ts=sel_ts,
                sample_mask=sel_mask,
                rgbs=rgbs,
            ),
            aux_means,
        )

    def render_rays_fused(
        self,
        rays: Tensor,
        background: Tensor,
        grid_state: OccupancyGridState,
        transmittance_eps: float = 0.0,
        u: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
        tables: Optional[Dict[str, Tensor]] = None,
    ) -> Dict[str, Tensor]:
        """:meth:`render_rays`'s ``outputs`` and ``alphas``, with the
        per-sample chain in the fused render kernel (bf16 vanilla model
        only), after the selection kernel.  The kernel blends no
        ``coords``: frames that need them take :meth:`render_rays`."""
        points, _, sel_mask, dt, mask = self._select_samples(
            rays, grid_state, transmittance_eps, u, generator, tables
        )
        deltas = torch.where(sel_mask, dt, 0.0)  # padding slots contribute 0
        out = fused_render(self.model.packed(), points, rays[:, 1], deltas)
        fg, bg_weight = out[:, :3], out[:, 3:]
        outputs = fg + bg_weight * background[None, :]
        outputs = torch.where(mask[:, None], outputs, background[None, :])
        alphas = torch.where(mask[:, None], 1.0 - bg_weight, 0.0)
        return dict(outputs=outputs, alphas=alphas)

    def mean_sample_demand(
        self,
        rays: Tensor,
        grid_state: OccupancyGridState,
        transmittance_eps: float = 0.0,
        generator: Optional[torch.Generator] = None,
        tables: Optional[Dict[str, Tensor]] = None,
        u: Optional[Tensor] = None,
    ) -> Tensor:
        """Mean per-ray survivor count a pooled pass would see: exactly
        :meth:`render_rays_pooled`'s candidate selection, without the field
        model (sizes the ``"auto"`` pool budgets from a real batch).

        :param u: optional ``[N, candidates]`` uniforms for the draw."""
        sel = self._select(rays, grid_state, transmittance_eps, u, generator, tables)
        return torch.clamp(sel.count, max=self.samples).to(torch.float32).mean()

    def render_rays_pooled(
        self,
        rays: Tensor,
        background: Tensor,
        grid_state: OccupancyGridState,
        budget: int,
        transmittance_eps: float = 0.0,
        u: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
        tables: Optional[Dict[str, Tensor]] = None,
    ) -> Dict[str, Tensor]:
        """Inference fast path: pooled compaction + approximate early ray
        termination.

        1. prunes candidates whose approximate transmittance (the grid's own
           EMA densities) falls below ``transmittance_eps`` (0 disables);
        2. caps survivors per ray at K (:meth:`render_rays`'s selection),
           then packs the tile's survivors ray-major into one ``[budget]``
           pool (:func:`~.kernels.selection.pool_pack`: one kernel on the
           card), so the field model runs on the survivors only.  Slots at
           or past ``budget`` are dropped, never clamped: on overflow the
           trailing rays of the tile lose samples;
        3. composites per ray in the pool's own layout
           (:func:`~.kernels.composite.render_composite_pooled`: one
           kernel on the card, with a backward kernel for pooled
           training): ray r owns pool rows ``starts[r] .. starts[r+1] -
           1``, from its survivor count clamped at ``budget``, and its
           exclusive scan stays at within-ray magnitude.  The points and
           the aux losses ride along as extras.

        :param rays: ``[N, 2, 3]`` (origin, direction).
        :param budget: total pooled samples for the tile.
        :param u: optional ``[N, candidates]`` uniforms for the draw.
        :param tables: optional :meth:`selection_tables`.
        :return: dict with ``outputs [N,3]``, ``alphas [N,1]``, ``coords
                 [N,3]``, ``aux`` (scalar means), and the 0-dim counters
                 ``selected`` (survivors the selection produced) and
                 ``dropped`` (those that did not fit the pool).
        """
        sel = self._select(rays, grid_state, transmittance_eps, u, generator, tables)
        pool = pool_pack(rays, sel, budget)
        density, rgbs, aux = self.model(pool.points, pool.dirs)

        extras = pool.points
        if aux:
            extras = torch.cat([pool.points, torch.stack(list(aux.values()), dim=-1).to(pool.points.dtype)], dim=-1)
        outputs, alphas, blended = render_composite_pooled(
            density[..., 0], pool.starts, sel.dt, rgbs, background, sel.mask, extras, self.samples)
        aux_means = {name: blended[:, 3 + i].mean() for i, name in enumerate(aux)}
        return dict(
            outputs=outputs,
            alphas=alphas,
            coords=blended[:, :3],
            aux=aux_means,
            selected=pool.selected,
            dropped=pool.dropped,
        )


def make_demand_fn(
    renderer: OccupancyRenderer, transmittance_eps: float = 0.0
) -> Callable[[torch.Generator, Tensor, OccupancyGridState], Tensor]:
    """Mean-per-ray-demand function ``(generator, rays, grid_state)``,
    reusable across frames (the JAX package jits it once per session)."""
    return lambda generator, rays, grid_state: renderer.mean_sample_demand(
        rays, grid_state, transmittance_eps, generator=generator
    )


def resolve_auto_budget(
    renderer: OccupancyRenderer,
    grid_state: OccupancyGridState,
    rays: Tensor,
    transmittance_eps: float = 0.0,
    sample_rays: int = 8192,
    demand_fn=None,
    quiet: bool = False,
) -> int:
    """Per-ray pool budget from measured demand, for the render CLIs.

    Lossless sizing: mean measured demand * 1.3 margin, bucket-quantized,
    capped at K.  Demand is measured on an evenly strided subset of the
    frame's rays, drawn with a generator of fixed seed 0 (the JAX package
    uses ``PRNGKey(0)``).  Ceil-stride: floor division would make the
    subset a raster-order prefix of the frame whenever the ray count is not
    an exact multiple.
    """
    stride = max(1, -(-rays.shape[0] // sample_rays))
    subset = rays[::stride][:sample_rays]
    if demand_fn is None:
        demand_fn = make_demand_fn(renderer, transmittance_eps)
    generator = torch.Generator(device=rays.device).manual_seed(0)
    demand = float(demand_fn(generator, subset, grid_state))
    budget = auto_budget_from_demand(demand, renderer.samples)
    if not quiet:
        print(f"auto render budget: {budget} samples/ray (measured demand {demand:.1f})")
    return budget


class OccupancyFrameSession:
    """Frame rendering + the pool-budget policy, shared by the render CLIs.

    Budget policy (no silent caps):

    * ``budget_cfg="auto"``: demand is re-measured for every frame (the
      pass reads only the occupancy grid, no field model), so a camera pose
      with more per-ray demand than the first frame cannot silently
      overflow.  If a frame still drops samples (demand is a mean; the
      margin can lose), the budget escalates to the next bucket and the
      frame renders again until nothing drops or the budget is K.  The
      highest escalated budget is a floor for later frames.
    * numeric ``budget_cfg``: the user asked for that budget; drops are
      reported with their rate (a warning), and the budget is kept.
    * ``budget_cfg=None``: the fixed-K path, no pooling.
    """

    def __init__(
        self,
        renderer: OccupancyRenderer,
        background: Tensor,
        grid_state: OccupancyGridState,
        tile_size: int = 8192,
        transmittance_eps: float = 0.0,
        budget_cfg: Union[None, str, float] = None,
        include_depth_outputs: bool = False,
        mesh: Optional[Mesh] = None,
    ):
        self.renderer = renderer
        self.background = background
        self.grid_state = grid_state
        self.budget_cfg = budget_cfg
        # Frames over a mesh: each device's replica of the field, the
        # background, the grid and its tables, made once per session.
        self._mesh = mesh
        self._replicas = occupancy_replicas(renderer, background, grid_state, mesh) if mesh is not None else None
        self._tile_size = tile_size
        self._eps = transmittance_eps
        self._depth = include_depth_outputs
        self._escalated_floor = 0
        self._announced_budget = None
        # The last pooled frame's budget per ray and sample counters.
        self.last_pool: Optional[Dict[str, int]] = None
        self._demand_fn = (
            make_demand_fn(renderer, transmittance_eps) if budget_cfg == "auto" else None
        )

    def render(self, rays: Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """Render one frame's rays; returns the output dict
        (:func:`render_frame_occupancy`'s: pooled frames add the
        ``selected``/``dropped`` counters, ``include_depth_outputs`` the
        ``alphas`` and ``coords``)."""
        budget = self.budget_cfg
        if budget == "auto":
            budget = resolve_auto_budget(
                self.renderer, self.grid_state, rays, transmittance_eps=self._eps,
                demand_fn=self._demand_fn, quiet=True,
            )
            budget = max(budget, self._escalated_floor)
            if budget != self._announced_budget:
                print(f"auto render budget: {budget} samples/ray", flush=True)
                self._announced_budget = budget
        while True:
            out = render_frame_occupancy(
                self.renderer,
                rays,
                self.background,
                self.grid_state,
                tile_size=min(self._tile_size, rays.shape[0]),
                budget_per_ray=budget,
                transmittance_eps=self._eps,
                generator=generator,
                include_depth_outputs=self._depth,
                mesh=self._mesh,
                replicas=self._replicas,
            )
            if budget is None:
                return out
            dropped, selected = int(out["dropped"]), int(out["selected"])
            self.last_pool = dict(budget=budget, selected=selected, dropped=dropped)
            if dropped == 0:
                return out
            rate = dropped / max(selected, 1)
            if self.budget_cfg == "auto" and budget < self.renderer.samples:
                new = next_budget_bucket(budget, self.renderer.samples)
                print(
                    f"pool overflow: dropped {dropped}/{selected} samples "
                    f"({rate:.2%}); escalating budget {budget} -> {new}"
                )
                budget = new
                self._escalated_floor = max(self._escalated_floor, new)
                continue
            print(
                f"WARNING: pool budget {budget} dropped {dropped}/{selected} "
                f"samples ({rate:.2%}): trailing interleaved rays lost "
                "samples; raise --occ_budget_per_ray or pass 'auto'"
            )
            return out


def occupancy_replicas(
    renderer: OccupancyRenderer, background: Tensor, grid_state: OccupancyGridState, mesh: Mesh
) -> List[Tuple[OccupancyRenderer, Tensor, OccupancyGridState, Dict[str, Tensor]]]:
    """Each mesh device's ``(renderer, background, grid_state, tables)``:
    a replica of the field (live or baked), the background, the grid and
    its selection tables (:meth:`OccupancyRenderer.selection_tables`)."""
    return [(r, bg, gs, r.selection_tables(gs))
            for r, bg, gs in replicate((renderer, background, grid_state), mesh.devices)]


def render_frame_occupancy(
    renderer: OccupancyRenderer,
    rays: Tensor,
    background: Tensor,
    grid_state: OccupancyGridState,
    tile_size: int = 8192,
    transmittance_eps: float = 0.0,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Tensor] = None,
    budget_per_ray: Optional[float] = None,
    include_depth_outputs: bool = False,
    mesh: Optional[Mesh] = None,
    replicas=None,
) -> Dict[str, Tensor]:
    """Render a whole frame through the occupancy fast path, tile by tile.

    The lever tables (:meth:`OccupancyRenderer.selection_tables`) are built
    once, before the tile loop.  With ``budget_per_ray`` set, each tile runs
    :meth:`OccupancyRenderer.render_rays_pooled` with a pool of
    ``int(tile_size * budget_per_ray)`` samples, and tiles interleave the
    frame's rays (tile g takes rays g, g+G, g+2G, ...) so each sees the
    frame's mix of empty and dense rays; otherwise tiles are in raster
    order and run the fixed-K path (``renderer.fused`` selects the fused
    render kernel, except with ``include_depth_outputs``: the kernel blends
    no ``coords``, so those frames take :meth:`OccupancyRenderer.render_rays`,
    the MLP kernel's route).

    :param rays: ``[M, 2, 3]`` rays in raster order.
    :param uniforms: optional ``[num_tiles, tile_size, candidates]``
        candidate uniforms, in each tile's own ray order; tiles draw from
        ``generator`` in order when absent.
    :param include_depth_outputs: also return ``alphas [M, 1]`` and
        ``coords [M, 3]`` (dataset distillation's depth).
    :param mesh: spread the tiles over ``mesh.devices`` as
        :func:`~.render.render_frame` does, each device with its replica of
        the field, the background, the grid and its tables; the outputs
        and counters gather once, on the first device.
    :param replicas: :func:`occupancy_replicas` of the mesh, made once by
        the caller; made for this frame when absent.
    :return: dict with ``outputs [M, 3]``; the pooled path adds the 0-dim
        ``selected``/``dropped`` counters summed over tiles (a nonzero
        ``dropped`` means the budget was undersized for this frame).
    """
    m = rays.shape[0]
    rays_p, num_tiles = pad_rays_to_tiles(rays, tile_size, renderer.bbox_max, len(mesh.devices) if mesh else 1)
    pooled = budget_per_ray is not None
    if pooled:
        rays_t = rays_p.reshape(tile_size, num_tiles, 2, 3).transpose(0, 1)
    else:
        rays_t = rays_p.reshape(num_tiles, tile_size, 2, 3)
    keys = ("outputs", "alphas", "coords") if include_depth_outputs else ("outputs",)
    if mesh is None:
        replicas = [(renderer, background, grid_state, renderer.selection_tables(grid_state))]
    elif replicas is None:
        replicas = occupancy_replicas(renderer, background, grid_state, mesh)
    tiles = {k: [] for k in keys}
    selected, dropped = [], []
    for i, d in enumerate(tile_devices(num_tiles, mesh)):
        tile_renderer, tile_background, tile_grid, tables = replicas[d]
        tile = rays_t[i].contiguous()
        u = uniforms[i] if uniforms is not None else None
        if mesh is not None:
            if generator is not None and u is None:
                u = uniform((tile_size, renderer.candidates), generator.device, generator)
            tile, u = (None if v is None else v.to(mesh.devices[d]) for v in (tile, u))
        common = dict(u=u, generator=generator if mesh is None else None, tables=tables)
        if pooled:
            out = tile_renderer.render_rays_pooled(
                tile, tile_background, tile_grid, int(tile_size * budget_per_ray), transmittance_eps, **common
            )
            selected.append(out["selected"])
            dropped.append(out["dropped"])
        elif tile_renderer.fused and not include_depth_outputs:
            out = tile_renderer.render_rays_fused(tile, tile_background, tile_grid, transmittance_eps, **common)
        else:
            out, _ = tile_renderer.render_rays(tile, tile_background, tile_grid, transmittance_eps, **common)
        for k in keys:
            tiles[k].append(out[k])
    result = {}
    for k, parts in tiles.items():
        v = torch.stack([p.to(rays.device) for p in parts])  # [G, S, C]
        if pooled:  # undo the interleave: [G, S, C] -> [S, G, C], raster order
            v = v.transpose(0, 1)
        result[k] = v.reshape(-1, v.shape[-1])[:m]
    if pooled:
        result.update(selected=torch.stack([s.to(rays.device) for s in selected]).sum(),
                      dropped=torch.stack([s.to(rays.device) for s in dropped]).sum())
    return result
