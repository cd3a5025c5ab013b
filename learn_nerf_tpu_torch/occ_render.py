"""Occupancy-grid accelerated renderer (port of ``learn_nerf_tpu.occ_render``:
the fixed-K path and the pooled inference path).

1. stratify C cheap candidate ts per ray over the bbox range,
2. occupancy-test every candidate against the grid,
3. compact K occupied candidates per ray, evenly strided over the occupied
   span (``acceleration.compact_occupied_strided``),
4. evaluate the field model on ``[N, K]`` points and composite, each
   survivor standing for ``c/K`` candidate bins.

The pooled path (:meth:`OccupancyRenderer.render_rays_pooled`, the CLIs'
``--occ_budget_per_ray``) packs a tile's survivors into one pool of
``budget`` samples, so the field model runs on the samples that exist and
not on the ``N * K`` worst case; :class:`OccupancyFrameSession` sizes the
pool from measured demand.

Both paths (:meth:`OccupancyRenderer.render_rays` and
:meth:`OccupancyRenderer.render_rays_pooled`, which training
differentiates) run step 4's scan, weights and blends (colour, coords, aux)
through :mod:`.kernels.composite`: on the card one kernel, with a backward
kernel (the pooled path in the pool's own layout).

On the fixed-K frame path a ``bfloat16`` :class:`~.models.vanilla.NeRFModel`
runs step 4's per-sample chain (points -> MLP -> scan -> composite) as one
fused kernel (:mod:`.kernels.fused_render`), as
``tools/pallas_recipe/fused_render.fused_render_occupancy`` does.

Not ported yet: the two-phase span and the block-word gathers (ROADMAP.md,
Queue 1: the span and the block-word gathers); asking for them raises.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .acceleration import (
    OccupancyGrid,
    OccupancyGridState,
    auto_budget_from_demand,
    compact_occupied_strided,
    next_budget_bucket,
)
from .kernels.composite import render_composite_pooled
from .kernels.fused_render import fused_render
from .models.base import FieldModel
from .models.vanilla import NeRFModel
from .ops.geometry import ray_bbox_range
from .ops.sampling import stratified_ts
from .render import composite_samples, pad_rays_to_tiles

Tensor = torch.Tensor

NOT_PORTED = (
    "is not ported yet; the two-phase span and the block-word gathers are "
    "left of ROADMAP.md, Queue 1: the span and the block-word gathers"
)


@dataclass(frozen=True, eq=False)
class OccupancyRenderer:
    model: FieldModel
    grid: OccupancyGrid
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    candidates: int = 192
    samples: int = 32
    min_t_range: float = 1e-3
    # Inference levers of the JAX renderer, not ported yet: any nonzero
    # value raises.
    span_candidates: int = 0
    block_gather_stride: int = 0
    span_block_gather: int = 0

    def __post_init__(self):
        # The renderer bbox drives ray t-ranges; the grid's drives cell
        # quantization.  They must agree or culling silently misplaces cells.
        if tuple(map(float, self.bbox_min)) != tuple(map(float, self.grid.bbox_min)) or tuple(
            map(float, self.bbox_max)
        ) != tuple(map(float, self.grid.bbox_max)):
            raise ValueError(
                f"OccupancyRenderer bbox {self.bbox_min}..{self.bbox_max} "
                f"must equal its grid's bbox "
                f"{self.grid.bbox_min}..{self.grid.bbox_max}"
            )
        for name in ("span_candidates", "block_gather_stride", "span_block_gather"):
            if getattr(self, name):
                raise NotImplementedError(f"OccupancyRenderer {name} {NOT_PORTED}")

    @property
    def fused(self) -> bool:
        """Whether the frame path runs the fused render kernel."""
        return isinstance(self.model, NeRFModel) and self.model.compute_dtype == "bfloat16"

    def _select_candidates(
        self,
        rays: Tensor,
        grid_state: OccupancyGridState,
        transmittance_eps: float = 0.0,
        u: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """Stratified candidates, occupancy test (incl. warmup), optional
        grid-transmittance prune, bbox mask.

        :param u: optional ``[N, candidates]`` uniforms for the draw.
        :return: ``(cand_ts [N,C], occ [N,C] bool, dt [N,1], mask [N])``.
        """
        bbox_min = torch.tensor(self.bbox_min, dtype=torch.float32, device=rays.device)
        bbox_max = torch.tensor(self.bbox_max, dtype=torch.float32, device=rays.device)
        origins, dirs = rays[:, 0], rays[:, 1]
        t_min, t_max, mask = ray_bbox_range(origins, dirs, bbox_min, bbox_max, self.min_t_range)
        cand_ts = stratified_ts(t_min, t_max, self.candidates, u=u, generator=generator)
        cand_pts = origins[:, None, :] + dirs[:, None, :] * cand_ts[..., None]
        d_grid = grid_state.densities.detach()[self.grid.cell_indices(cand_pts)]
        occ = self.grid.occupied_from_densities(grid_state, d_grid)
        dt = (t_max - t_min)[:, None] / self.candidates  # [N, 1]
        if transmittance_eps > 0.0:
            # Exclusive scan of the grid's own EMA densities: a small eps
            # prunes only candidates behind essentially opaque matter.
            approx = torch.where(occ, d_grid, 0.0) * dt
            acc_prev = torch.cumsum(approx, dim=1) - approx
            occ = occ & (torch.exp(-acc_prev) > transmittance_eps)
        occ = occ & mask[:, None]
        return cand_ts, occ, dt, mask

    def _select_samples(
        self,
        rays: Tensor,
        grid_state: OccupancyGridState,
        transmittance_eps: float,
        u: Optional[Tensor],
        generator: Optional[torch.Generator],
    ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
        """Candidates -> K strided occupied samples per ray.

        :return: ``(points [N,K,3], ts [N,K], sample_mask [N,K], dt [N,1],
                 mask [N])``; every survivor stands for ``dt`` (the
                 candidate bin width times ``c/K`` on strided rays).
        """
        cand_ts, occ, dt0, mask = self._select_candidates(
            rays, grid_state, transmittance_eps, u=u, generator=generator
        )
        sel_ts, sel_mask, delta_scale = compact_occupied_strided(cand_ts, occ, self.samples)
        points = rays[:, None, 0, :] + rays[:, None, 1, :] * sel_ts[..., None]
        return points, sel_ts, sel_mask, dt0 * delta_scale, mask

    def render_rays(
        self,
        rays: Tensor,
        background: Tensor,
        grid_state: OccupancyGridState,
        transmittance_eps: float = 0.0,
        u: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """Render rays with occupancy-culled sampling (fixed ``[N, K]``).

        :param rays: ``[N, 2, 3]`` (origin, direction).
        :param u: optional ``[N, candidates]`` uniforms for the candidate
            draw; drawn from ``generator`` when absent.
        :return: ``(out, aux_means)``; out keys: ``outputs [N,3]``,
                 ``densities [N,K]``, ``alphas [N,1]``, ``coords [N,3]``,
                 ``weights [N,K+1]``, ``ts [N,K]``, ``sample_mask [N,K]``,
                 ``rgbs [N,K,3]``.
        """
        points, sel_ts, sel_mask, dt, mask = self._select_samples(
            rays, grid_state, transmittance_eps, u, generator
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
    ) -> Dict[str, Tensor]:
        """:meth:`render_rays`'s ``outputs`` and ``alphas``, with the
        per-sample chain in the fused render kernel (bf16 vanilla model
        only); selection stays plain tensor code."""
        points, _, sel_mask, dt, mask = self._select_samples(
            rays, grid_state, transmittance_eps, u, generator
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
    ) -> Tensor:
        """Mean per-ray survivor count a pooled pass would see: exactly
        :meth:`render_rays_pooled`'s candidate selection, without the field
        model (sizes the ``"auto"`` pool budgets from a real batch)."""
        _, occ, _, _ = self._select_candidates(
            rays, grid_state, transmittance_eps, generator=generator
        )
        c = occ.to(torch.float32).sum(dim=1)
        return torch.clamp(c, max=float(self.samples)).mean()

    def render_rays_pooled(
        self,
        rays: Tensor,
        background: Tensor,
        grid_state: OccupancyGridState,
        budget: int,
        transmittance_eps: float = 0.0,
        u: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Tensor]:
        """Inference fast path: pooled compaction + approximate early ray
        termination.

        1. prunes candidates whose approximate transmittance (the grid's own
           EMA densities) falls below ``transmittance_eps`` (0 disables);
        2. caps survivors per ray at K (:meth:`render_rays`'s selection),
           then packs the tile's survivors ray-major into one ``[budget]``
           pool, so the field model runs on the survivors only.  Slots at
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
        :return: dict with ``outputs [N,3]``, ``alphas [N,1]``, ``coords
                 [N,3]``, ``aux`` (scalar means), and the 0-dim counters
                 ``selected`` (survivors the selection produced) and
                 ``dropped`` (those that did not fit the pool).
        """
        if budget < 1:
            raise ValueError(f"a pool needs at least one sample, got budget {budget}")
        origins, dirs = rays[:, 0], rays[:, 1]
        n = origins.shape[0]
        cand_ts, occ, dt, mask = self._select_candidates(
            rays, grid_state, transmittance_eps, u=u, generator=generator
        )
        sel_ts, sel_mask, delta_scale = compact_occupied_strided(cand_ts, occ, self.samples)

        # Ray-major slots keep each ray's samples contiguous and t-sorted.
        flat_occ = sel_mask.reshape(-1)  # [N*K]
        slots = torch.cumsum(flat_occ.to(torch.int64), dim=0) - 1
        kept = flat_occ & (slots < budget)
        # Scatter each kept survivor's flat position into its slot; every
        # other entry lands in the spare slot `budget`, which is cut off.
        flat_pos = torch.arange(flat_occ.shape[0], device=rays.device)
        pool_src = torch.full((budget + 1,), flat_occ.shape[0], dtype=torch.int64, device=rays.device)
        pool_src.scatter_(0, torch.where(kept, slots, budget), flat_pos)
        pool_src = pool_src[:budget]
        pool_ray = torch.clamp(pool_src // self.samples, max=n - 1)
        pool_t = torch.cat([sel_ts.reshape(-1), sel_ts.new_zeros(1)])[pool_src]

        dirs_p = dirs[pool_ray]
        points = origins[pool_ray] + dirs_p * pool_t[:, None]
        density, rgbs, aux = self.model(points, dirs_p)

        # Ray r owns rows starts[r] .. starts[r+1] - 1: its kept survivors.
        counts = torch.cumsum(sel_mask.sum(dim=1), dim=0)
        starts = torch.cat([counts.new_zeros(1), torch.clamp(counts, max=budget)]).to(torch.int32)
        extras = points
        if aux:
            extras = torch.cat([points, torch.stack(list(aux.values()), dim=-1).to(points.dtype)], dim=-1)
        outputs, alphas, blended = render_composite_pooled(
            density[..., 0], starts, dt * delta_scale, rgbs, background, mask, extras, self.samples)
        aux_means = {name: blended[:, 3 + i].mean() for i, name in enumerate(aux)}
        selected = flat_occ.sum()
        dropped = torch.clamp(selected - budget, min=0)
        return dict(
            outputs=outputs,
            alphas=alphas,
            coords=blended[:, :3],
            aux=aux_means,
            selected=selected,
            dropped=dropped,
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
    ):
        self.renderer = renderer
        self.background = background
        self.grid_state = grid_state
        self.budget_cfg = budget_cfg
        self._tile_size = tile_size
        self._eps = transmittance_eps
        self._escalated_floor = 0
        self._announced_budget = None
        # The last pooled frame's budget per ray and sample counters.
        self.last_pool: Optional[Dict[str, int]] = None
        self._demand_fn = (
            make_demand_fn(renderer, transmittance_eps) if budget_cfg == "auto" else None
        )

    def render(self, rays: Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """Render one frame's rays; returns the output dict (pooled frames
        add the ``selected``/``dropped`` counters)."""
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
) -> Dict[str, Tensor]:
    """Render a whole frame through the occupancy fast path, tile by tile.

    With ``budget_per_ray`` set, each tile runs
    :meth:`OccupancyRenderer.render_rays_pooled` with a pool of
    ``int(tile_size * budget_per_ray)`` samples, and tiles interleave the
    frame's rays (tile g takes rays g, g+G, g+2G, ...) so each sees the
    frame's mix of empty and dense rays; otherwise tiles are in raster
    order and run the fixed-K path (``renderer.fused`` selects the fused
    render kernel).

    :param rays: ``[M, 2, 3]`` rays in raster order.
    :param uniforms: optional ``[num_tiles, tile_size, candidates]``
        candidate uniforms, in each tile's own ray order; tiles draw from
        ``generator`` in order when absent.
    :return: dict with ``outputs [M, 3]``; the pooled path adds the 0-dim
        ``selected``/``dropped`` counters summed over tiles (a nonzero
        ``dropped`` means the budget was undersized for this frame).
    """
    m = rays.shape[0]
    rays_p, num_tiles = pad_rays_to_tiles(rays, tile_size, renderer.bbox_max)
    pooled = budget_per_ray is not None
    if pooled:
        rays_t = rays_p.reshape(tile_size, num_tiles, 2, 3).transpose(0, 1)
    else:
        rays_t = rays_p.reshape(num_tiles, tile_size, 2, 3)
    tiles, selected, dropped = [], [], []
    for i in range(num_tiles):
        tile = rays_t[i].contiguous()
        u = uniforms[i] if uniforms is not None else None
        if pooled:
            out = renderer.render_rays_pooled(
                tile, background, grid_state, int(tile_size * budget_per_ray),
                transmittance_eps, u=u, generator=generator,
            )
            selected.append(out["selected"])
            dropped.append(out["dropped"])
        elif renderer.fused:
            out = renderer.render_rays_fused(
                tile, background, grid_state, transmittance_eps, u=u, generator=generator
            )
        else:
            out, _ = renderer.render_rays(
                tile, background, grid_state, transmittance_eps, u=u, generator=generator
            )
        tiles.append(out["outputs"])
    outputs = torch.stack(tiles)  # [G, S, 3]
    if pooled:  # undo the interleave: [G, S, 3] -> [S, G, 3], raster order
        outputs = outputs.transpose(0, 1)
    result = dict(outputs=outputs.reshape(-1, 3)[:m])
    if pooled:
        result.update(selected=torch.stack(selected).sum(), dropped=torch.stack(dropped).sum())
    return result
