"""Occupancy-grid accelerated renderer (port of the fixed-K path of
``learn_nerf_tpu.occ_render``).

1. stratify C cheap candidate ts per ray over the bbox range,
2. occupancy-test every candidate against the grid,
3. compact K occupied candidates per ray, evenly strided over the occupied
   span (``acceleration.compact_occupied_strided``),
4. evaluate the field model on ``[N, K]`` points and composite, each
   survivor standing for ``c/K`` candidate bins.

On the frame path a ``bfloat16`` :class:`~.models.vanilla.NeRFModel` runs
step 4's per-sample chain (points -> MLP -> scan -> composite) as one
fused kernel (:mod:`.kernels.fused_render`), as
``tools/pallas_recipe/fused_render.fused_render_occupancy`` does.

Not ported yet: the pooled path (``--occ_budget_per_ray``), the two-phase
span and the block-word gathers.  They come with the inference levers of
the NGP serving slice (ROADMAP.md, Queue 1 item 1); asking for them raises.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .acceleration import OccupancyGrid, OccupancyGridState, compact_occupied_strided
from .kernels.fused_render import fused_render
from .models.base import FieldModel
from .models.vanilla import NeRFModel
from .ops.geometry import ray_bbox_range
from .ops.sampling import stratified_ts
from .ops.volume import average_aux, composite, composite_alpha, termination_weights
from .render import pad_rays_to_tiles

Tensor = torch.Tensor

NOT_PORTED = (
    "is not ported yet; the pooled path, the two-phase span and the "
    "block-word gathers come with the inference levers of the NGP serving "
    "slice (ROADMAP.md, Queue 1 item 1)"
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
        weights = termination_weights(densities, dt.expand(densities.shape))
        outputs = composite(weights, rgbs, background, mask)
        alphas = composite_alpha(weights, mask)
        coords = composite(weights, points, torch.zeros_like(background), mask)
        aux_means = average_aux(weights, aux, mask)
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


class OccupancyFrameSession:
    """Frame rendering for the render-family CLIs (the fixed-K path; the
    pooled budgets are not ported)."""

    def __init__(
        self,
        renderer: OccupancyRenderer,
        background: Tensor,
        grid_state: OccupancyGridState,
        tile_size: int = 8192,
        transmittance_eps: float = 0.0,
    ):
        self.renderer = renderer
        self.background = background
        self.grid_state = grid_state
        self._tile_size = tile_size
        self._eps = transmittance_eps

    def render(self, rays: Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """Render one frame's rays; returns the output dict."""
        return render_frame_occupancy(
            self.renderer,
            rays,
            self.background,
            self.grid_state,
            tile_size=min(self._tile_size, rays.shape[0]),
            transmittance_eps=self._eps,
            generator=generator,
        )


def render_frame_occupancy(
    renderer: OccupancyRenderer,
    rays: Tensor,
    background: Tensor,
    grid_state: OccupancyGridState,
    tile_size: int = 8192,
    transmittance_eps: float = 0.0,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Tensor] = None,
) -> Dict[str, Tensor]:
    """Render a whole frame through the occupancy fast path, tile by tile
    in raster order (the fixed-K path; ``renderer.fused`` selects the
    fused render kernel).

    :param rays: ``[M, 2, 3]`` rays in raster order.
    :param uniforms: optional ``[num_tiles, tile_size, candidates]``
        candidate uniforms; tiles draw from ``generator`` in order when
        absent.
    :return: dict with ``outputs [M, 3]``.
    """
    m = rays.shape[0]
    rays_p, num_tiles = pad_rays_to_tiles(rays, tile_size, renderer.bbox_max)
    tiles = []
    for i in range(num_tiles):
        tile = rays_p[i * tile_size : (i + 1) * tile_size]
        u = uniforms[i] if uniforms is not None else None
        if renderer.fused:
            out = renderer.render_rays_fused(
                tile, background, grid_state, transmittance_eps, u=u, generator=generator
            )
        else:
            out, _ = renderer.render_rays(
                tile, background, grid_state, transmittance_eps, u=u, generator=generator
            )
        tiles.append(out["outputs"])
    return dict(outputs=torch.cat(tiles)[:m])
