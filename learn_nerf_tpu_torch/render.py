"""Hierarchical volumetric renderer (port of ``learn_nerf_tpu.render``).

The output contract of ``learn_nerf_tpu.render``: ``coarse`` / ``fine``
render results (``outputs``, ``rgbs``, ``densities``, ``alphas``,
``coords``, ``weights``) plus ``coarse_aux`` / ``fine_aux`` scalar means.
The models carry their own parameters (``nn.Module``); random draws come
from a ``torch.Generator`` or are passed in as uniforms.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from .models.base import FieldModel
from .ops.geometry import ray_bbox_range
from .ops.sampling import inverse_cdf_ts, merge_sorted, stratified_ts
from .ops.volume import average_aux, bin_deltas, composite, composite_alpha, termination_weights

Tensor = torch.Tensor


def render_ray_samples(
    model: FieldModel,
    background: Tensor,
    rays: Tensor,
    ts: Tensor,
    t_min: Tensor,
    t_max: Tensor,
    mask: Tensor,
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Evaluate one model over given per-ray samples and composite.

    :param rays: ``[N, 2, 3]`` (origin, direction) rays.
    :param ts: ``[N, T]`` sorted sample positions.
    :return: ``(out, aux_means)``; out has ``outputs [N,3]``, ``rgbs
             [N,T,3]``, ``densities [N,T]``, ``alphas [N,1]``, ``coords
             [N,3]``, ``weights [N,T+1]``.
    """
    origins = rays[:, 0:1, :]
    dirs = rays[:, 1:2, :]
    points = origins + dirs * ts[:, :, None]  # [N, T, 3]
    density, rgbs, aux = model(points, dirs.expand(points.shape))
    densities = density[..., 0]

    _, _, deltas = bin_deltas(ts, t_min, t_max)
    weights = termination_weights(densities, deltas)
    outputs = composite(weights, rgbs, background, mask)
    alphas = composite_alpha(weights, mask)
    coords = composite(weights, points, torch.zeros_like(background), mask)
    aux_means = average_aux(weights, aux, mask)
    return (
        dict(
            outputs=outputs,
            rgbs=rgbs,
            densities=densities,
            alphas=alphas,
            coords=coords,
            weights=weights,
        ),
        aux_means,
    )


@dataclass(frozen=True, eq=False)
class Renderer:
    """Coarse/fine hierarchy with rendering settings."""

    coarse: FieldModel
    fine: FieldModel
    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    coarse_ts: int
    fine_ts: int
    min_t_range: float = 1e-3

    def render_rays(
        self,
        rays: Tensor,
        background: Tensor,
        generator: Optional[torch.Generator] = None,
        u_coarse: Optional[Tensor] = None,
        u_fine: Optional[Tensor] = None,
    ) -> Dict[str, Dict[str, Tensor]]:
        """Render a ray batch through the full hierarchy.

        :param rays: ``[N, 2, 3]`` (origin, direction).
        :param u_coarse: optional ``[N, coarse_ts]`` uniforms for the
            stratified coarse draw; drawn from ``generator`` when absent.
        :param u_fine: optional ``[N, fine_ts]`` uniforms for the
            inverse-CDF draw; drawn after the coarse draw when absent.
        :return: dict with ``coarse``, ``fine``, ``coarse_aux``, ``fine_aux``.
        """
        bbox_min = torch.tensor(self.bbox_min, dtype=torch.float32, device=rays.device)
        bbox_max = torch.tensor(self.bbox_max, dtype=torch.float32, device=rays.device)
        t_min, t_max, mask = ray_bbox_range(
            rays[:, 0], rays[:, 1], bbox_min, bbox_max, self.min_t_range
        )
        ts_c = stratified_ts(t_min, t_max, self.coarse_ts, u=u_coarse, generator=generator)
        coarse_out, coarse_aux = render_ray_samples(
            self.coarse, background, rays, ts_c, t_min, t_max, mask
        )
        # The fine pass importance-samples the coarse opacity profile; no
        # gradient flows into the sampler.
        w_sg = coarse_out["weights"][:, :-1].detach()
        _, ends_c, _ = bin_deltas(ts_c, t_min, t_max)
        ts_new = inverse_cdf_ts(
            w_sg, t_min, ends_c, self.fine_ts, u=u_fine, generator=generator
        )
        ts_f = merge_sorted(ts_c, ts_new)
        fine_out, fine_aux = render_ray_samples(
            self.fine, background, rays, ts_f, t_min, t_max, mask
        )
        return dict(coarse=coarse_out, fine=fine_out, coarse_aux=coarse_aux, fine_aux=fine_aux)


def pad_rays_to_tiles(rays: Tensor, tile_size: int, bbox_max) -> Tuple[Tensor, int]:
    """Pad ``[M, 2, 3]`` rays up to a whole number of tiles.

    The one tile/pad layout of every whole-frame renderer.  Pad rays
    provably miss the bbox: they start at ``bbox_max + 1`` and point
    further away along ``(1, 1, 1)``.

    :return: ``(rays_padded [num_tiles * tile_size, 2, 3], num_tiles)``.
    """
    m = rays.shape[0]
    num_tiles = -(-m // tile_size)
    padded = num_tiles * tile_size
    if padded > m:
        far_corner = torch.tensor(bbox_max, dtype=torch.float32, device=rays.device) + 1.0
        pad_ray = torch.stack([far_corner, torch.ones_like(far_corner)])
        rays = torch.cat([rays, pad_ray.expand(padded - m, 2, 3)], dim=0)
    return rays, num_tiles


def render_frame(
    renderer: Renderer,
    rays: Tensor,
    background: Tensor,
    tile_size: int = 4096,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[Tuple[Tensor, Tensor]]] = None,
) -> Dict[str, Tensor]:
    """Render all rays of a frame, tile by tile.

    :param rays: ``[M, 2, 3]`` rays in raster order.
    :param uniforms: optional per-tile ``(u_coarse, u_fine)``; tiles draw
        from ``generator`` in order when absent.
    :return: dict with ``outputs [M, 3]``.
    """
    m = rays.shape[0]
    rays_p, num_tiles = pad_rays_to_tiles(rays, tile_size, renderer.bbox_max)
    tiles = []
    for i in range(num_tiles):
        u_c, u_f = uniforms[i] if uniforms is not None else (None, None)
        fine = renderer.render_rays(
            rays_p[i * tile_size : (i + 1) * tile_size],
            background,
            generator=generator,
            u_coarse=u_c,
            u_fine=u_f,
        )["fine"]
        tiles.append(fine["outputs"])
    return dict(outputs=torch.cat(tiles)[:m])
