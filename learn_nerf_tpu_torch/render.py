"""Hierarchical volumetric renderer (port of ``learn_nerf_tpu.render``).

The output contract of ``learn_nerf_tpu.render``: ``coarse`` / ``fine``
render results (``outputs``, ``rgbs``, ``densities``, ``alphas``,
``coords``, ``weights``) plus ``coarse_aux`` / ``fine_aux`` scalar means.
The models carry their own parameters (``nn.Module``); random draws come
from a ``torch.Generator`` or are passed in as uniforms.  On the card a
frame's tiles are CUDA-graph replays (:mod:`.frame_graph`).
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .acceleration import bbox_tensors
from .frame_graph import FrameGraphs, TileBuffers, TileOutputs, draw_uniforms, field_reads
from .kernels.composite import render_composite
from .models.base import FieldModel
from .ops.geometry import ray_bbox_range
from .ops.sampling import inverse_cdf_ts, merge_sorted, stratified_ts
from .ops.volume import bin_deltas
from .parallel.mesh import Mesh, replicate

Tensor = torch.Tensor


def composite_samples(
    densities: Tensor,
    deltas: Tensor,
    rgbs: Tensor,
    background: Tensor,
    mask: Tensor,
    points: Tensor,
    aux: Dict[str, Tensor],
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Dict[str, Tensor]]:
    """Scan, weights and every blend of one pass, in one
    :func:`~.kernels.composite.render_composite` call: the points and the
    per-sample aux losses ride along as its extras.

    :param deltas: ``[N, 1]`` or ``[N, T]`` bin widths.
    :param points: ``[N, T, 3]`` sample points.
    :param aux: dict of ``[N, T]`` per-sample losses.
    :return: ``(outputs [N,3], weights [N,T+1], alphas [N,1], coords [N,3],
             aux_means)``; each aux mean is ``average_aux``'s masked mean.
    """
    extras = points
    if aux:
        extras = torch.cat([points, torch.stack(list(aux.values()), dim=-1).to(points.dtype)], dim=-1)
    outputs, weights, alphas, blended = render_composite(densities, deltas, rgbs, background, mask, extras)
    aux_means = {name: blended[:, 3 + i].mean() for i, name in enumerate(aux)}
    return outputs, weights, alphas, blended[:, :3], aux_means


def render_ray_samples(
    model: FieldModel,
    background: Tensor,
    rays: Tensor,
    ts: Tensor,
    t_min: Tensor,
    t_max: Tensor,
    mask: Tensor,
) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Evaluate one model over given per-ray samples and composite (on the
    card one composite kernel a pass, with per-sample bin widths).

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
    outputs, weights, alphas, coords, aux_means = composite_samples(
        densities, deltas, rgbs, background, mask, points, aux)
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
        bbox_min, bbox_max = bbox_tensors(self, rays.device)
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


def pad_rays_to_tiles(rays: Tensor, tile_size: int, bbox_max, n_dev: int = 1) -> Tuple[Tensor, int]:
    """Pad ``[M, 2, 3]`` rays up to a whole number of tiles (a multiple of
    ``n_dev``, the mesh's devices, when the tiles are spread over them).

    The one tile/pad layout of every whole-frame renderer.  Pad rays
    provably miss the bbox: they start at ``bbox_max + 1`` and point
    further away along ``(1, 1, 1)``.  ``bbox_max`` is three numbers, or
    an f32 tensor on the rays' device (no host copy).

    :return: ``(rays_padded [num_tiles * tile_size, 2, 3], num_tiles)``.
    """
    m = rays.shape[0]
    num_tiles = -(-m // (n_dev * tile_size)) * n_dev
    padded = num_tiles * tile_size
    if padded > m:
        far_corner = torch.as_tensor(bbox_max, dtype=torch.float32, device=rays.device) + 1.0
        pad_ray = torch.stack([far_corner, torch.ones_like(far_corner)])
        rays = torch.cat([rays, pad_ray.expand(padded - m, 2, 3)], dim=0)
    return rays, num_tiles


def tile_devices(num_tiles: int, mesh: Optional[Mesh]) -> List[int]:
    """The mesh device of each tile: device d renders the contiguous block
    of tiles ``d * T / n .. (d + 1) * T / n`` (the JAX package's
    ``shard_map`` over the data axis); all 0 without a mesh."""
    if mesh is None:
        return [0] * num_tiles
    per_device = num_tiles // len(mesh.devices)
    return [i // per_device for i in range(num_tiles)]


def render_frame(
    renderer: Renderer,
    rays: Tensor,
    background: Tensor,
    tile_size: int = 4096,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[Tuple[Tensor, Tensor]]] = None,
    include_depth_outputs: bool = False,
    mesh: Optional[Mesh] = None,
    replicas: Optional[Sequence[Tuple[Renderer, Tensor]]] = None,
    graphs: Optional[FrameGraphs] = None,
) -> Dict[str, Tensor]:
    """Render all rays of a frame, tile by tile: each tile's rays and its
    coarse, then its fine uniforms go into static buffers (the prologue),
    the fine pass's outputs are copied into the frame's (the epilogue).

    :param rays: ``[M, 2, 3]`` rays in raster order.
    :param uniforms: optional per-tile ``(u_coarse, u_fine)``; tiles draw
        from ``generator`` in order when absent.
    :param include_depth_outputs: also return the fine pass's ``alphas
        [M, 1]`` and ``coords [M, 3]`` (dataset distillation's depth).
    :param mesh: spread the tiles over ``mesh.devices``
        (:func:`tile_devices`), each device with its replica of the models
        and the background; the tiles' draws come from ``generator`` in
        tile order as without a mesh, and the outputs gather once, on the
        first device.
    :param replicas: the ``(renderer, background)`` of each mesh device,
        made once by the caller (:func:`~.parallel.mesh.replicate`); made
        for this frame when absent.
    :param graphs: the session's :class:`~.frame_graph.FrameGraphs` (no
        mesh): each tile's body is one replay; eager when None.
    :return: dict with ``outputs [M, 3]``.
    """
    m = rays.shape[0]
    rays_p, num_tiles = pad_rays_to_tiles(rays, tile_size, bbox_tensors(renderer, rays.device)[1],
                                         len(mesh.devices) if mesh else 1)
    if mesh is None:
        replicas = [(renderer, background)]
    elif replicas is None:
        replicas = replicate((renderer, background), mesh.devices)
    keys = ("outputs", "alphas", "coords") if include_depth_outputs else ("outputs",)
    if graphs is not None and mesh is not None:
        raise ValueError("frames over a mesh run eagerly: pass graphs=None")
    buffers = TileBuffers() if graphs is None else graphs.buffers
    if graphs is not None:
        graphs.follow([*field_reads(renderer.coarse), *field_reads(renderer.fine), background])
        key = (renderer, "hierarchy", tile_size, include_depth_outputs)
    frame = TileOutputs(num_tiles, rays.device)
    for i, d in enumerate(tile_devices(num_tiles, mesh)):
        tile_renderer, tile_background = replicas[d]
        dev = tile_background.device
        tile = buffers.get("rays", (tile_size, 2, 3), torch.float32, dev)
        tile.copy_(rays_p[i * tile_size : (i + 1) * tile_size])
        u_c = buffers.get("u_coarse", (tile_size, renderer.coarse_ts), torch.float32, dev)
        u_f = buffers.get("u_fine", (tile_size, renderer.fine_ts), torch.float32, dev)
        if uniforms is not None:
            u_c.copy_(uniforms[i][0])
            u_f.copy_(uniforms[i][1])
        else:
            draw_uniforms(u_c, generator)
            draw_uniforms(u_f, generator)

        def body(tile_renderer=tile_renderer, tile_background=tile_background, tile=tile, u_c=u_c, u_f=u_f):
            fine = tile_renderer.render_rays(tile, tile_background, u_coarse=u_c, u_fine=u_f)["fine"]
            return {k: fine[k] for k in keys}

        frame.add(i, body() if graphs is None else graphs.run(key, body))
    return {k: v.reshape(-1, v.shape[-1])[:m] for k, v in frame.tensors.items()}


def render_frame_sharded(
    renderer: Renderer,
    rays: Tensor,
    background: Tensor,
    mesh: Mesh,
    tile_size: int = 4096,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Colours-only :func:`render_frame` over a mesh.

    :param rays: ``[M, 2, 3]`` rays in raster order.
    :return: ``[M, 3]`` colours.
    """
    return render_frame(renderer, rays, background, tile_size=tile_size, generator=generator, mesh=mesh)["outputs"]
