"""The frame cells' frames, as plain PyTorch, tile by tile.

A frame's rays are padded to whole tiles with rays that miss the bbox
(from ``bbox_max + 1`` along ``(1, 1, 1)``).  Pooled occupancy frames
interleave the rays over the tiles (tile g holds rays g, g + G, g + 2G,
... of the G tiles), so each sees the frame's mix; hierarchy frames tile
in raster order.  Each tile takes its uniforms from the frame's generator
in tile order (:func:`~.draws.frame_uniforms`).
"""

import torch

from . import draws
from . import fields
from .precision import matmul_at
from .render import render_hierarchy, render_occupancy

Tensor = torch.Tensor


def padded(rays: Tensor, tile: int, bbox_max) -> Tensor:
    m = rays.shape[0]
    total = -(-m // tile) * tile
    far = torch.tensor(bbox_max, dtype=torch.float32, device=rays.device) + 1.0
    pad = torch.stack([far, torch.ones_like(far)]).expand(total - m, 2, 3)
    return torch.cat([rays, pad], dim=0)


def reference_frame(kind: str, cfg: dict, params: dict, rays: Tensor, frame_seed: int, passes: int,
                    background: Tensor, grid: dict = None, precision: str = "float32") -> Tensor:
    """``[M, 3]`` colours of ``rays [M, 2, 3]``, from the tiles' draws of
    the frame's pass ``passes`` (counted from 1)."""
    matmul = matmul_at(precision)
    field = fields.load(cfg["field"]).field
    tile = cfg["tile"]
    m = rays.shape[0]
    rays_p = padded(rays, tile, cfg["bbox_max"])
    tiles = rays_p.shape[0] // tile
    widths = [cfg["candidates"]] if kind == "occupancy" else [cfg["coarse_samples"], cfg["fine_samples"]]
    stream = draws.frame_uniforms(frame_seed, (passes - 1) * tiles, tile, widths, rays.device)
    out = torch.empty((rays_p.shape[0], 3), dtype=torch.float32, device=rays.device)
    with torch.no_grad():
        if kind == "occupancy":
            model = lambda x, d: field(params["fine"], cfg, x, d, matmul)  # noqa: E731
            order = torch.arange(rays_p.shape[0], device=rays.device).reshape(tile, tiles).t()
            for g in range(tiles):
                (u,) = next(stream)
                out[order[g]] = render_occupancy(model, rays_p[order[g]], u, grid["densities"], grid,
                                                 cfg["samples"], background, cfg["transmittance_eps"])
        else:
            coarse = lambda x, d: field(params["coarse"], cfg, x, d, matmul)  # noqa: E731
            fine = lambda x, d: field(params["fine"], cfg, x, d, matmul)  # noqa: E731
            for g in range(tiles):
                u_c, u_f = next(stream)
                sl = slice(g * tile, (g + 1) * tile)
                out[sl] = render_hierarchy(coarse, fine, rays_p[sl], u_c, u_f, cfg, background)[1]
    return out[:m]


def generator_passes(frame_seed: int, state: Tensor, tiles: int, tile: int, widths, device, most: int = 6) -> int:
    """How many passes of ``tiles`` tiles' draws a frame took from its
    generator, seeded ``frame_seed``, that left it in ``state`` (0 when no
    count up to ``most`` does)."""
    generator = torch.Generator(device=device).manual_seed(frame_seed)
    for passes in range(1, most + 1):
        for _ in range(tiles):
            for w in widths:
                torch.rand((tile, w), generator=generator, device=device)
        if torch.equal(generator.get_state(), state):
            return passes
    return 0
