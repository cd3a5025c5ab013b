"""The work a step or a frame of a cell needs, counted from its inputs with
the reference's selection: the samples the field model evaluates, and for
the hash-grid encode its pool rows and the distinct table rows its points
touch (what :mod:`.roofline` turns into bounds).

A pooled pass evaluates the model on ``rays * budget`` pool rows, the
unused tail at the tile's last ray's origin; the budget of a pooled train
step is the auto rule's (mean survivors a ray on the step's batch, drawn
from ``fold_seed(17, 0, host step)``, times 1.3, up to the next bucket).
A fixed-K (dense) step evaluates it on every one of the ``rays * K``
slots, the padding slots included.
"""

from typing import List, Optional

import torch

from .reference import draws
from .reference.field import corner_rows
from .reference.render import select_occupied

BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
MARGIN = 1.3
DEMAND_SEED = 17


def auto_budget(demand: float, cap: int) -> int:
    for b in BUCKETS:
        if b >= demand * MARGIN:
            return min(b, cap)
    return cap


def distinct_rows(points: torch.Tensor, cfg: dict) -> int:
    """The table rows, over all levels, that ``points [P, 3]`` read."""
    bbox_min = torch.tensor(cfg["bbox_min"], dtype=torch.float32, device=points.device)
    bbox_max = torch.tensor(cfg["bbox_max"], dtype=torch.float32, device=points.device)
    total = 0
    for g, t in zip(cfg["grid_sizes"], cfg["table_sizes"]):
        rows, _ = corner_rows(points, g, t, bbox_min, bbox_max)
        total += int(torch.unique(rows).numel())
    return total


def survivors(rays: torch.Tensor, u: torch.Tensor, cfg: dict, grid: dict, eps: float = 0.0):
    """``(points [S, 3] of the kept samples, kept count a ray [N])``."""
    ts, keep, _, _, _ = select_occupied(rays, u, grid["densities"], grid, cfg["samples"], eps)
    pts = rays[:, None, 0, :] + rays[:, None, 1, :] * ts[..., None]
    return pts[keep], keep.sum(dim=1)


def pool_points(rays: torch.Tensor, pts: torch.Tensor, rows: int) -> torch.Tensor:
    """The pool's points: the survivors, then the tail at the last ray's
    origin."""
    tail = rays[-1, 0].expand(max(rows - pts.shape[0], 0), 3)
    return torch.cat([pts[:rows], tail])


def train_work(kind: str, cfg: dict, batches: List[torch.Tensor], grid: dict, base_seed: int) -> dict:
    """A step's ``samples_per_step`` (field evaluations), and on the
    occupancy path the encode's ``pool_rows`` (its points) and the
    ``distinct_rows`` they read, on the first step's batch."""
    n = batches[0].shape[0]
    if kind != "occupancy":
        return dict(samples_per_step=float(n * (2 * cfg["coarse_samples"] + cfg["fine_samples"])))
    rays = batches[0][:, :2]
    with torch.no_grad():
        (u,) = draws.train_uniforms(base_seed, 0, [cfg["candidates"]], n, rays.device)
        if cfg["pool_budget"] is None:
            ts = select_occupied(rays, u, grid["densities"], grid, cfg["samples"])[0]
            pts = (rays[:, None, 0, :] + rays[:, None, 1, :] * ts[..., None]).reshape(-1, 3)
            return dict(samples_per_step=float(pts.shape[0]), pool_rows=pts.shape[0],
                        distinct_rows=distinct_rows(pts, cfg))
        pts, kept = survivors(rays, u, cfg, grid)
        generator = torch.Generator(device=rays.device).manual_seed(draws.fold_seed(DEMAND_SEED, 0, 0))
        u = torch.empty((n, cfg["candidates"]), dtype=torch.float32, device=rays.device).uniform_(generator=generator)
        demand = float(survivors(rays, u, cfg, grid)[1].float().mean())
        rows = n * auto_budget(demand, cfg["samples"])
        return dict(samples_per_step=float(kept.sum()), pool_rows=rows,
                    distinct_rows=distinct_rows(pool_points(rays, pts, rows), cfg))


def frame_work(kind: str, cfg: dict, rays: torch.Tensor, tile_uniforms, grid: Optional[dict],
               budget: Optional[int]) -> dict:
    """A frame's ``samples`` (field evaluations), ``tiles``, and for a
    pooled occupancy frame its tiles' summed ``pool_rows`` and
    ``distinct_rows``.  ``rays`` are padded to whole tiles;
    ``tile_uniforms`` yields each tile's draws."""
    from .reference.frames import padded

    tile = cfg["tile"]
    rays_p = padded(rays, tile, cfg["bbox_max"])
    tiles = rays_p.shape[0] // tile
    if kind != "occupancy":
        return dict(samples=float(rays_p.shape[0] * (2 * cfg["coarse_samples"] + cfg["fine_samples"])), tiles=tiles)
    order = torch.arange(rays_p.shape[0], device=rays.device).reshape(tile, tiles).t()
    samples = rows_total = distinct = 0
    with torch.no_grad():
        for g in range(tiles):
            (u,) = next(tile_uniforms)
            tile_rays = rays_p[order[g]]
            pts, kept = survivors(tile_rays, u, cfg, grid, cfg["transmittance_eps"])
            samples += int(kept.sum())
            rows = tile * budget
            rows_total += rows
            distinct += distinct_rows(pool_points(tile_rays, pts, rows), cfg)
    return dict(samples=float(samples), tiles=tiles, pool_rows=rows_total, distinct_rows=distinct)
