"""Volume rendering as plain PyTorch: the ray-box range, the occupancy
grid's sample selection and the coarse/fine hierarchy, each with the
composite of Max (1995) as NeRF uses it.

Occupancy path (Instant-NGP's, as the port and the JAX package define
it): C stratified candidates over the ray's bbox range; a candidate is
occupied when its cell's density exceeds the threshold (every cell during
warm-up), optionally pruned where the grid's own transmittance falls below
``eps``; rays keep their occupied candidates when they have at most K,
else K of them at the strided ranks ``floor(k c / K)``, each then standing
for ``c / K`` candidate bins.  A pooled pass that drops nothing computes
exactly this, so the reference has no pool.

Hierarchy (NeRF's): ``coarse`` stratified samples, the coarse model's
termination weights as a piecewise-linear inverse CDF (weights + 1e-8)
sampled at ``fine`` stratified points, the fine model over the sorted
union; bins end at the midpoints between samples.
"""

from typing import Callable, Tuple

import torch

Tensor = torch.Tensor
Field = Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]

MIN_T_RANGE = 1e-3


def ray_bbox_range(origins: Tensor, dirs: Tensor, bbox_min: Tensor, bbox_max: Tensor,
                   min_t_range: float = MIN_T_RANGE, epsilon: float = 1e-8):
    """``(t_min, t_max, hit)`` of the slab test; a miss gets ``[0,
    min_t_range]``."""
    bbox = torch.stack([bbox_min, bbox_max])
    safe = torch.where(dirs.abs() < epsilon, torch.where(dirs < 0, -epsilon, epsilon), dirs)
    ts = (bbox[None, :, :] - origins[:, None, :]) / safe[:, None, :]
    t_enter = ts.amin(dim=1).amax(dim=-1).clamp(min=0.0)
    t_exit = ts.amax(dim=1).amin(dim=-1)
    hit = t_enter < t_exit
    t_min = torch.where(hit, t_enter, 0.0)
    t_max = torch.where(hit, torch.maximum(t_exit, t_enter + min_t_range), min_t_range)
    return t_min, t_max, hit


def stratified(t_min: Tensor, t_max: Tensor, u: Tensor) -> Tensor:
    count = u.shape[1]
    bins = ((t_max - t_min) / count)[:, None]
    return t_min[:, None] + (torch.arange(count, dtype=torch.float32, device=u.device)[None, :] + u) * bins


def composite(densities: Tensor, deltas: Tensor, rgbs: Tensor, background: Tensor, hit: Tensor):
    """``(rgb [N, 3], weights [N, T + 1])``: termination weights with a
    background column; rays that miss the bbox show the background."""
    dd = densities * deltas
    acc = torch.cumsum(dd, dim=1)
    survive = torch.exp(-torch.cat([torch.zeros_like(acc[:, :1]), acc], dim=1))
    weights = survive * torch.cat([1.0 - torch.exp(-dd), torch.ones_like(acc[:, :1])], dim=1)
    rgb = torch.einsum("nt,ntc->nc", weights[:, :-1], rgbs) + weights[:, -1:] * background[None, :]
    return torch.where(hit[:, None], rgb, background[None, :]), weights


def select_occupied(rays: Tensor, u: Tensor, densities: Tensor, grid: dict, samples: int, eps: float = 0.0):
    """The occupancy path's selection: ``(ts [N, K], keep [N, K], dt [N,
    1], hit [N], count [N])``; ``count`` is the number of occupied
    candidates, not clamped."""
    bbox_min = torch.tensor(grid["bbox_min"], dtype=torch.float32, device=rays.device)
    bbox_max = torch.tensor(grid["bbox_max"], dtype=torch.float32, device=rays.device)
    origins, dirs = rays[:, 0], rays[:, 1]
    t_min, t_max, hit = ray_bbox_range(origins, dirs, bbox_min, bbox_max)
    cand = stratified(t_min, t_max, u)
    pts = origins[:, None, :] + dirs[:, None, :] * cand[..., None]
    r = grid["resolution"]
    cell = (((pts - bbox_min) / (bbox_max - bbox_min)).clamp(0.0, 1.0 - 1e-7) * r).to(torch.int64)
    d_cell = densities[cell[..., 0] + r * (cell[..., 1] + r * cell[..., 2])]
    occ = (d_cell > grid["threshold"]) | bool(grid["in_warmup"])
    dt = (t_max - t_min)[:, None] / u.shape[1]
    if eps > 0.0:
        approx = torch.where(occ, d_cell, 0.0) * dt
        occ = occ & (torch.exp(-(torch.cumsum(approx, dim=1) - approx)) > eps)
    occ = occ & hit[:, None]
    cum = torch.cumsum(occ.to(torch.int64), dim=1)
    c = cum[:, -1:]
    ranks = torch.arange(samples, dtype=torch.int64, device=rays.device)[None, :] * torch.clamp(c, min=samples) // samples
    keep = ranks < c
    idx = torch.searchsorted(cum.contiguous(), torch.minimum(ranks + 1, c).contiguous()).clamp(max=cand.shape[1] - 1)
    ts = torch.gather(cand, 1, idx)
    dt = dt * torch.clamp(c.to(torch.float32) / samples, min=1.0)
    return ts, keep, dt, hit, c[:, 0]


def render_occupancy(field: Field, rays: Tensor, u: Tensor, densities: Tensor, grid: dict, samples: int,
                     background: Tensor, eps: float = 0.0) -> Tensor:
    """``[N, 3]`` colours of ``rays [N, 2, 3]`` on the occupancy path."""
    ts, keep, dt, hit, _ = select_occupied(rays, u, densities, grid, samples, eps)
    pts = rays[:, None, 0, :] + rays[:, None, 1, :] * ts[..., None]
    n, k = ts.shape
    density, rgb = field(pts.reshape(-1, 3), rays[:, None, 1, :].expand(n, k, 3).reshape(-1, 3))
    density = density.reshape(n, k) * keep
    return composite(density, dt, rgb.reshape(n, k, 3), background, hit)[0]


def bin_deltas(ts: Tensor, t_min: Tensor, t_max: Tensor):
    mid = (ts[:, 1:] + ts[:, :-1]) * 0.5
    ends = torch.cat([mid, t_max[:, None]], dim=1)
    return ends, ends - torch.cat([t_min[:, None], mid], dim=1)


def inverse_cdf(weights: Tensor, t_min: Tensor, ends: Tensor, u: Tensor, eps: float = 1e-8) -> Tensor:
    cdf = torch.cumsum(weights + eps, dim=1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)
    cdf = cdf / cdf[:, -1:]
    knots = torch.cat([t_min[:, None], ends], dim=1)
    q = stratified(torch.zeros_like(t_min), torch.ones_like(t_min), u)
    k = cdf.shape[1]
    idx = torch.searchsorted(cdf.contiguous(), q.contiguous(), right=True).clamp(1, k - 1)
    x0, x1 = torch.gather(cdf, 1, idx - 1), torch.gather(cdf, 1, idx)
    f0, f1 = torch.gather(knots, 1, idx - 1), torch.gather(knots, 1, idx)
    denom = x1 - x0
    out = f0 + torch.where(denom > 0, (q - x0) / torch.where(denom == 0, 1.0, denom), 0.0) * (f1 - f0)
    out = torch.where(q < cdf[:, :1], knots[:, :1], out)
    return torch.where(q > cdf[:, -1:], knots[:, -1:], out)


def render_pass(field: Field, rays: Tensor, ts: Tensor, t_min: Tensor, t_max: Tensor, hit: Tensor,
                background: Tensor):
    n, t = ts.shape
    pts = rays[:, None, 0, :] + rays[:, None, 1, :] * ts[..., None]
    density, rgb = field(pts.reshape(-1, 3), rays[:, None, 1, :].expand(n, t, 3).reshape(-1, 3))
    return composite(density.reshape(n, t), bin_deltas(ts, t_min, t_max)[1], rgb.reshape(n, t, 3), background, hit)


def render_hierarchy(coarse: Field, fine: Field, rays: Tensor, u_coarse: Tensor, u_fine: Tensor, bbox: dict,
                     background: Tensor) -> Tuple[Tensor, Tensor]:
    """``(coarse rgb [N, 3], fine rgb [N, 3])`` of ``rays [N, 2, 3]``."""
    bbox_min = torch.tensor(bbox["bbox_min"], dtype=torch.float32, device=rays.device)
    bbox_max = torch.tensor(bbox["bbox_max"], dtype=torch.float32, device=rays.device)
    t_min, t_max, hit = ray_bbox_range(rays[:, 0], rays[:, 1], bbox_min, bbox_max)
    ts_c = stratified(t_min, t_max, u_coarse)
    rgb_c, w_c = render_pass(coarse, rays, ts_c, t_min, t_max, hit, background)
    ts_new = inverse_cdf(w_c[:, :-1].detach(), t_min, bin_deltas(ts_c, t_min, t_max)[0], u_fine)
    ts_f = torch.sort(torch.cat([ts_c, ts_new], dim=1), dim=1).values
    rgb_f, _ = render_pass(fine, rays, ts_f, t_min, t_max, hit, background)
    return rgb_c, rgb_f
