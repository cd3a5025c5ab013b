"""Sampling along rays (port of ``learn_nerf_tpu.ops.sampling``).

* stratified: ``count`` equal bins in ``[t_min, t_max]``, one uniform sample
  per bin;
* fine: piecewise-linear inverse CDF built from coarse termination weights
  (with a floor ``eps``), evaluated at stratified points in ``[0, 1]``,
  merged with the coarse ts by sorting the concatenation.

Every function that draws takes optional explicit uniforms ``u`` (so the
parity tests can feed JAX's draws); otherwise it draws from ``generator``.
"""

from typing import Optional

import torch

Tensor = torch.Tensor


def uniform(
    shape, device, generator: Optional[torch.Generator] = None
) -> Tensor:
    """``[0, 1)`` float32 draws; ``generator`` must live on ``device``."""
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32)


def stratified_ts(
    t_min: Tensor,
    t_max: Tensor,
    count: int,
    u: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Stratified samples: one uniform draw per equal bin.

    :param t_min: ``[N]`` lower bounds.
    :param t_max: ``[N]`` upper bounds.
    :param count: samples per ray.
    :param u: optional ``[N, count]`` uniforms in ``[0, 1)``.
    :return: ``[N, count]`` sorted sample positions.
    """
    bin_size = ((t_max - t_min) / count)[:, None]  # [N, 1]
    offsets = torch.arange(count, dtype=torch.float32, device=t_min.device)[None, :]
    if u is None:
        u = uniform((t_min.shape[0], count), t_min.device, generator)
    return t_min[:, None] + (offsets + u) * bin_size


def batched_interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """Rowwise linear interpolation: ``out[n, i] = interp(x[n, i], xp[n], fp[n])``.

    ``xp`` must be non-decreasing along its last axis.  Outside the knot
    range the value clamps to the end knots, as ``numpy.interp``.

    :param x: ``[N, M]`` query points.
    :param xp: ``[N, K]`` sorted knot positions.
    :param fp: ``[N, K]`` knot values.
    :return: ``[N, M]`` interpolated values.
    """
    k = xp.shape[-1]
    # Index of the right knot for each query, in [1, K-1].
    idx = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    idx = idx.clamp(1, k - 1)
    x0 = torch.gather(xp, -1, idx - 1)
    x1 = torch.gather(xp, -1, idx)
    f0 = torch.gather(fp, -1, idx - 1)
    f1 = torch.gather(fp, -1, idx)
    denom = x1 - x0
    t = torch.where(
        denom > 0, (x - x0) / torch.where(denom == 0, 1.0, denom), 0.0
    )
    out = f0 + t * (f1 - f0)
    out = torch.where(x < xp[:, :1], fp[:, :1], out)
    out = torch.where(x > xp[:, -1:], fp[:, -1:], out)
    return out


def inverse_cdf_ts(
    weights: Tensor,
    t_min: Tensor,
    bin_ends: Tensor,
    count: int,
    eps: float = 1e-8,
    u: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Importance-sample ``count`` new ts per ray from termination weights.

    Knots at ``x = normalized cumsum of (w + eps)`` prefixed with 0,
    ``y = [t_min, bin_ends]``.

    :param weights: ``[N, T]`` per-bin termination weights (background
                    column already stripped).
    :param t_min: ``[N]`` ray range starts.
    :param bin_ends: ``[N, T]`` per-bin end positions.
    :param count: number of new samples per ray.
    :param u: optional ``[N, count]`` uniforms for the stratified draw in
        ``[0, 1]``.
    :return: ``[N, count]`` sorted sampled positions.
    """
    w = weights + eps
    cdf = torch.cumsum(w, dim=1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)
    cdf = cdf / cdf[:, -1:]
    knots_y = torch.cat([t_min[:, None], bin_ends], dim=1)

    q = stratified_ts(
        torch.zeros_like(t_min), torch.ones_like(t_min), count, u=u, generator=generator
    )
    return batched_interp(q, cdf, knots_y)


def merge_sorted(a: Tensor, b: Tensor) -> Tensor:
    """Merge two rowwise-sorted ``[N, Ta]``, ``[N, Tb]`` arrays by sorting
    their concatenation."""
    return torch.sort(torch.cat([a, b], dim=1), dim=1).values
