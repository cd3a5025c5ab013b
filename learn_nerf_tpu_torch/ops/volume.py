"""Volumetric compositing over the per-ray sample axis (port of
``learn_nerf_tpu.ops.volume``).

* bins are delimited by midpoints between consecutive ts, closed by
  ``t_min``/``t_max``;
* termination weights are ``P(survive to bin) * P(terminate in bin)`` with a
  final always-terminate background column, so ``weights`` has shape
  ``[N, T+1]`` and rows sum to 1;
* rays that miss the bbox (``mask=False``) return the background;
* the JAX module's ``average_aux`` has no counterpart here: the renderers
  blend per-sample aux losses as extras of ``kernels.composite`` and take
  each column's mean (``render.composite_samples``).
"""

from typing import Tuple

import torch

Tensor = torch.Tensor


def bin_deltas(ts: Tensor, t_min: Tensor, t_max: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Midpoint bin boundaries for samples ``ts``.

    :param ts: ``[N, T]`` sorted sample positions.
    :param t_min: ``[N]`` range starts.
    :param t_max: ``[N]`` range ends.
    :return: ``(starts [N,T], ends [N,T], deltas [N,T])``.
    """
    mid = (ts[:, 1:] + ts[:, :-1]) * 0.5
    starts = torch.cat([t_min[:, None], mid], dim=1)
    ends = torch.cat([mid, t_max[:, None]], dim=1)
    return starts, ends, ends - starts


def termination_weights(densities: Tensor, deltas: Tensor) -> Tensor:
    """Per-bin termination probabilities with a trailing background column.

    ``w[:, t<T] = exp(-cum_prev) * (1 - exp(-density*dt))`` and
    ``w[:, T] = exp(-cum_total)``.

    :param densities: ``[N, T]`` non-negative densities.
    :param deltas: ``[N, T]`` bin widths.
    :return: ``[N, T+1]`` weights summing to 1 along axis 1.
    """
    density_dt = densities * deltas
    acc = torch.cumsum(density_dt, dim=1)
    acc_prev = torch.cat([torch.zeros_like(acc[:, :1]), acc], dim=1)
    survive = torch.exp(-acc_prev)  # [N, T+1]
    terminate = torch.cat(
        [1.0 - torch.exp(-density_dt), torch.ones_like(acc[:, :1])], dim=1
    )
    return survive * terminate


def composite(weights: Tensor, values: Tensor, background: Tensor, mask: Tensor) -> Tensor:
    """Blend per-sample values and the background with termination weights.

    :param weights: ``[N, T+1]`` termination weights.
    :param values: ``[N, T, C]`` per-sample values (e.g. RGB or coords).
    :param background: ``[C]`` background value.
    :param mask: ``[N]`` bool; masked-out rays return the background.
    :return: ``[N, C]`` composited values.
    """
    fg = torch.einsum("nt,ntc->nc", weights[:, :-1], values)
    out = fg + weights[:, -1:] * background[None, :]
    return torch.where(mask[:, None], out, background[None, :])


def composite_alpha(weights: Tensor, mask: Tensor) -> Tensor:
    """Hit probability per ray: 1 minus the background weight.

    :return: ``[N, 1]`` alphas (0 for masked rays).
    """
    return torch.where(mask[:, None], 1.0 - weights[:, -1:], 0.0)
