"""Ray/box geometry, batched over rays (port of ``learn_nerf_tpu.ops.geometry``).

Rays that miss the scene bbox get the null range ``[0, min_t_range]`` and
``mask=False``; hits are clamped to ``t_min >= 0`` and
``t_max >= t_min + min_t_range``.
"""

from typing import Tuple

import torch

Tensor = torch.Tensor


def ray_bbox_range(
    origins: Tensor,
    directions: Tensor,
    bbox_min: Tensor,
    bbox_max: Tensor,
    min_t_range: float = 1e-3,
    epsilon: float = 1e-8,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Intersect rays with an axis-aligned box.

    :param origins: ``[N, 3]`` ray origins.
    :param directions: ``[N, 3]`` ray directions (need not be normalized).
    :param bbox_min: ``[3]`` box minimum corner.
    :param bbox_max: ``[3]`` box maximum corner.
    :param min_t_range: minimum span between t_min and t_max.
    :param epsilon: smallest direction magnitude used in the division.
    :return: ``(t_min [N], t_max [N], mask [N] bool)``.
    """
    # Sign-preserving epsilon: adding it could cancel a tiny negative
    # component to exactly 0 and turn a hit into a NaN miss.
    bbox = torch.stack([bbox_min, bbox_max])  # [2, 3]
    safe_dirs = torch.where(
        directions.abs() < epsilon,
        torch.where(directions < 0, -epsilon, epsilon),
        directions,
    )
    ts = (bbox[None, :, :] - origins[:, None, :]) / safe_dirs[:, None, :]
    near = ts.amin(dim=1)  # [N, 3] entering t per axis
    far = ts.amax(dim=1)  # [N, 3] exiting t per axis

    t_enter = near.amax(dim=-1).clamp(min=0.0)
    t_exit = far.amin(dim=-1)
    mask = t_enter < t_exit

    t_exit_clipped = torch.maximum(t_exit, t_enter + min_t_range)
    t_min = torch.where(mask, t_enter, 0.0)
    t_max = torch.where(mask, t_exit_clipped, min_t_range)
    return t_min, t_max, mask
