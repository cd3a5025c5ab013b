"""Occupancy-grid accelerated sampling (port of the rendering half of
``learn_nerf_tpu.acceleration``).

A binary occupancy grid over the scene bbox (an EMA of model densities per
cell, trained with the model and checkpointed beside it) culls cheap
stratified candidates; :func:`compact_occupied_strided` then keeps K
occupied candidates per ray, evenly strided over the occupied span, so the
field model runs on ``[N, K]`` points.  Static shapes throughout.
"""

from dataclasses import dataclass
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor


@dataclass
class OccupancyGridState:
    """EMA density estimates per cell, flat ``[resolution^3]``, and the
    number of grid updates so far."""

    densities: Tensor
    step: int


@dataclass(frozen=True)
class OccupancyGrid:
    """Static configuration for the occupancy grid."""

    bbox_min: Tuple[float, float, float]
    bbox_max: Tuple[float, float, float]
    resolution: int = 128
    decay: float = 0.95
    # Density above which a cell counts as occupied.
    threshold: float = 0.01
    # For the first ``warmup_updates`` grid updates every cell tests
    # occupied (young models must not cull surfaces they have not learned).
    warmup_updates: int = 16

    def init(self, device: Union[str, torch.device] = "cpu") -> OccupancyGridState:
        """All cells occupied, at twice the threshold, at step 0."""
        n = self.resolution**3
        return OccupancyGridState(
            densities=torch.full((n,), 2.0 * self.threshold, dtype=torch.float32, device=device),
            step=0,
        )

    def _cell_coords(self, x: Tensor) -> Tensor:
        """Integer (x, y, z) cell coordinates: the one quantization rule."""
        bbox_min = torch.tensor(self.bbox_min, dtype=torch.float32, device=x.device)
        bbox_max = torch.tensor(self.bbox_max, dtype=torch.float32, device=x.device)
        frac = ((x - bbox_min) / (bbox_max - bbox_min)).clamp(0.0, 1.0 - 1e-7)
        return (frac * self.resolution).to(torch.int64)

    def cell_indices(self, x: Tensor) -> Tensor:
        """Flat cell index per point (x fastest), ``[...]`` int64."""
        cell = self._cell_coords(x)
        r = self.resolution
        return cell[..., 0] + r * (cell[..., 1] + r * cell[..., 2])

    def occupied_from_densities(self, state: OccupancyGridState, d: Tensor) -> Tensor:
        """Occupancy test on already-gathered cell densities: all true while
        ``state.step < warmup_updates``, a threshold test afterwards.  The
        single definition of the rule."""
        warm = torch.tensor(state.step < self.warmup_updates, device=d.device)
        return (d > self.threshold) | warm

    def occupied(self, state: OccupancyGridState, x: Tensor) -> Tensor:
        """Boolean occupancy per point."""
        d = state.densities.detach()[self.cell_indices(x)]
        return self.occupied_from_densities(state, d)

    def state_from_checkpoint(
        self, params: Dict[str, Any], device: Union[str, torch.device] = "cpu"
    ) -> OccupancyGridState:
        """Grid state for rendering from a checkpoint.

        A checkpointed grid (``occupancy_densities`` present) is trained:
        it is marked past warmup so culling applies.  Otherwise :meth:`init`
        (everything occupied) at step 0.
        """
        if "occupancy_densities" not in params:
            return self.init(device)
        n = int(np.size(params["occupancy_densities"]))
        ckpt_res = int(round(n ** (1.0 / 3.0)))
        ckpt_res = int(params.get("occupancy_resolution", ckpt_res))
        if ckpt_res**3 != n:
            raise ValueError(
                f"corrupt occupancy grid: {n} densities is not a cube "
                f"of the recorded resolution {ckpt_res}"
            )
        if ckpt_res != self.resolution:
            raise ValueError(
                f"checkpoint occupancy grid is {ckpt_res}^3 but this "
                f"grid is configured {self.resolution}^3; pass "
                f"--occ_grid {ckpt_res} to resume this checkpoint"
            )
        densities = torch.as_tensor(
            np.asarray(params["occupancy_densities"], dtype=np.float32).reshape(-1)
        )
        return OccupancyGridState(densities=densities.to(device), step=self.warmup_updates)


def compact_occupied_strided(
    ts: Tensor, occupied: Tensor, count: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Select ``count`` occupied candidates per ray, evenly strided.

    Rays with ``c <= count`` occupied candidates keep them all (first-K);
    rays with ``c > count`` keep every ``c/count``-th one, covering the
    whole occupied span, each then standing for ``c/count`` candidate bins
    (the returned delta scale).

    :param ts: ``[N, C]`` sorted candidate positions.
    :param occupied: ``[N, C]`` bool.
    :param count: K survivors per ray.
    :return: ``(sel_ts [N, K], sel_mask [N, K], delta_scale [N, 1])``;
             valid entries are t-sorted and lead each row.
    """
    cum = torch.cumsum(occupied.to(torch.int64), dim=1)  # [N, C]
    c = cum[:, -1:]  # [N, 1] occupied count
    k = torch.arange(count, dtype=torch.int64, device=ts.device)[None, :]
    # Rank of the candidate each slot takes: k when c <= K, floor(k*c/K)
    # when c > K.
    ranks = k * torch.clamp(c, min=count) // count  # [N, K]
    sel_mask = ranks < c
    # Index of the (rank+1)-th occupied candidate: the first position where
    # the running count reaches it (side left).
    idx = torch.searchsorted(cum.contiguous(), torch.minimum(ranks + 1, c).contiguous())
    idx = idx.clamp(max=ts.shape[1] - 1)
    sel_ts = torch.gather(ts, 1, idx)
    delta_scale = torch.clamp(c.to(ts.dtype) / count, min=1.0)
    return sel_ts, sel_mask, delta_scale
