"""Occupancy-grid accelerated sampling (port of
``learn_nerf_tpu.acceleration``: the grid, its training-time update and
the rendering helpers).

A binary occupancy grid over the scene bbox (an EMA of model densities per
cell, trained with the model and checkpointed beside it) culls cheap
stratified candidates; :func:`compact_occupied_strided` then keeps K
occupied candidates per ray, evenly strided over the occupied span, so the
field model runs on ``[N, K]`` points.  Static shapes throughout.  On the
card one kernel does both (:mod:`.kernels.selection`); the ops here are its
plain version.  The
pooled inference path sizes its sample pool with the budget buckets below.

The inference levers' tables are built here too: the max-pooled supergrid
of two-phase span selection (:func:`superpool_densities`,
:func:`dilate_supercells`) and the packed block words
(:func:`pack_block_table`, :meth:`OccupancyGrid.block_indices`), whose
bits (:func:`pack_occupancy_words`) the selection kernel reads, kept on
each grid state (:meth:`OccupancyGrid.occupancy_words`).

A captured train step reads the grid through :class:`StaticGridState`: one
densities storage and one words buffer that every new state is copied
into, since a CUDA graph reads the addresses it captured.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclass
class OccupancyGridState:
    """EMA density estimates per cell, flat ``[resolution^3]``, and the
    number of grid updates so far."""

    densities: Tensor
    step: int


def bbox_tensors(owner, device: Union[str, torch.device]) -> Tuple[Tensor, Tensor]:
    """``(bbox_min [3], bbox_max [3])`` of ``owner`` (a grid or a renderer:
    anything with those two fields) as f32 tensors on ``device``, built once
    per device and kept on ``owner``: a tensor made from Python numbers is a
    host copy, which a captured step may not make."""
    device = torch.device(device)
    corners = owner.__dict__.setdefault("_bbox_by_device", {})
    if device not in corners:
        corners[device] = tuple(torch.tensor(v, dtype=torch.float32, device=device)
                                for v in (owner.bbox_min, owner.bbox_max))
    return corners[device]


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
        bbox_min, bbox_max = bbox_tensors(self, x.device)
        frac = ((x - bbox_min) / (bbox_max - bbox_min)).clamp(0.0, 1.0 - 1e-7)
        return (frac * self.resolution).to(torch.int64)

    def cell_indices(self, x: Tensor) -> Tensor:
        """Flat cell index per point (x fastest), ``[...]`` int64."""
        cell = self._cell_coords(x)
        r = self.resolution
        return cell[..., 0] + r * (cell[..., 1] + r * cell[..., 2])

    def block_indices(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """(flat block-word index, bit index) per point for the packed
        occupancy words (:func:`pack_occupancy_words`, the grid padded to
        whole words; :func:`pack_block_table`); the quantization of
        :meth:`cell_indices`."""
        cell = self._cell_coords(x)
        dx, dy, dz = BLOCK_DIMS
        r = self.resolution
        nbx, nby = -(-r // dx), -(-r // dy)
        widx = cell[..., 0] // dx + nbx * (cell[..., 1] // dy + nby * (cell[..., 2] // dz))
        bit = cell[..., 0] % dx + dx * (cell[..., 1] % dy) + dx * dy * (cell[..., 2] % dz)
        return widx, bit

    def in_warmup(self, state: OccupancyGridState) -> bool:
        """Whether every cell tests occupied: ``state.step <
        warmup_updates``.  Its single definition; every occupancy consumer
        routes through here (the selection kernel takes it by value)."""
        return state.step < self.warmup_updates

    def occupancy_words(self, state: OccupancyGridState) -> Tensor:
        """The state's packed cell bits ``d > threshold``
        (:func:`pack_occupancy_words`), which the selection kernel reads:
        built at the first call, kept on the state, and built again
        whenever ``state.densities`` is another tensor or was changed in
        place since (its ``_version``).  An inference tensor keeps no
        version, so its words are built at every call: frames take them
        from ``OccupancyRenderer.selection_tables``, built once a frame."""
        densities = state.densities
        version = None if densities.is_inference() else densities._version
        key = (self.resolution, self.threshold)
        cached = getattr(state, "_occupancy_words", None)
        if cached is not None and version is not None and cached[0] is densities and cached[1:3] == (version, key):
            return cached[3]
        words = pack_occupancy_words(densities.detach(), self.resolution, self.threshold)
        state._occupancy_words = (densities, version, key, words)
        return words

    def occupied_from_bits(self, state: OccupancyGridState, bits: Tensor) -> Tensor:
        """The warmup rule on per-cell threshold tests (``d > threshold``,
        or a block word's bit): all true in warmup (:meth:`in_warmup`)."""
        return bits | self.in_warmup(state)

    def occupied_from_densities(self, state: OccupancyGridState, d: Tensor) -> Tensor:
        """Occupancy test on already-gathered cell densities: all true while
        ``state.step < warmup_updates``, a threshold test afterwards."""
        return self.occupied_from_bits(state, d > self.threshold)

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

    def cell_positions(self, ids: Tensor, jitter: Tensor) -> Tensor:
        """World-space positions of cells ``ids``, jittered within the cell.

        :param ids: ``[M]`` flat cell indices (x fastest).
        :param jitter: ``[M, 3]`` uniforms in ``[0, 1)``.
        """
        r = self.resolution
        coords = torch.stack(
            [ids % r, torch.div(ids, r, rounding_mode="floor") % r,
             torch.div(ids, r * r, rounding_mode="floor")], dim=-1,
        )
        bbox_min, bbox_max = bbox_tensors(self, ids.device)
        frac = (coords.to(torch.float32) + jitter) / r
        return bbox_min + frac * (bbox_max - bbox_min)

    def update(
        self,
        state: OccupancyGridState,
        model,
        num_cells: Optional[int] = None,
        num_samples: int = 1,
        generator: Optional[torch.Generator] = None,
        ids: Optional[Tensor] = None,
        jitter: Optional[Tensor] = None,
    ) -> OccupancyGridState:
        """One EMA update (Instant NGP rule, partial-sampling variant).

        All cells decay by ``decay`` (not during warmup: a cell the partial
        refresh never visited must leave warmup at its init value); a
        random subset of ``num_cells`` (default: all) is re-evaluated
        through the model at zero directions, ``num_samples`` jittered
        points per cell with the max taken, and maxed in:
        ``d[c] <- max(decay * d[c], density)``.  The subset is drawn with
        replacement, so ``ids`` repeats cells; the max covers that.

        :param model: the field model (evaluated under ``no_grad``).
        :param generator: draws ``ids`` and ``jitter`` when they are absent;
            must live on the grid's device.
        :param ids: optional ``[M]`` int64 cells to refresh.
        :param jitter: optional ``[num_samples, M, 3]`` uniforms.
        :return: the new state, ``step + 1``; ``state`` is not modified.
        """
        device = state.densities.device
        n = self.resolution**3
        if ids is None:
            if num_cells is None or num_cells >= n:
                ids = torch.arange(n, dtype=torch.int64, device=device)
            else:
                ids = torch.randint(0, n, (num_cells,), generator=generator, device=device)
        ids = ids.to(torch.int64)
        samples = max(num_samples, 1)
        if jitter is None:
            jitter = torch.rand((samples, ids.shape[0], 3), generator=generator, device=device)
        density = None
        with torch.no_grad():
            for s in range(samples):
                pts = self.cell_positions(ids, jitter[s])
                d = model(pts, torch.zeros_like(pts))[0][..., 0].float()
                density = d if density is None else torch.maximum(density, d)
            decay = 1.0 if state.step < self.warmup_updates else self.decay
            densities = state.densities * decay
            densities.scatter_reduce_(0, ids, density, reduce="amax", include_self=True)
        return OccupancyGridState(densities=densities, step=state.step + 1)


class StaticGridState:
    """The grid as a captured train step reads it: one densities storage
    and one buffer of its packed words (:func:`pack_occupancy_words`), both
    overwritten in place whenever the loop's state changes.  A CUDA graph
    reads the addresses it captured, so a new state's densities are copied
    into the storage (:meth:`OccupancyGrid.update` keeps returning new
    ones, the JAX contract) and its words rebuilt into the buffer, outside
    the graph: a stale buffer would select wrong samples with no error, and
    a rebuild inside the graph would repack every cell on every replay."""

    def __init__(self, grid: OccupancyGrid):
        self.grid = grid
        self.densities: Optional[Tensor] = None
        self.words: Optional[Tensor] = None
        self._source = None  # (state, its words) last copied

    def follow(self, state: OccupancyGridState) -> OccupancyGridState:
        """``state`` over the storage: its densities and its words
        (:meth:`OccupancyGrid.occupancy_words`, which decides when they are
        stale) copied in whenever ``state`` or those words are not the ones
        last copied, else nothing.  The storage keeps ``state``'s step."""
        words = self.grid.occupancy_words(state)
        if self._source is None or self._source[0] is not state or self._source[1] is not words:
            densities = state.densities.detach()
            if self.densities is None:
                self.densities, self.words = densities.clone(), words.clone()
            else:
                self.densities.copy_(densities)
                self.words.copy_(words)
            self._source = (state, words)
        return OccupancyGridState(densities=self.densities, step=state.step)


def superpool_densities(densities: Tensor, resolution: int, factor: int) -> Tensor:
    """Max-pool the flat ``[resolution^3]`` cell densities by ``factor``.

    A supercell's value is the max over its ``factor^3`` children, so a
    threshold test on the pooled grid is conservative.  The flat index
    follows :meth:`OccupancyGrid.cell_indices` at the pooled resolution.
    """
    r, f = resolution, factor
    rs = r // f
    cube = densities.reshape(rs, f, rs, f, rs, f)  # [z, y, x] blocks
    return cube.amax(dim=(1, 3, 5)).reshape(-1)


#: Cells per packed occupancy word, (x, y, z): 4*4*2 = 32 cells, one
#: 32-bit word.  A table row is the word and the block's max density.
BLOCK_DIMS = (4, 4, 2)


def pack_occupancy_words(densities: Tensor, resolution: int, threshold: float) -> Tensor:
    """Pack flat ``[r^3]`` cell densities into contiguous int32 words of
    ``BLOCK_DIMS`` cells, a cell's bit set where ``d > threshold``: word
    ``bx + ceil(r/4)*(by + ceil(r/4)*bz)``, bit ``x%4 + 4*(y%4) + 16*(z%2)``
    (:meth:`OccupancyGrid.block_indices`).  A resolution the block dims do
    not divide is padded to whole words with clear bits, which no cell
    reads.  ``[r^3/32]`` when they divide: 256 KiB at 128^3.  The bit
    pattern of each uint32 word is stored as an int32."""
    r = resolution
    dx, dy, dz = BLOCK_DIMS
    nbx, nby, nbz = -(-r // dx), -(-r // dy), -(-r // dz)
    bits = torch.zeros((nbz * dz, nby * dy, nbx * dx), dtype=torch.int64, device=densities.device)
    # Flat layout x-fastest -> the [z, y, x] cube (as superpool_densities).
    bits[:r, :r, :r] = (densities.reshape(r, r, r) > threshold).to(torch.int64)
    cube = bits.reshape(nbz, dz, nby, dy, nbx, dx)
    device = densities.device
    zi = torch.arange(dz, dtype=torch.int64, device=device)
    yi = torch.arange(dy, dtype=torch.int64, device=device)
    xi = torch.arange(dx, dtype=torch.int64, device=device)
    weight = 1 << (xi[None, None, :] + dx * yi[None, :, None] + dx * dy * zi[:, None, None])  # [dz, dy, dx]
    words = (cube * weight[:, None, :, None, :]).sum(dim=(1, 3, 5)) & 0xFFFFFFFF  # [bz, by, bx]
    # The uint32 value as the int32 of the same bits (two's complement).
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32).reshape(-1)


def pack_block_table(densities: Tensor, resolution: int, threshold: float) -> Tensor:
    """Pack flat ``[r^3]`` cell densities into a ``[r^3/32, 2]`` float32
    table: column 0 the block's 32 occupancy bits (``d > threshold``,
    :func:`pack_occupancy_words`) as the bit pattern of a uint32, column 1
    the block's max density.

    Block flat index ``bx + (r/4)*(by + (r/4)*bz)``, bit index ``x%4 +
    4*(y%4) + 16*(z%2)``: :meth:`OccupancyGrid.block_indices` computes
    both.  Many words are NaN or denormal bit patterns as floats, so the
    words are built in int64, stored as int32 bits and viewed as float32;
    readers view the rows as int32 again before any bit logic
    (:func:`~.occ_render._bracketed_block_words`), and no word ever passes
    through float arithmetic or a cast.
    """
    r = resolution
    dx, dy, dz = BLOCK_DIMS
    if r % dx or r % dy or r % dz:
        raise ValueError(
            f"occupancy grid resolution {r} is not divisible by the "
            f"block dims {BLOCK_DIMS} (block-word selection needs it)"
        )
    cube = densities.reshape(r // dz, dz, r // dy, dy, r // dx, dx)
    dmax = cube.amax(dim=(1, 3, 5)).contiguous().view(torch.int32)
    table = torch.stack([pack_occupancy_words(densities, r, threshold), dmax.reshape(-1)], dim=-1)
    return table.view(torch.float32)  # [nblocks, 2]; flatten order bx-fastest


def dilate_supercells(sup: Tensor, rs: int) -> Tensor:
    """Max-dilate flat ``[rs^3]`` supercell densities by one cell (3^3,
    ``-inf`` beyond the grid), so that a span probe in a supercell next to
    an occupied one still tests positive (the conservativeness argument of
    :meth:`~.occ_render.OccupancyRenderer._occupied_span`).  The flat
    layout of :func:`superpool_densities`."""
    cube = sup.reshape(1, 1, rs, rs, rs)
    return F.max_pool3d(cube, kernel_size=3, stride=1, padding=1).reshape(-1)


#: Quantized per-ray pool budgets for "auto" modes: resolved budgets snap
#: up to one of these, so the distinct pool sizes a run sees stay few.
AUTO_BUDGET_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

#: Safety margin over the measured mean per-ray demand for "auto" pool
#: sizing.
AUTO_BUDGET_MARGIN = 1.3


def auto_budget_from_demand(demand: float, cap: int) -> int:
    """Measured mean per-ray demand -> quantized budget (margin applied)."""
    return quantize_budget(demand * AUTO_BUDGET_MARGIN, cap)


def quantize_budget(per_ray: float, cap: int) -> int:
    """Snap a measured per-ray demand up to the next budget bucket, capped
    at ``cap`` (the per-ray sample limit K).

    Above the largest tabulated bucket the ladder extends geometrically
    (96, 128, 192, ...: alternately x1.5 and x1.33), so sizing never drops
    below demand while the cap allows it.
    """
    for b in AUTO_BUDGET_BUCKETS:
        if b >= per_ray:
            return min(b, cap)
    b = AUTO_BUDGET_BUCKETS[-1]
    while b < per_ray and b < cap:
        b = b * 3 // 2 if (b & (b - 1)) == 0 else b * 4 // 3
    return min(b, cap)


def next_budget_bucket(budget: int, cap: int) -> int:
    """The next bucket above ``budget`` (for overflow escalation), capped."""
    for b in AUTO_BUDGET_BUCKETS:
        if b > budget:
            return min(b, cap)
    b = max(budget, AUTO_BUDGET_BUCKETS[-1])
    b = b * 3 // 2 if (b & (b - 1)) == 0 else b * 4 // 3
    return min(b, cap)


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
