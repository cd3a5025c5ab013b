"""The index arithmetic of the hash-grid kernels' shared thread layout
(learn_nerf_tpu_torch/csrc/encode_args.cuh, hashgrid_encode.cu,
hashgrid_backward.cu), pinned on the CPU where no card is.

A NumPy model of what the kernels compute in closed form is held against a
brute-force walk over (block, warp, lane) that follows the kernels' loops:

* the tile map: which (point, work item) each lane of each warp takes, at
  n = 1, 31, 32, 33, 65 points and tiles of 32 and 64 points, with as many
  warps as units or fewer (a warp then strides over the units); every pair
  exactly once, lanes past the last point idle;
* the staged tile in shared memory: offsets of x and of the [points, L*F]
  slab, all inside the block's allocation, no two alike, the 32 lanes of a
  warp on 32 different banks, and the copy loop between the slab and device
  memory touching every element once, in whole lines;
* run heads and the segmented reduction of the table-gradient kernel: the
  vote-and-shuffle arithmetic against sums over each run of equal cells,
  with runs that fill a warp, end at lane 31, and idle lanes;
* pair atomics: which corner pairs take one vector atomic, and that the
  gradient they leave equals one add per row, also where two corners hash
  to one row;
* the flat gradient buffer's padded level offsets;
* hashgrid_dx.cu's forward: its block map (whole points a block, every
  (point, work item) once) and its level terms in shared memory (distinct
  slots in bounds, summed per point in level order, so equal bit for bit to
  a sequential sum over the levels); its backward: the tile layout above
  with x, h and one slab that a lane reads g from and writes grad_g to, and
  run combining with per-lane weights a_c before pair atomics.

The constants of the model are read from the sources, so a change there is
a change here.
"""

import re

import numpy as np
import pytest
import torch

from learn_nerf_tpu_torch.kernels import build
from learn_nerf_tpu_torch.kernels import hashgrid as khash
from learn_nerf_tpu_torch.kernels import hashgrid_backward as kb
from learn_nerf_tpu_torch.kernels import hashgrid_dx as kd
from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke

from .torch_helpers import t


def _constant(file, name):
    text = (build.CSRC_DIR / file).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


DX_THREADS = 256  # hashgrid_dx.cu's kDxThreads


def test_the_sources_hold_the_layout_the_model_assumes():
    assert _constant("encode_args.cuh", "kTilePoints") == 32 == kd.TILE_POINTS
    assert _constant("encode_args.cuh", "kTileThreads") == 256
    assert _constant("encode_args.cuh", "kLevelsPerItem") == ke.LEVELS_PER_ITEM
    assert _constant("table_atomics.cuh", "kCombineMinMerged") == 8
    text = (build.CSRC_DIR / "encode_args.cuh").read_text()
    assert "return width | 1;" in text and "kTilePoints * (3 + tile_stride(width))" in text
    # hashgrid_dx.cu: the forward's blocks of whole points and its level
    # terms in shared memory; the backward on the tile layout above, x and h
    # staged before the slab it reads g from and writes grad_g to.
    assert _constant("hashgrid_dx.cu", "kDxThreads") == DX_THREADS
    dx = (build.CSRC_DIR / "hashgrid_dx.cu").read_text()
    assert "constexpr int kDxTermFloats = 7 * kDxThreads;" in dx
    assert "points = kDxThreads / items, stride = (3 * a.levels) | 1;" in dx
    assert "terms + local * stride + 3 * l0" in dx and "slot[3 * k + ax] = terms[k][ax]" in dx
    assert "terms + q * stride + (i - 3 * q)" in dx and "sum = __fadd_rn(sum, t[3 * l])" in dx
    assert "<<<blocks, points * a.items, 0, stream>>>" in dx
    # ... and a thread a point where no level hashes (the coarse model).
    assert "if (a.hashed[l]) return false;" in dx and "  if (dense_only(a)) {" in dx
    assert "hashgrid_dx_points_kernel<F><<<blocks, kDxThreads, 0, stream>>>" in dx
    assert "tile_block_threads(a.items), smem" in dx
    assert "sizeof(float) * (3 * kTilePoints + tile_floats(a.levels * F))" in dx
    assert "float* tile = hs + 3 * kTilePoints;" in dx and "float* slab = tile + p * stride + l0 * F;" in dx


# --- the model: closed forms -------------------------------------------------


def tile_stride(width):
    return width | 1


def block_warps(items, tile_points, tile_threads):
    return min(items * (tile_points // 32), tile_threads // 32)


def place_of(point, item, items, tile_points, tile_threads):
    """(block, warp, lane, pass of the warp's loop) that takes (point, item)."""
    block, p = divmod(point, tile_points)
    chunk, lane = divmod(p, 32)
    unit = chunk * items + item
    turn, warp = divmod(unit, block_warps(items, tile_points, tile_threads))
    return block, warp, lane, turn


# --- the brute force: the kernels' loops -------------------------------------


def walk(n, items, tile_points, tile_threads):
    """Every (block, warp, lane, pass) -> (point, item) the kernel's loops
    visit, and the lanes it leaves idle."""
    warps = block_warps(items, tile_points, tile_threads)
    units = items * (tile_points // 32)
    taken, idle = {}, 0
    for block in range(-(-n // tile_points)):
        base = block * tile_points
        count = min(tile_points, n - base)
        for warp in range(warps):
            for turn, unit in enumerate(range(warp, units, warps)):
                chunk = 0 if tile_points == 32 else unit // items
                item = unit - chunk * items
                for lane in range(32):
                    p = 32 * chunk + lane
                    if p < count:
                        taken[(block, warp, lane, turn)] = (base + p, item)
                    else:
                        idle += 1
    return taken, idle


@pytest.mark.parametrize("tile_points,tile_threads", [(32, 256), (64, 256), (32, 128), (64, 512)])
@pytest.mark.parametrize("items", [1, 3, 8, 11])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 65])
def test_tile_map_takes_every_point_and_item_once(n, items, tile_points, tile_threads):
    taken, idle = walk(n, items, tile_points, tile_threads)
    assert sorted(taken.values()) == [(p, i) for p in range(n) for i in range(items)]
    for point in range(n):
        for item in range(items):
            assert taken[place_of(point, item, items, tile_points, tile_threads)] == (point, item)
    tiles = -(-n // tile_points)
    assert idle == (tiles * tile_points - n) * items
    # As the launch sizes a block: whole warps, one per unit up to the most.
    threads = 32 * block_warps(items, tile_points, tile_threads)
    assert 32 <= threads <= tile_threads and threads % 32 == 0


@pytest.mark.parametrize("tile_points", [32, 64])
@pytest.mark.parametrize("levels,features", [(16, 2), (6, 2), (3, 1), (5, 3), (12, 4), (32, 4)])
def test_staged_tile_offsets_are_distinct_in_bounds_and_free_of_bank_conflicts(tile_points, levels, features):
    width = levels * features
    stride = tile_stride(width)
    floats = tile_points * (3 + stride)  # tile_floats
    assert stride % 2 == 1 and stride >= width and floats * 4 <= 48 * 1024
    x_at = {(p, a): 3 * p + a for p in range(tile_points) for a in range(3)}
    slab_at = {(p, c): 3 * tile_points + p * stride + c for p in range(tile_points) for c in range(width)}
    offsets = list(x_at.values()) + list(slab_at.values())
    assert len(set(offsets)) == len(offsets) and min(offsets) == 0 and max(offsets) < floats
    # One instruction of a warp: lane p of a chunk reads x[p][a], or touches
    # column c of its own row of the slab; 32 lanes, 32 banks.
    for chunk in range(tile_points // 32):
        lanes = range(32 * chunk, 32 * chunk + 32)
        for a in range(3):
            assert len({x_at[(p, a)] % 32 for p in lanes}) == 32
        for c in range(width):
            assert len({slab_at[(p, c)] % 32 for p in lanes}) == 32


@pytest.mark.parametrize("count", [1, 7, 31, 32])
@pytest.mark.parametrize("width,threads", [(32, 256), (12, 96), (3, 32), (20, 256)])
def test_slab_copy_touches_every_element_once_in_whole_lines(count, width, threads):
    stride = tile_stride(width)
    base = 5 * 32  # the tile's first point
    written = {}
    for first in range(0, count * width, threads):  # one pass of the block's loop
        for thread in range(threads):
            e = first + thread
            if e < count * width:
                row = e // width
                written[base * width + e] = row * stride + (e - row * width)
    # Device memory: the tile's rows are one contiguous run, in thread order.
    assert sorted(written) == list(range(base * width, (base + count) * width))
    for (address, offset) in written.items():
        point, col = divmod(address, width)
        assert offset == (point - base) * stride + col
    # A warp's 32 threads touch 32 consecutive floats of device memory.
    first_warp = sorted(written)[:32]
    assert first_warp == list(range(first_warp[0], first_warp[0] + len(first_warp)))


# --- run heads and the segmented reduction -----------------------------------


def combine_runs(cells, active, values, min_merged):
    """The kernel's vote and shuffles on one warp: ``cells [32, 3]``,
    ``active [32]`` (a prefix), ``values [32]``.  Returns (adds [32],
    values after the reduction)."""
    same = np.zeros(32, bool)
    for lane in range(1, 32):
        same[lane] = active[lane] and (cells[lane] == cells[lane - 1]).all()
    heads = sum(1 << lane for lane in range(32) if not same[lane])
    if 32 - bin(heads).count("1") < min_merged:
        return active.copy(), values.copy()
    end = np.zeros(32, int)
    for lane in range(32):
        above = 0 if lane == 31 else heads & ~((2 << lane) - 1) & 0xFFFFFFFF
        ffs = (above & -above).bit_length()  # 1-based place of the lowest set bit
        end[lane] = ffs - 2 if above else 31
    v = values.copy()
    d = 1
    while d < 32:
        other = np.concatenate([v[d:], v[32 - d:]])  # shfl_down: lanes past the end keep their own
        take = np.arange(32) + d <= end
        v = np.where(take, v + other, v)
        d *= 2
    return active & ~same, v


def _cells_of(run_lengths):
    ids = np.repeat(np.arange(len(run_lengths)), run_lengths)[:32]
    return np.stack([ids, ids * 7 % 5, ids * 3 % 11], axis=1)


@pytest.mark.parametrize("name,run_lengths,count", [
    ("one cell", [32], 32),
    ("a run that ends at lane 31", [5, 11, 16], 32),
    ("two rays of 16", [16, 16], 32),
    ("short runs", [1, 2, 3, 4, 1, 1, 5, 6, 2, 7], 32),
    ("a part-full tile", [4, 9, 19], 20),
    ("one point", [32], 1),
    ("no runs", [1] * 32, 32),
    ("few merged lanes", [1] * 25 + [4, 3], 32),
])
def test_run_heads_and_segmented_sums(name, run_lengths, count):
    cells = _cells_of(run_lengths)
    active = np.arange(32) < count
    values = np.random.RandomState(len(name)).randint(-50, 50, 32).astype(np.float64) * active
    adds, summed = combine_runs(cells, active, values, min_merged=8)
    # Brute force: runs of consecutive active lanes in one cell.
    runs, lane = [], 0
    while lane < count:
        stop = lane + 1
        while stop < count and (cells[stop] == cells[lane]).all():
            stop += 1
        runs.append((lane, stop))
        lane = stop
    merged = count - len(runs)
    if merged >= 8:
        assert sorted(np.flatnonzero(adds)) == [first for first, _ in runs]
        for first, stop in runs:
            assert summed[first] == values[first:stop].sum()
    else:
        assert (adds == active).all() and (summed == values).all()
    # Nothing is lost or added twice.
    assert summed[adds].sum() == values[active].sum()


def test_idle_lanes_in_the_cell_of_the_last_point_join_no_run():
    # Idle lanes compute the cell of x = 0: it may equal an active lane's.
    cells = np.zeros((32, 3), int)
    active = np.arange(32) < 12
    values = np.arange(32, dtype=np.float64) * active
    adds, summed = combine_runs(cells, active, values, min_merged=8)
    assert list(np.flatnonzero(adds)) == [0] and summed[0] == values[:12].sum()


# --- pair atomics -------------------------------------------------------------


def scatter_with_pairs(rows, values, paired, table_rows, features):
    """The kernel's adds for one point and level: ``rows [8]``, ``values
    [8, F]``.  Returns (gradient [table_rows, F], atomics made)."""
    grad = np.zeros((table_rows + table_rows % 2, features))
    flat = grad.reshape(-1)  # the level starts at an even row of the buffer
    atomics = 0
    for c in range(4):
        r0, r1 = int(rows[c]), int(rows[c + 4])
        if paired and features <= 2 and (r0 ^ r1) == 1:
            lo, hi = (values[c + 4], values[c]) if r0 & 1 else (values[c], values[c + 4])
            start = (r0 >> 1) * 2 * features
            assert start * 4 % (8 * features) == 0  # aligned to the vector's size
            flat[start:start + 2 * features] += np.concatenate([lo, hi])
            atomics += 1
        else:
            grad[r0] += values[c]
            grad[r1] += values[c + 4]
            atomics += 2
    return grad[:table_rows], atomics


@pytest.mark.parametrize("features", [1, 2])
@pytest.mark.parametrize("grid,size", [(16, 2**18), (64, 2**18), (128, 2**12), (64, 1000), (5, 4096)])
def test_pair_atomics_leave_the_gradient_of_one_add_per_row(grid, size, features):
    rng = np.random.RandomState(grid + features)
    x = t(rng.uniform(-1, 1, (400, 3)).astype(np.float32))
    idx, _ = khash.hashgrid_corners_reference(x, [grid], [size], (-1.0,) * 3, (1.0,) * 3, False)
    idx = idx[0].numpy()
    table_rows = min(grid**3, size)
    paired = table_rows % 2 == 0
    total = 0
    for rows in idx:
        values = rng.randint(-9, 9, (8, features)).astype(np.float64)
        got, atomics = scatter_with_pairs(rows, values, paired, table_rows, features)
        want = np.zeros((table_rows, features))
        np.add.at(want, rows, values)
        np.testing.assert_array_equal(got, want)
        total += atomics
    if not paired:
        assert total == 8 * len(idx)
    elif size >= grid**3 or size & (size - 1) == 0:
        # Dense, or hashed into a power of two: every even x pairs its four
        # corner pairs, about half of the points.
        assert 5.5 * len(idx) < total < 6.5 * len(idx)


def test_two_corners_on_one_row_take_no_pair_atomic():
    rows = np.array([6, 7, 10, 11, 6, 6, 11, 10])  # c and c + 4: same row, pair, pair reversed, pair
    values = np.arange(16, dtype=np.float64).reshape(8, 2)
    got, atomics = scatter_with_pairs(rows, values, True, 16, 2)
    want = np.zeros((16, 2))
    np.add.at(want, rows, values)
    np.testing.assert_array_equal(got, want)
    assert atomics == 2 + 1 + 1 + 1


# --- the flat gradient buffer --------------------------------------------------


@pytest.mark.parametrize("features", [1, 2, 3, 4])
def test_level_offsets_start_every_level_at_an_even_row(features):
    grids, sizes = [3, 5, 4, 16, 64, 7], [4096, 4096, 4096, 4096, 1001, 100]
    rows = [min(g**3, s) for g, s in zip(grids, sizes)]  # 27, 125, 64, 4096, 1001, 100
    tables = [torch.zeros((r, features)) for r in rows]
    args = ke.pack_args(tables, grids, sizes, (-1.0,) * 3, (1.0,) * 3, False)
    offsets = kb.level_offsets(args)
    # Brute force: place each level at the first even row past the last one.
    want, row = [], 0
    for r in rows:
        while row % 2:
            row += 1
        want.append(row)
        row += r
    assert offsets[:-1] == want == [0, 28, 154, 218, 4314, 5316]
    assert offsets[-1] >= row and offsets[-1] - row <= 1
    for start, r in zip(offsets, rows):
        assert start * features * 4 % (8 * min(features, 2)) == 0 or features == 3
    # No level overlaps the next.
    assert all(a + r <= b for a, r, b in zip(offsets, rows, offsets[1:]))
    # The standard schedule has no odd level: nothing is padded.
    fine = [2 ** (4 + i // 2) for i in range(16)]
    fine_args = ke.pack_args([torch.zeros((min(g**3, 2**18), 2)) for g in fine], fine, [2**18] * 16,
                             (-1.0,) * 3, (1.0,) * 3, False)
    assert kb.level_offsets(fine_args)[-1] == sum(min(g**3, 2**18) for g in fine)


# --- hashgrid_dx's forward: blocks of whole points, level terms in shared memory


def schedule(run_lengths):
    """Grid and table sizes of levels in runs of these lengths (equal grid
    and size inside a run), and the work items the wrapper cuts them into."""
    grids = [2 ** (3 + r) for r, length in enumerate(run_lengths) for _ in range(length)]
    sizes = [2**18] * len(grids)
    return grids, sizes, ke.work_items(grids, sizes)


# Level schedules of 1-8 work items; odd runs give items of one level.
SCHEDULES = [[1], [2], [3], [1, 1], [2, 1, 2], [1, 3, 2], [3, 3, 1], [5, 5, 1], [2] * 8, [1, 2, 3, 4, 5]]


def dx_walk(n, items):
    """Every (block, thread) -> (point, item) of hashgrid_dx_kernel's grid:
    blocks of floor(256 / items) points, a point's items on consecutive
    threads; threads past the last point only meet the barrier."""
    points = DX_THREADS // items
    taken = {}
    for block in range(-(-n // points)):
        base = block * points
        count = min(points, n - base)
        for thread in range(points * items):
            local = thread // items
            if local < count:
                taken[(block, thread)] = (base + local, thread - local * items)
    return taken, points


@pytest.mark.parametrize("runs", SCHEDULES, ids=str)
@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 256, 257])
def test_dx_block_map_takes_every_point_and_item_once_in_whole_points(n, runs):
    _, _, items = schedule(runs)
    taken, points = dx_walk(n, len(items))
    assert sorted(taken.values()) == [(p, i) for p in range(n) for i in range(len(items))]
    blocks = {}
    for (block, _), (point, _) in taken.items():
        blocks.setdefault(point, set()).add(block)
    assert all(len(b) == 1 for b in blocks.values())  # a point's items share a block
    assert len(items) <= points * len(items) <= DX_THREADS


def dx_slots(items, levels, count):
    """The forward's shared floats: what each (point, item) thread writes
    (slot -> (point, level, axis)) and, in order, what each (point, axis)
    summing thread reads."""
    stride = (3 * levels) | 1
    written = {}
    for local in range(count):
        for first, k_levels in items:
            for k in range(k_levels):
                for ax in range(3):
                    slot = local * stride + 3 * first + 3 * k + ax
                    assert slot not in written
                    written[slot] = (local, first + k, ax)
    reads = {}
    for i in range(3 * count):
        q, ax = divmod(i, 3)
        reads[(q, ax)] = [q * stride + ax + 3 * level for level in range(levels)]
    return written, reads


@pytest.mark.parametrize("runs", SCHEDULES + [[2] * 16, [1] * 32, [2] * 3 + [1] * 26], ids=str)
def test_dx_level_terms_are_distinct_in_bounds_and_summed_in_level_order(runs):
    grids, _, items = schedule(runs)
    levels, points = len(grids), DX_THREADS // len(items)
    written, reads = dx_slots(items, levels, points)
    assert max(written) < 7 * DX_THREADS  # kDxTermFloats
    for (q, ax), slots in reads.items():
        assert [written[s] for s in slots] == [(q, level, ax) for level in range(levels)]
    assert sorted(s for slots in reads.values() for s in slots) == sorted(written)
    # The sum each (point, axis) thread forms equals, bit for bit, the sum of
    # one thread a point over its items in order (the first design's).
    rng = np.random.RandomState(levels)
    shared = np.zeros(7 * DX_THREADS, np.float32)
    terms = (rng.standard_normal((points, levels, 3)) * 10.0 ** rng.randint(-6, 6, (points, levels, 3))).astype(
        np.float32)
    for slot, (q, level, ax) in written.items():
        shared[slot] = terms[q, level, ax]
    for (q, ax), slots in reads.items():
        got = np.float32(0.0)
        for s in slots:
            got = np.float32(got + shared[s])
        want = np.float32(0.0)
        for first, k_levels in items:
            for k in range(k_levels):
                want = np.float32(want + terms[q, first + k, ax])
        assert got.tobytes() == want.tobytes()


def test_dx_level_terms_fit_for_every_schedule_the_kernel_takes():
    # levels <= 2 * items <= 64 and items <= levels <= 32 (valid_args).
    for items in range(1, 33):
        for levels in range(items, min(2 * items, 32) + 1):
            assert (DX_THREADS // items) * ((3 * levels) | 1) <= 7 * DX_THREADS


# --- hashgrid_dx's backward: the staged tile and the table gradient ---------


@pytest.mark.parametrize("levels,features", [(16, 2), (6, 2), (5, 1), (12, 4), (32, 4)])
def test_dx_backward_tile_is_distinct_in_bounds_and_each_lane_owns_its_columns(levels, features):
    width = levels * features
    stride = tile_stride(width)
    floats = 3 * 32 + 32 * (3 + stride)  # 3 * kTilePoints + tile_floats(width)
    assert floats * 4 <= 48 * 1024
    xs = [3 * p + a for p in range(32) for a in range(3)]
    hs = [3 * 32 + 3 * p + a for p in range(32) for a in range(3)]
    slab = [6 * 32 + p * stride + c for p in range(32) for c in range(width)]
    offsets = xs + hs + slab
    assert len(set(offsets)) == len(offsets) and max(offsets) < floats
    # Each (point, item) lane reads g from and writes grad_g to its item's
    # columns alone: the items' columns tile the point's row once.
    grids = [2 ** (4 + i // 2) for i in range(levels)]
    items = ke.work_items(grids, [2**18] * levels)
    columns = sorted(c for first, k in items for c in range(first * features, (first + k) * features))
    assert columns == list(range(width))


def dx_backward_warp(cells, rows, active, a, g, paired, table_rows, features, min_merged=8):
    """One warp of the dx backward in one level: per-lane corner weights
    ``a [32, 8]`` times the lane's cotangent ``g [32, F]``, summed over runs
    by the vote and shuffles, then the pair atomics of the run heads.
    Returns the gradient [table_rows, F]."""
    terms = a[:, :, None] * g[:, None, :]  # [32, 8, F]: a_c * g
    summed = np.empty_like(terms)
    adds = None
    for c in range(8):
        for f in range(features):
            adds, summed[:, c, f] = combine_runs(cells, active, terms[:, c, f], min_merged)
    grad = np.zeros((table_rows, features))
    for lane in np.flatnonzero(adds):
        got, _ = scatter_with_pairs(rows[lane], summed[lane], paired, table_rows, features)
        grad += got
    return grad


@pytest.mark.parametrize("features", [1, 2])
@pytest.mark.parametrize("grid,size,spacing", [(16, 2**18, 1e-3), (64, 2**18, 4e-3), (128, 1000, 5e-3),
                                               (64, 12, 2e-2), (5, 4096, 1e-2)])
def test_dx_backward_combined_adds_equal_one_add_per_point_and_corner(grid, size, spacing, features):
    # Points along a ray (runs of equal cells), a part-full last warp, and
    # tables so small that corners of one point hash to one row.
    rng = np.random.RandomState(grid + features)
    origin, direction = rng.uniform(-0.5, 0.5, 3), rng.standard_normal(3)
    pts = (origin + spacing * direction / np.linalg.norm(direction) * np.arange(64)[:, None]).astype(np.float32)
    idx, _ = khash.hashgrid_corners_reference(t(pts), [grid], [size], (-1.0,) * 3, (1.0,) * 3, False)
    rows = idx[0].numpy()
    table_rows = min(grid**3, size)
    cells = np.floor((pts + 1.0) / 2.0 * (grid - 1)).astype(int)  # equal cells <=> equal rows here
    for warp, count in ((0, 32), (1, 20)):
        lanes = slice(32 * warp, 32 * warp + 32)
        active = np.arange(32) < count
        a = rng.randint(-9, 9, (32, 8)).astype(np.float64) * active[:, None]
        g = rng.randint(-9, 9, (32, features)).astype(np.float64) * active[:, None]
        got = dx_backward_warp(cells[lanes], rows[lanes], active, a, g, table_rows % 2 == 0, table_rows, features)
        want = np.zeros((table_rows, features))
        for lane in np.flatnonzero(active):
            np.add.at(want, rows[lanes][lane], a[lane][:, None] * g[lane][None, :])
        np.testing.assert_array_equal(got, want)
