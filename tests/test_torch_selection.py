"""The occupancy renderer's sample selection and pooled packing
(``learn_nerf_tpu_torch.kernels.selection``), port against learn_nerf_tpu.

* the plain selection (``select_strided_reference``, the CPU route of
  ``select_strided``) against the JAX package's ``_select_candidates`` and
  ``compact_occupied_strided``, jitted, fed JAX's uniforms: rays that miss
  the bbox, axis-aligned directions, a warmup grid, trained grids whose rays
  hold c < K, c = K, c = K + 1 and c = C occupied candidates, eps 0 and
  1e-2, and the span lever's range; masks, counts and the chosen candidates
  exactly, ts and dt within 1e-6;
* the strided ranks and the slots with no sample against a NumPy brute
  force over hypothesis-drawn occupancy rows;
* the plain pack (``pack_pool_reference``) against the JAX pooled pass's
  selected and dropped counts, the starts its sample mask implies and the
  pool rows it hands its model, with and without overflow; the kernel's
  plain version from the counts (``pack_pool_from_counts_reference``)
  against it on plain and block-word selections, dropping and not;
* the packed occupancy words the selection kernel reads
  (``pack_occupancy_words``): every cell's bit is ``d > threshold``, cells
  at the threshold included, at resolutions the block dims divide (the
  words equal ``pack_block_table``'s column 0) and at padded ones; the
  words a state caches (``OccupancyGrid.occupancy_words``) are built anew
  after a grid update, an in-place change to the densities, a new
  densities tensor, ``load`` and ``load_full``;
* the routing: CPU tensors take the plain versions (one plain call, no
  launch; the block-word lever counts its plain candidate test), other
  devices the launchers, which hand the C entry points the by-value
  scalars, pointers, shapes and dtypes they expect and the words of the
  state they are given (a fake library), the pack the selection's counts
  themselves (no scan before it), and the loud refusals (K > 64,
  non-contiguous or non-f32 operands, grids of 2^31 cells, budgets of
  2^31 rows).
"""

import contextlib
import types

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from learn_nerf_tpu import acceleration as jacc
from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu_torch import acceleration, occ_render
from learn_nerf_tpu_torch.kernels import build
from learn_nerf_tpu_torch.kernels import selection as ksel

from .test_torch_train import ray_batch
from .test_torch_train import port_loop as occupancy_loop
from .torch_helpers import t

torch.set_num_threads(1)

BBOX = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
R, C, K = 8, 24, 6
TOL = dict(rtol=1e-6, atol=1e-6)


def grid_densities(case, seed=0):
    """``[R^3]`` densities and the grid step of each case."""
    rng = np.random.RandomState(seed)
    c = (np.arange(R) + 0.5) / R * 2.0 - 1.0
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    if case == "warmup":  # nothing above the threshold, every cell occupied by the rule
        return np.zeros(R**3, np.float32), 0
    if case == "empty":
        return np.zeros(R**3, np.float32), 16
    if case == "full":
        return np.full(R**3, 3.0, np.float32), 16
    if case == "ball":
        return ((x**2 + y**2 + z**2 < 0.6**2) * rng.uniform(0.5, 4.0, x.shape)).astype(np.float32).reshape(-1), 16
    if case == "half":
        return ((rng.rand(R, R, R) < 0.5) * 3.0).astype(np.float32).reshape(-1), 16
    assert case == "opaque"  # dense enough that eps 1e-2 prunes
    return ((rng.rand(R, R, R) < 0.7) * rng.uniform(5.0, 60.0, (R, R, R))).astype(np.float32).reshape(-1), 16


CASES = ("warmup", "empty", "full", "ball", "half", "opaque")


def sample_rays(n=256, seed=1):
    """Rays from a shell around the bbox: most aimed into it, some aimed
    away (they miss), some axis-aligned (zero direction components, one
    of them -0.0)."""
    rng = np.random.RandomState(seed)
    origins = rng.randn(n, 3)
    origins = 3.0 * origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    targets = rng.uniform(-0.9, 0.9, (n, 3))
    dirs = targets - origins
    dirs[: n // 8] *= -1.0  # away from the box
    axis = np.arange(n // 8, n // 4)
    dirs[axis] = 0.0
    origins[axis] = rng.uniform(-0.8, 0.8, (len(axis), 3))
    origins[axis, axis % 3] = -2.0
    dirs[axis, axis % 3] = 1.0
    dirs[axis[0], 1] = -0.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return np.stack([origins, dirs], axis=1).astype(np.float32)


def grids(case):
    densities, step = grid_densities(case)
    j_grid = jacc.OccupancyGrid(resolution=R, **BBOX)
    j_state = j_grid.init().replace(densities=jnp.asarray(densities), step=jnp.asarray(step, jnp.int32))
    grid = acceleration.OccupancyGrid(resolution=R, **BBOX)
    return j_grid, j_state, grid, acceleration.OccupancyGridState(densities=t(densities), step=step)


def jax_selection(j_renderer, key, rays, j_state, eps):
    """The JAX package's candidate test and compaction, jitted: ``(cand_ts,
    occ, dt * delta_scale, mask, sel_ts, sel_mask)`` as NumPy arrays."""

    def run(key, rays, state):
        cand_ts, occ, dt, mask = j_renderer._select_candidates(key, rays, state, eps)
        sel_ts, sel_mask, scale = jacc.compact_occupied_strided(cand_ts, occ, j_renderer.samples)
        return cand_ts, occ, dt * scale, mask, sel_ts, sel_mask

    return [np.asarray(v) for v in jax.jit(run)(key, jnp.asarray(rays), j_state)]


def chosen(cand_ts, sel_ts):
    """The candidate each slot took: where its t equals a candidate's."""
    return np.argmax(np.asarray(cand_ts)[:, None, :] == np.asarray(sel_ts)[:, :, None], axis=-1)


def port_selection(renderer, rays, state, eps, u):
    sel = renderer._select(t(rays), state, eps, u, None, with_points=True)
    cand_ts, occ, _, _ = renderer._select_candidates(t(rays), state, eps, u=u)
    return sel, cand_ts, occ


@pytest.mark.parametrize("eps", [0.0, 1e-2])
@pytest.mark.parametrize("case", CASES)
def test_plain_selection_matches_jax(case, eps):
    j_grid, j_state, grid, state = grids(case)
    j = jocc.OccupancyRenderer(model=None, grid=j_grid, candidates=C, samples=K, **BBOX)
    port = occ_render.OccupancyRenderer(model=None, grid=grid, candidates=C, samples=K, **BBOX)
    rays, key = sample_rays(), jax.random.PRNGKey(5)
    cand_j, occ_j, dt_j, mask_j, ts_j, smask_j = jax_selection(j, key, rays, j_state, eps)
    u = t(jax.random.uniform(key, (len(rays), C)))
    plain = ksel.counter.plain_calls
    sel, cand_ts, occ = port_selection(port, rays, state, eps, u)
    assert ksel.counter.plain_calls == plain + 1
    np.testing.assert_array_equal(occ.numpy(), occ_j)
    np.testing.assert_array_equal(sel.mask.numpy(), mask_j)
    np.testing.assert_array_equal(sel.count.numpy(), occ_j.sum(axis=1))
    np.testing.assert_array_equal(sel.sample_mask.numpy(), smask_j)
    np.testing.assert_array_equal(chosen(cand_ts, sel.ts), chosen(cand_j, ts_j))
    np.testing.assert_allclose(sel.ts.numpy(), ts_j, **TOL)
    np.testing.assert_allclose(sel.dt.numpy(), dt_j, **TOL)
    np.testing.assert_allclose(sel.points.numpy(), rays[:, None, 0] + rays[:, None, 1] * ts_j[..., None], **TOL)
    assert sel.count.dtype == torch.int32 and sel.dt.shape == (len(rays), 1)
    assert not mask_j[: len(rays) // 8].any() and mask_j.any()  # the rays aimed away miss
    if case == "opaque" and eps > 0:  # the prune is on and cuts
        _, occ_off, _, _ = port._select_candidates(t(rays), state, 0.0, u=u)
        assert occ.sum() < occ_off.sum()


def test_the_cases_hold_every_count_that_matters():
    """Over the grids above (eps 0), rays hold c < K, c = K, c = K + 1 and
    c = C occupied candidates, and c = 0 on hit rays."""
    counts, hit_counts = set(), set()
    for case in CASES:
        _, _, grid, state = grids(case)
        rays = sample_rays()
        sel = ksel.select_strided_reference(t(rays), t(np.random.RandomState(2).rand(len(rays), C).astype(np.float32)),
                                            grid, state, K, 1e-3)
        counts |= set(sel.count.tolist())
        hit_counts |= set(sel.count[sel.mask].tolist())
    assert {0, K - 1, K, K + 1, C} <= counts and 0 in hit_counts


@pytest.mark.parametrize("eps", [0.0, 1e-2])
def test_span_range_matches_jax(eps):
    """With the span lever the kernel's range input is the span's; the
    plain route with that range against the JAX package's span selection."""
    r = 16
    j_grid = jacc.OccupancyGrid(resolution=r, **BBOX)
    grid = acceleration.OccupancyGrid(resolution=r, **BBOX)
    c = (np.arange(r) + 0.5) / r * 2.0 - 1.0
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    ball = (x - 0.5) ** 2 + (y - 0.4) ** 2 + (z + 0.5) ** 2 < 0.3**2  # the span misses most rays
    densities = (ball * np.random.RandomState(4).uniform(1.0, 40.0, ball.shape)).astype(np.float32).reshape(-1)
    j_state = j_grid.init().replace(densities=jnp.asarray(densities), step=jnp.asarray(16, jnp.int32))
    state = acceleration.OccupancyGridState(densities=t(densities), step=16)
    levers = dict(candidates=C, samples=K, span_candidates=16, span_pool_factor=4, **BBOX)
    j = jocc.OccupancyRenderer(model=None, grid=j_grid, **levers)
    port = occ_render.OccupancyRenderer(model=None, grid=grid, **levers)
    rays, key = sample_rays(seed=3), jax.random.PRNGKey(7)
    cand_j, occ_j, dt_j, mask_j, ts_j, smask_j = jax_selection(j, key, rays, j_state, eps)
    sel, cand_ts, occ = port_selection(port, rays, state, eps, t(jax.random.uniform(key, (len(rays), C))))
    span = port._span(t(rays), state, None)
    assert span is not None and not span[2].all() and span[2].any()
    np.testing.assert_array_equal(occ.numpy(), occ_j)
    np.testing.assert_array_equal(sel.mask.numpy(), mask_j)
    np.testing.assert_array_equal(sel.count.numpy(), occ_j.sum(axis=1))
    np.testing.assert_array_equal(sel.sample_mask.numpy(), smask_j)
    np.testing.assert_array_equal(chosen(cand_ts, sel.ts), chosen(cand_j, ts_j))
    np.testing.assert_allclose(sel.ts.numpy(), ts_j, **TOL)
    np.testing.assert_allclose(sel.dt.numpy(), dt_j, **TOL)


def brute_force(row, k):
    """Slot s takes the candidate of rank floor(s * max(c, K) / K): the
    (rank+1)-th occupied one, or where rank >= c (no sample) the last
    occupied one (candidate 0 when c = 0)."""
    occupied = np.flatnonzero(row)
    c = len(occupied)
    ranks = [s * max(c, k) // k for s in range(k)]
    index = [occupied[min(rank, c - 1)] if c else 0 for rank in ranks]
    return np.asarray(index), np.asarray([rank < c for rank in ranks]), c


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 12), st.lists(st.lists(st.booleans(), min_size=1, max_size=80), min_size=1, max_size=6))
def test_strided_ranks_and_empty_slots_match_a_brute_force(k, rows):
    width = max(len(r) for r in rows)
    occ = np.zeros((len(rows), width), bool)
    for i, row in enumerate(rows):
        occ[i, : len(row)] = row
    cand_ts = np.tile(np.arange(width, dtype=np.float32), (len(rows), 1))  # t = the candidate's index
    rays = torch.zeros((len(rows), 2, 3))
    sel = ksel.compact_reference(rays, t(cand_ts), t(occ), torch.ones(len(rows), 1), torch.ones(len(rows), dtype=torch.bool),
                                 k, with_points=False)
    for i, row in enumerate(occ):
        index, valid, c = brute_force(row, k)
        np.testing.assert_array_equal(sel.ts[i].numpy().astype(np.int64), index)
        np.testing.assert_array_equal(sel.sample_mask[i].numpy(), valid)
        assert sel.count[i] == c
        assert float(sel.dt[i]) == max(np.float32(c) / np.float32(k), 1.0)


class PoolModel:
    """A stand-in for the JAX pooled pass's field model: it keeps the pool
    rows the (jitted) pass hands it and returns zero density and colour."""

    def __init__(self):
        self.seen = []

    def apply(self, variables, points, dirs):
        jax.debug.callback(lambda p, d: self.seen.append((np.asarray(p), np.asarray(d))), points, dirs)
        n = points.shape[0]
        return jnp.zeros((n, 1)), jnp.zeros((n, 3)), {}


@pytest.mark.parametrize("budget", [64, 1024, 256 * K])
def test_plain_pack_matches_the_jax_pooled_pass(budget):
    """Budgets 64 and 1024 overflow (dropped > 0), 256 * K cannot."""
    _, j_state, grid, state = grids("half")
    model = PoolModel()
    j = jocc.OccupancyRenderer(model=model, grid=jacc.OccupancyGrid(resolution=R, **BBOX), candidates=C, samples=K,
                               **BBOX)
    port = occ_render.OccupancyRenderer(model=None, grid=grid, candidates=C, samples=K, **BBOX)
    rays, key = sample_rays(), jax.random.PRNGKey(9)
    ref = jax.jit(j.render_rays_pooled, static_argnums=(5,))(key, jnp.asarray(rays), None, jnp.zeros(3), j_state,
                                                              budget)
    jax.effects_barrier()
    _, _, _, _, _, smask_j = jax_selection(j, key, rays, j_state, 0.0)
    sel = port._select(t(rays), state, 0.0, t(jax.random.uniform(key, (len(rays), C))), None)
    plain = ksel.pack_counter.plain_calls
    pool = ksel.pool_pack(t(rays), sel, budget)
    assert ksel.pack_counter.plain_calls == plain + 1
    assert int(pool.selected) == int(ref["selected"]) and int(pool.dropped) == int(ref["dropped"])
    assert (int(pool.dropped) > 0) == (budget < 256 * K)
    counts = np.cumsum(smask_j.sum(axis=1))
    np.testing.assert_array_equal(pool.starts.numpy(), np.concatenate([[0], np.minimum(counts, budget)]))
    assert pool.starts.dtype == torch.int32 and pool.selected.dtype == pool.dropped.dtype == torch.int64
    points_j, dirs_j = model.seen[-1]
    np.testing.assert_array_equal(pool.dirs.numpy(), dirs_j)
    np.testing.assert_allclose(pool.points.numpy(), points_j, **TOL)
    # The tail: the last ray at t = 0.
    tail = slice(int(min(counts[-1], budget)), budget)
    assert (pool.ray[tail] == len(rays) - 1).all() and (pool.t[tail] == 0).all()


def test_cpu_routes_count_plain_calls_and_block_words_their_own():
    _, _, grid, state = grids("half")
    rays = t(sample_rays(64))
    u = t(np.random.RandomState(0).rand(64, C).astype(np.float32))
    for lever, select_calls, block_calls in ((0, 1, 0), (2, 0, 1)):
        renderer = occ_render.OccupancyRenderer(model=None, grid=grid, candidates=C, samples=K,
                                                block_gather_stride=lever, **BBOX)
        counts = (ksel.counter.plain_calls, ksel.counter.launches, occ_render.block_word_counter.plain_calls)
        demand = renderer.mean_sample_demand(rays, state, u=u)
        assert (ksel.counter.plain_calls - counts[0], ksel.counter.launches - counts[1],
                occ_render.block_word_counter.plain_calls - counts[2]) == (select_calls, 0, block_calls)
        sel = renderer._select(rays, state, 0.0, u, None)
        assert float(demand) == float(torch.clamp(sel.count, max=K).float().mean())


def test_card_routes_take_the_launchers(monkeypatch):
    """Meta tensors stand in for the card's: each wrapper hands them to its
    launcher (faked), never to its plain version; the selection gets the
    words a frame's tables built; the pack gets the selection's counts
    themselves, with no clamp or scan before it."""
    _, _, grid, _ = grids("half")
    seen = {}
    monkeypatch.setattr(ksel, "_cuda_launcher", lambda *args: seen.setdefault("select", args))
    monkeypatch.setattr(ksel, "_cuda_pack_launcher", lambda *args: seen.setdefault("pack", args))
    rays, u = torch.zeros((5, 2, 3), device="meta"), torch.zeros((5, C), device="meta")
    state = acceleration.OccupancyGridState(densities=torch.zeros(R**3, device="meta"), step=3)
    plain = (ksel.counter.plain_calls, ksel.pack_counter.plain_calls)
    ksel.select_strided(rays, u, grid, state, K, 1e-3, 1e-2, None, True)
    assert seen["select"] == (rays, u, grid, state, K, 1e-3, 1e-2, None, True, None)
    renderer = occ_render.OccupancyRenderer(model=None, grid=grid, candidates=C, samples=K, **BBOX)
    tables = renderer.selection_tables(state)
    assert set(tables) == {"words"} and tables["words"] is grid.occupancy_words(state)
    del seen["select"]
    renderer._select(rays, state, 0.0, u, None, tables)
    assert seen["select"][-1] is tables["words"]
    count = torch.zeros(5, dtype=torch.int32, device="meta")
    sel = ksel.Selection(torch.zeros((5, K), device="meta"), None, None, None, count, None)
    ksel.pool_pack(rays, sel, 17)
    _, ts, counts, budget = seen["pack"]
    assert ts is sel.ts and counts is count and budget == 17
    assert (ksel.counter.plain_calls, ksel.pack_counter.plain_calls) == plain


class FakeLibrary:
    """Records each entry point's arguments and returns success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if not name.startswith("nerf_"):
            raise AttributeError(name)
        return lambda *args: self.calls.setdefault(name, args) and 0


@contextlib.contextmanager
def fake_card(monkeypatch):
    """The launchers on CPU tensors, with the device checks, the stream and
    the library faked."""
    lib = FakeLibrary()
    monkeypatch.setattr(ksel, "_check_card_device", lambda device, *tensors: None)
    monkeypatch.setattr(build, "current_stream", lambda device: 1234)
    monkeypatch.setattr(build, "launch_context", lambda device: contextlib.nullcontext())
    yield lib


@pytest.mark.parametrize("warm,span,with_points", [(True, False, True), (False, True, False)])
def test_select_launcher_passes_scalars_by_value(monkeypatch, warm, span, with_points):
    grid = acceleration.OccupancyGrid(resolution=R, threshold=0.03, bbox_min=(-1.0, -2.0, -0.5),
                                      bbox_max=(1.0, 0.5, 1.5))
    state = acceleration.OccupancyGridState(densities=t(grid_densities("half")[0]), step=0 if warm else 16)
    batch = torch.zeros((7, 3, 3))  # the train step's batch[:, :2]: rows 9 floats apart
    rays, u = batch[:, :2], torch.rand(7, 20)
    spans = (torch.zeros(7), torch.ones(7), torch.ones(7, dtype=torch.bool)) if span else None
    with fake_card(monkeypatch) as lib:
        launches = ksel.counter.launches
        sel = ksel.launch_select_strided(rays, u, grid, state, 12, 2e-3, 1e-2, spans, with_points, lib=lib)
    args = lib.calls["nerf_select_strided"]
    assert ksel.counter.launches == launches + 1
    words = grid.occupancy_words(state)
    assert args[:5] == (rays.data_ptr(), 9, u.data_ptr(), words.data_ptr(), state.densities.data_ptr())
    assert torch.equal(words, acceleration.pack_occupancy_words(state.densities, R, 0.03)) and words.any()
    assert args[5:8] == (tuple(v.data_ptr() for v in spans) if span else (None, None, None))
    assert args[8:12] == (7, 20, 12, R)
    assert args[12:18] == (-1.0, -2.0, -0.5, 1.0, 0.5, 1.5)
    assert args[18:20] == (0.03, int(warm)) and args[20:22] == (2e-3, 1e-2)
    assert args[22:24] == (float(np.float32(1) / np.float32(20)), float(np.float32(1) / np.float32(12)))
    spans = (np.float32(2.0), np.float32(0.5) - np.float32(-2.0), np.float32(2.0))  # hi - lo in f32
    assert args[24:27] == tuple(float(np.float32(1) / s) for s in spans) == (0.5, float(np.float32(0.4)), 0.5)
    outs = [sel.ts, sel.sample_mask, sel.dt, sel.mask, sel.count]
    assert args[27:32] == tuple(v.data_ptr() for v in outs) and args[33] == 1234
    assert args[32] == (sel.points.data_ptr() if with_points else None)
    assert [(tuple(v.shape), v.dtype) for v in outs] == [
        ((7, 12), torch.float32), ((7, 12), torch.bool), ((7, 1), torch.float32), ((7,), torch.bool),
        ((7,), torch.int32)]
    assert (sel.points is not None) == with_points and len(args) == len(build_argtypes("nerf_select_strided"))


def test_pack_launcher_passes_scalars_by_value(monkeypatch):
    rays, ts = torch.zeros((5, 2, 3)), torch.zeros((5, 8))
    count = torch.tensor([1, 2, 0, 9, 3], dtype=torch.int32)  # not clamped: the kernel clamps to K = 8
    with fake_card(monkeypatch) as lib:
        pool = ksel.launch_pool_pack(rays, ts, count, 10, lib=lib)
    args = lib.calls["nerf_pool_pack"]
    assert args[:7] == (rays.data_ptr(), 6, ts.data_ptr(), count.data_ptr(), 5, 8, 10)
    assert args[7:14] == tuple(v.data_ptr() for v in pool) and args[14] == 1234
    assert [(tuple(v.shape), v.dtype) for v in pool] == [
        ((10,), torch.float32), ((10,), torch.int64), ((10, 3), torch.float32), ((10, 3), torch.float32),
        ((6,), torch.int32), ((), torch.int64), ((), torch.int64)]
    assert len(args) == len(build_argtypes("nerf_pool_pack"))


def build_argtypes(name):
    """The argument types ``build.bind_selection`` gives an entry point."""
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in ("nerf_select_strided", "nerf_pool_pack")})
    return getattr(build.bind_selection(lib), name).argtypes


@pytest.mark.parametrize("fault,message", [
    ("K > 64", "1 to 64 samples"), ("non-contiguous u", "contiguous uniforms"), ("f64 u", "f32 uniforms"),
    ("f64 rays", "f32 rays"), ("strided rays", "rows are contiguous"), ("pack K > 64", "1 to 64 samples"),
    ("pack int64 scan", "int32"), ("pack non-contiguous ts", "contiguous ts"),
    ("grid of 2^31 cells", "fewer than 2\\^31 cells"), ("pack budget of 2^31", "budget under 2\\^31"),
    ("pack counts of another shape", "int32 \\[4\\] counts"), ("pack non-contiguous counts", "contiguous ts and counts"),
    ("a bbox side of 2^-61", "sides in"), ("words of another grid", "contiguous int32 words"),
    ("int64 words", "contiguous int32 words")])
def test_launchers_refuse_what_the_kernels_do_not_take(fault, message):
    grid = acceleration.OccupancyGrid(resolution=R, **BBOX)
    state = acceleration.OccupancyGridState(densities=torch.zeros(R**3, device="meta"), step=16)
    rays, u = torch.zeros((4, 2, 3), device="meta"), torch.zeros((4, C), device="meta")
    k, ts, cum = K, torch.zeros((4, K), device="meta"), torch.zeros(4, dtype=torch.int32, device="meta")
    budget = 8
    words = None
    if fault == "words of another grid":
        words = torch.zeros(ksel.word_count(2 * R), dtype=torch.int32, device="meta")
    elif fault == "int64 words":
        words = torch.zeros(ksel.word_count(R), dtype=torch.int64, device="meta")
    elif fault == "a bbox side of 2^-61":
        grid = acceleration.OccupancyGrid(resolution=R, bbox_min=(0.0, 0.0, 0.0), bbox_max=(1.0, 2.0**-61, 1.0))
    elif fault == "grid of 2^31 cells":
        grid = acceleration.OccupancyGrid(resolution=1291, **BBOX)
    elif fault == "pack budget of 2^31":
        budget = 1 << 31
    elif fault == "pack counts of another shape":
        cum = torch.zeros(5, dtype=torch.int32, device="meta")
    elif fault == "pack non-contiguous counts":
        cum = torch.zeros(8, dtype=torch.int32, device="meta")[::2]
    elif fault == "K > 64":
        k = 65
    elif fault == "non-contiguous u":
        u = torch.zeros((C, 4), device="meta").t()
    elif fault == "f64 u":
        u = u.double()
    elif fault == "f64 rays":
        rays = rays.double()
    elif fault == "strided rays":
        rays = torch.zeros((4, 3, 2), device="meta").transpose(1, 2)
    elif fault == "pack K > 64":
        ts = torch.zeros((4, 65), device="meta")
    elif fault == "pack int64 scan":
        cum = cum.long()
    else:
        ts = torch.zeros((K, 4), device="meta").t()
    with pytest.raises(ValueError, match=message):
        if fault.startswith("pack"):
            ksel.launch_pool_pack(rays, ts, cum, budget)
        else:
            ksel.launch_select_strided(rays, u, grid, state, k, 1e-3, words=words)


def test_selection_refuses_rays_that_require_grad():
    _, _, grid, state = grids("half")
    rays = t(sample_rays(4)).requires_grad_()
    with pytest.raises(NotImplementedError, match="no gradient"):
        ksel.select_strided(rays, torch.rand(4, C), grid, state, K, 1e-3)


def word_bits(words, grid, points):
    """Each point's cell bit in packed words, read as the selection kernel
    reads it (:meth:`OccupancyGrid.block_indices`)."""
    widx, bit = grid.block_indices(points)
    return ((words.to(torch.int64)[widx] >> bit) & 1).bool()


def threshold_densities(r, threshold, seed=0):
    """``[r^3]`` densities: a third of the cells exactly at the threshold
    (not occupied), a third just above it, the rest random."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.0, 2.0 * threshold, r**3).astype(np.float32)
    pick = rng.randint(0, 3, r**3)
    d[pick == 0] = np.float32(threshold)
    d[pick == 1] = np.nextafter(np.float32(threshold), np.float32(1.0))
    return d


@pytest.mark.parametrize("r", [8, 16, 128])
def test_occupancy_words_hold_each_cells_bit(r):
    """Every cell's bit is d > threshold, cells at the threshold clear, and
    the words are pack_block_table's column 0."""
    threshold = 0.01
    d = threshold_densities(r, threshold)
    grid = acceleration.OccupancyGrid(resolution=r, threshold=threshold, **BBOX)
    words = acceleration.pack_occupancy_words(t(d), r, threshold)
    assert words.dtype == torch.int32 and words.shape == (r**3 // 32,) == (ksel.word_count(r),)
    assert words.is_contiguous()
    ids = torch.arange(r**3)
    centres = grid.cell_positions(ids, torch.full((r**3, 3), 0.5))
    assert torch.equal(grid.cell_indices(centres), ids)
    np.testing.assert_array_equal(word_bits(words, grid, centres).numpy(), d > np.float32(threshold))
    assert (d == np.float32(threshold)).any() and (d > np.float32(threshold)).any()
    table = acceleration.pack_block_table(t(d), r, threshold)
    assert torch.equal(table.view(torch.int32)[:, 0], words)


@pytest.mark.parametrize("r", [5, 6, 10])
def test_padded_words_select_as_the_densities_do(r, monkeypatch):
    """A resolution the block dims do not divide: the words are padded to
    whole words (the one route), every cell's bit is still d > threshold,
    the candidate test read from the words equals the plain one, and the
    launcher hands the C entry point the padded words."""
    threshold = 0.01
    d = threshold_densities(r, threshold, seed=r)
    grid = acceleration.OccupancyGrid(resolution=r, threshold=threshold, **BBOX)
    state = acceleration.OccupancyGridState(densities=t(d), step=16)
    words = grid.occupancy_words(state)
    assert words.shape == (((r + 3) // 4) ** 2 * ((r + 1) // 2),) == (ksel.word_count(r),)
    ids = torch.arange(r**3)
    centres = grid.cell_positions(ids, torch.full((r**3, 3), 0.5))
    np.testing.assert_array_equal(word_bits(words, grid, centres).numpy(), d > np.float32(threshold))
    rays = t(sample_rays(64))
    u = t(np.random.RandomState(r).rand(64, C).astype(np.float32))
    cand_ts, occ, _, mask = ksel.select_candidates_reference(rays, u, grid, state, 1e-3)
    points = rays[:, None, 0] + rays[:, None, 1] * cand_ts[..., None]
    assert torch.equal(word_bits(words, grid, points) & mask[:, None], occ) and occ.any()
    with fake_card(monkeypatch) as lib:
        ksel.launch_select_strided(rays, u, grid, state, K, 1e-3, lib=lib)
    assert lib.calls["nerf_select_strided"][3] == words.data_ptr()


def test_a_state_caches_its_words_and_builds_them_again_when_the_densities_change():
    grid = acceleration.OccupancyGrid(resolution=R, threshold=0.01, **BBOX)
    densities = t(threshold_densities(R, 0.01))
    state = acceleration.OccupancyGridState(densities=densities, step=16)
    words = grid.occupancy_words(state)
    assert grid.occupancy_words(state) is words  # cached: built once per state
    fresh = lambda: acceleration.pack_occupancy_words(state.densities, R, 0.01)  # noqa: E731
    with torch.no_grad():
        state.densities.copy_(t(threshold_densities(R, 0.01, seed=1)))  # in place
    assert not torch.equal(words, fresh()) and torch.equal(grid.occupancy_words(state), fresh())
    words = grid.occupancy_words(state)
    state.densities.mul_(0.0)
    assert torch.equal(grid.occupancy_words(state), fresh()) and not grid.occupancy_words(state).any()
    state.densities = t(threshold_densities(R, 0.01, seed=2))  # another tensor
    assert torch.equal(grid.occupancy_words(state), fresh()) and grid.occupancy_words(state).any()
    other = acceleration.OccupancyGrid(resolution=R, threshold=0.02, **BBOX)  # another threshold
    assert torch.equal(other.occupancy_words(state), acceleration.pack_occupancy_words(state.densities, R, 0.02))
    with torch.inference_mode():  # no version to key on: built at every call
        state.densities = t(threshold_densities(R, 0.01, seed=3)).clone()
        first = grid.occupancy_words(state)
        state.densities.mul_(0.0)
    assert first.any() and not grid.occupancy_words(state).any()


class StubModel(torch.nn.Module):
    """A field whose density is ``level`` everywhere."""

    def __init__(self, level):
        super().__init__()
        self.level = level

    def forward(self, points, dirs):
        return torch.full_like(points[..., :1], self.level), torch.zeros_like(points)


def test_the_words_follow_the_grid_through_update_load_and_load_full(tmp_path, monkeypatch):
    """Each place that sets a grid state gets that state's words with no
    code of its own: a refresh, ``load`` and ``load_full``; and the
    launcher, faked, is handed the words of the state it is given."""
    grid = acceleration.OccupancyGrid(resolution=R, threshold=0.01, warmup_updates=0, **BBOX)
    state = acceleration.OccupancyGridState(densities=torch.zeros(R**3), step=1)
    assert not grid.occupancy_words(state).any()
    updated = grid.update(state, StubModel(1.0))
    assert grid.occupancy_words(updated).all() and not grid.occupancy_words(state).any()
    rays, u = t(sample_rays(64)), torch.rand(64, C)
    with fake_card(monkeypatch) as lib:
        for s in (state, updated, state):
            ksel.launch_select_strided(rays, u, grid, s, K, 1e-3, lib=lib)
            assert lib.calls.pop("nerf_select_strided")[3] == grid.occupancy_words(s).data_ptr()

    def loop():
        return occupancy_loop(update_interval=1, update_cells=None, grid_warmup_updates=1)

    trained = loop()
    for s in range(2):
        trained.step_auto(0, ray_batch(s))
    # A grid that culls, as training's would in time.
    r = trained.grid.resolution
    trained.grid_state = acceleration.OccupancyGridState(
        densities=t(threshold_densities(r, trained.grid.threshold)), step=trained.grid_state.step)
    expect = acceleration.pack_occupancy_words(trained.grid_state.densities, trained.grid.resolution,
                                               trained.grid.threshold)
    for save, load in (("save", "load"), ("save_full", "load_full")):
        path = str(tmp_path / f"{save}.bin")
        getattr(trained, save)(path)
        other = loop()
        before = other.grid.occupancy_words(other.grid_state)
        assert not torch.equal(before, expect)
        getattr(other, load)(path)
        assert torch.equal(other.grid.occupancy_words(other.grid_state), expect)


@pytest.mark.parametrize("lever", [0, 2])
@pytest.mark.parametrize("budget", [40, 256 * K])
def test_the_packs_plain_version_from_counts_is_the_pack_of_the_mask(lever, budget):
    """The kernel's plain version takes the selection's counts, not its
    sample mask: on plain and block-word selections (lever 2), at a budget
    that drops and one that cannot, it equals pack_pool_reference."""
    _, _, grid, state = grids("half")
    renderer = occ_render.OccupancyRenderer(model=None, grid=grid, candidates=C, samples=K,
                                            block_gather_stride=lever, **BBOX)
    rays = t(sample_rays())
    sel = renderer._select(rays, state, 0.0, t(np.random.RandomState(3).rand(len(rays), C).astype(np.float32)), None)
    k = torch.arange(K)[None, :]
    assert torch.equal(sel.sample_mask, k < torch.clamp(sel.count, max=K)[:, None])
    got = ksel.pack_pool_from_counts_reference(rays, sel.ts, sel.count, budget)
    want = ksel.pack_pool_reference(rays, sel.ts, sel.sample_mask, budget)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (int(got.dropped) > 0) == (budget < 256 * K) and int(got.selected) == int(sel.sample_mask.sum())


def rn32(value):
    """An exact rational rounded to the nearest f32, ties to even (normal
    range)."""
    from fractions import Fraction

    value = Fraction(value)
    if value == 0:
        return Fraction(0)
    sign, value = (-1, -value) if value < 0 else (1, value)
    exponent = value.numerator.bit_length() - value.denominator.bit_length()
    if Fraction(2) ** exponent > value:
        exponent -= 1
    scaled = value / Fraction(2) ** (exponent - 23)  # in [2^23, 2^24)
    whole = scaled.numerator // scaled.denominator
    rest = scaled - whole
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and whole % 2):
        whole += 1
    return sign * Fraction(whole) * Fraction(2) ** (exponent - 23)


@pytest.mark.parametrize("span", [1.4, 2.0, 0.3, 7.77, 1000.1])
def test_the_kernels_division_is_the_rounded_quotient(span):
    """select_strided_kernel's ``divide``: from the wrapper's f32 reciprocal
    of the span, ``q = x * inv`` and two residual steps ``q + (x - q span)
    inv``, each an f32 FMA, give the f32 quotient ``x / span`` rounded to
    nearest, as PyTorch's division does (exact rationals here; on the card
    chip_smoke holds the kernel bit for bit)."""
    from fractions import Fraction

    rng = np.random.RandomState(int(span * 100))
    s = Fraction(float(np.float32(span)))
    grid = acceleration.OccupancyGrid(resolution=8, bbox_min=(0.0, 0.0, 0.0), bbox_max=(float(s),) * 3)
    inv = Fraction(ksel._span_reciprocals(grid)[0])
    assert inv == rn32(1 / s)
    xs = np.concatenate([(rng.uniform(-4, 4, 1500) * span).astype(np.float32),
                         (rng.choice([-1, 1], 500) * 2.0 ** rng.uniform(-99, 99, 500)).astype(np.float32),
                         np.float32(span) * np.arange(-8, 9, dtype=np.float32)])
    for x in map(Fraction, xs.tolist()):
        q = rn32(x * inv)
        for _ in range(2):
            q = rn32(rn32(x - q * s) * inv + q)
        assert q == rn32(x / s), float(x)
    assert ksel._span_reciprocals(acceleration.OccupancyGrid(resolution=8, bbox_min=(-0.7,) * 3, bbox_max=(0.7,) * 3)) \
        == (float(np.float32(1) / (np.float32(0.7) - np.float32(-0.7))),) * 3
