"""The occupancy renderer's selection levers, port against learn_nerf_tpu:
two-phase span selection and the block-word gathers.

* the tables bit for bit (``pack_block_table`` on grids whose words are NaN
  and denormal bit patterns as floats, ``superpool_densities``,
  ``dilate_supercells``, ``block_indices``, ``_bracketed_block_words``,
  ``selection_tables``);
* the span: ``hit`` and the first and last occupied probe bins exactly,
  ``t_lo``/``t_hi`` within 1e-6;
* candidate selection and whole frames (fixed-K, pooled; the fused route
  in bf16 at the fused route's bound) with JAX's uniforms, at 1e-5;
* the JAX package's own span and block-word tests (tests/test_occupancy.py)
  run against the port: single-cell find, corner-grazing chord, anisotropic
  bbox, stride-1 identity, widening at stride 4, the undersized probe
  count, and both block-word paths in warmup;
* ``include_depth_outputs`` of both frame functions.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu import acceleration as jacc
from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu import render as jrender
from learn_nerf_tpu.models import NeRFModel as FlaxNeRFModel
from learn_nerf_tpu.ops.geometry import ray_bbox_range as j_ray_bbox_range
from learn_nerf_tpu_torch import acceleration, occ_render, render
from learn_nerf_tpu_torch.checkpoint import load_params_pickle
from learn_nerf_tpu_torch.kernels import fused_render as fr
from learn_nerf_tpu_torch.ops.geometry import ray_bbox_range

from .torch_helpers import port_model, t

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
F32 = dict(rtol=1e-5, atol=1e-5)
CUBE = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
FLAT = dict(bbox_min=(-1.0, -1.0, -0.25), bbox_max=(1.0, 1.0, 0.25))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref, np.float32), **(tol or F32))


def bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def grids(r, densities, bbox=CUBE, step=None):
    """The same grid and state in both packages (past warmup unless
    ``step`` says otherwise)."""
    j_grid = jacc.OccupancyGrid(resolution=r, **bbox)
    grid = acceleration.OccupancyGrid(resolution=r, **bbox)
    step = grid.warmup_updates if step is None else step
    j_state = j_grid.init().replace(densities=jnp.asarray(densities), step=jnp.asarray(step, jnp.int32))
    state = acceleration.OccupancyGridState(densities=t(densities), step=step)
    return j_grid, j_state, grid, state


def renderers(j_grid, grid, model=(None, None), bbox=CUBE, **levers):
    j_model, model = model
    j = jocc.OccupancyRenderer(model=j_model, grid=j_grid, **bbox, **levers)
    return j, occ_render.OccupancyRenderer(model=model, grid=grid, **bbox, **levers)


def rays_into_bbox(n, seed=3):
    """tests/test_occupancy.py's ``_rays_into_bbox``: from z = -3 into the
    bbox."""
    rng = np.random.RandomState(seed)
    rng.randn(n, 3)  # the origins that helper draws first
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.tile(np.asarray([[0.0, 0.0, -3.0]], np.float32), (n, 1))
    return np.stack([origins, dirs.astype(np.float32)], axis=1)


def word_grid(r, pattern, seed=0):
    """Densities whose packed words are given bit patterns: ``upper`` fills
    the z = 1 half of some blocks (words 0xFFFF0000: NaN as floats),
    ``lower`` a few cells of the z = 0 half (exponent 0: denormals),
    ``full`` every cell, ``blobs`` three small balls, ``random`` a sparse
    random grid."""
    rng = np.random.RandomState(seed)
    cube = np.zeros((r, r, r), np.float32)  # [z, y, x]
    if pattern == "upper":
        cube[1::2] = rng.rand(r // 2, r, r) < 0.7
        cube[1::2, : r // 2] = 1.0
    elif pattern == "lower":
        cube[0::2, 0::4, 0::4] = 1.0
        cube[0::2, 1::4, 1::4] = rng.rand(r // 2, r // 4, r // 4) < 0.5
    elif pattern == "full":
        cube[:] = 1.0
    elif pattern == "blobs":
        c = (np.arange(r) + 0.5) / r * 2.0 - 1.0
        z, y, x = np.meshgrid(c, c, c, indexing="ij")
        for center in rng.uniform(-0.4, 0.4, (3, 3)):
            ball = (x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2 < 0.25**2
            cube[ball] = rng.uniform(0.5, 2.0)
    else:
        cube = (rng.rand(r, r, r) < 0.08).astype(np.float32) * rng.uniform(0.5, 2.0, (r, r, r)).astype(np.float32)
    return cube.reshape(-1)


@pytest.mark.parametrize("r,pattern", [(16, "random"), (32, "random"), (16, "upper"), (16, "lower"), (8, "full")])
def test_pack_block_table_bits_equal_jax(r, pattern):
    densities = word_grid(r, pattern)
    ref = jacc.pack_block_table(jnp.asarray(densities), r, 0.5)
    out = acceleration.pack_block_table(t(densities), r, 0.5)
    assert out.dtype == torch.float32 and out.shape == (r**3 // 32, 2)
    np.testing.assert_array_equal(bits(out.numpy()), bits(ref))
    words = bits(out.numpy())[:, 0]
    f = words.view(np.float32)
    if pattern == "upper":
        assert np.isnan(f).any()  # the words the table must carry intact
    if pattern == "lower":
        assert ((words != 0) & (np.abs(f) < np.finfo(np.float32).tiny)).any()
    if pattern == "full":
        assert (words == 0xFFFFFFFF).all()


def test_pack_block_table_refuses_a_resolution_the_blocks_do_not_tile():
    with pytest.raises(ValueError, match="not divisible"):
        acceleration.pack_block_table(torch.zeros(10**3), 10, 0.5)


@pytest.mark.parametrize("r,factor", [(16, 4), (32, 8), (24, 2)])
def test_superpool_and_dilate_equal_jax(r, factor):
    densities = word_grid(r, "random", seed=r)
    rs = r // factor
    ref = jacc.superpool_densities(jnp.asarray(densities), r, factor)
    out = acceleration.superpool_densities(t(densities), r, factor)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        acceleration.dilate_supercells(out, rs).numpy(), np.asarray(jacc.dilate_supercells(ref, rs)))


@pytest.mark.parametrize("r,bbox", [(16, CUBE), (32, FLAT)])
def test_block_indices_equal_jax(r, bbox):
    rng = np.random.RandomState(r)
    x = rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32)  # some beyond the bbox
    j_grid = jacc.OccupancyGrid(resolution=r, **bbox)
    grid = acceleration.OccupancyGrid(resolution=r, **bbox)
    for port, ref in zip(grid.block_indices(t(x)), j_grid.block_indices(jnp.asarray(x))):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("stride", [1, 2, 3, 4])
def test_bracketed_block_words_equal_jax(stride):
    r = 16
    densities = word_grid(r, "upper", seed=stride)
    table = acceleration.pack_block_table(t(densities), r, 0.5)
    grid = acceleration.OccupancyGrid(resolution=r, **CUBE)
    rays = rays_into_bbox(24, seed=stride)
    ts = np.linspace(2.0, 4.0, 37, dtype=np.float32)
    pts = rays[:, None, 0] + rays[:, None, 1] * ts[None, :, None]
    widx, bit = grid.block_indices(t(pts))
    ref = jocc._bracketed_block_words(jnp.asarray(widx.numpy()), jnp.asarray(bit.numpy()),
                                      jnp.asarray(table.numpy()), stride)
    out = occ_render._bracketed_block_words(widx, bit, table, stride)
    for port, jax_value in zip(out, ref):
        np.testing.assert_array_equal(port.numpy(), np.asarray(jax_value))
    assert out[0].any()
    if stride == 1:  # every column is its own probe
        assert out[2].all()


LEVER_SETS = {
    "none": {},
    "block": dict(block_gather_stride=4),
    "span": dict(span_candidates=64),
    "span block": dict(span_candidates=64, span_block_gather=2),
    "all": dict(span_candidates=64, block_gather_stride=1, span_block_gather=4),
    "span, factor not dividing": dict(span_candidates=64, span_pool_factor=5),
}


@pytest.mark.parametrize("levers", list(LEVER_SETS))
def test_selection_tables_equal_jax(levers):
    r = 64
    j_grid, j_state, grid, state = grids(r, word_grid(r, "random", seed=5))
    j, port = renderers(j_grid, grid, **LEVER_SETS[levers])
    ref, out = j.selection_tables(j_state), port.selection_tables(state)
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(bits(out[key].numpy()), bits(ref[key]))


def _spans(renderer, rays, state, bbox, jax_side):
    lo, hi = bbox["bbox_min"], bbox["bbox_max"]
    if jax_side:
        r = jnp.asarray(rays)
        t_min, t_max, _ = j_ray_bbox_range(r[:, 0], r[:, 1], jnp.asarray(lo), jnp.asarray(hi))
        out = renderer._occupied_span(r[:, 0], r[:, 1], t_min, t_max, state)
        return [np.asarray(v) for v in (*out, t_min, t_max)]
    r = t(rays)
    t_min, t_max, _ = ray_bbox_range(r[:, 0], r[:, 1], torch.tensor(lo), torch.tensor(hi))
    out = renderer._occupied_span(r[:, 0], r[:, 1], t_min, t_max, state)
    return [v.numpy() for v in (*out, t_min, t_max)]


@pytest.mark.parametrize("case", [
    dict(r=32, span_candidates=32, span_pool_factor=4, span_block_gather=0),
    dict(r=64, span_candidates=32, span_pool_factor=8, span_block_gather=0),
    dict(r=64, span_candidates=32, span_pool_factor=8, span_block_gather=1),
    dict(r=64, span_candidates=40, span_pool_factor=8, span_block_gather=4),
    dict(r=32, span_candidates=96, span_pool_factor=4, span_block_gather=3, bbox="flat"),
], ids=["per-cell 32/4", "per-cell 64/8", "block words 1", "block words 4", "flat bbox, block words 3"])
def test_occupied_span_matches_jax(case):
    case = dict(case)
    r, bbox = case.pop("r"), FLAT if case.pop("bbox", None) == "flat" else CUBE
    j_grid, j_state, grid, state = grids(r, word_grid(r, "blobs", seed=r), bbox)
    j, port = renderers(j_grid, grid, bbox=bbox, candidates=96, samples=16, **case)
    rays = rays_into_bbox(128, seed=5)
    lo, hi, hit, t_min, t_max = _spans(port, rays, state, bbox, False)
    jlo, jhi, jhit, _, _ = _spans(j, rays, j_state, bbox, True)
    np.testing.assert_array_equal(hit, jhit)
    assert 0 < hit.sum() < hit.size
    np.testing.assert_allclose(lo, jlo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(hi, jhi, rtol=0, atol=1e-6)
    # The first and last occupied probe bins, where the pad does not clip.
    w = (t_max - t_min) / case["span_candidates"]
    for a, b, edge, sign in ((lo, jlo, t_min, 1.0), (hi, jhi, t_max, -1.0)):
        free = hit & (np.abs(a - edge) > 1e-5)
        np.testing.assert_array_equal(np.rint((a[free] - t_min[free]) / w[free]),
                                      np.rint((b[free] - t_min[free]) / w[free]))
        assert free.any()


SELECTIONS = {
    "span": dict(span_candidates=64),
    "span, block words 4": dict(span_candidates=64, span_block_gather=4),
    "block words 1": dict(block_gather_stride=1),
    "block words 3": dict(block_gather_stride=3),
    "all": dict(span_candidates=64, span_block_gather=2, block_gather_stride=4),
}


@pytest.mark.parametrize("eps", [0.0, 0.5])
@pytest.mark.parametrize("levers", list(SELECTIONS))
def test_select_candidates_matches_jax(levers, eps):
    r = 64
    j_grid, j_state, grid, state = grids(r, word_grid(r, "blobs", seed=9))
    j, port = renderers(j_grid, grid, candidates=48, samples=8, **SELECTIONS[levers])
    rays = rays_into_bbox(96, seed=7)
    key = jax.random.PRNGKey(3)
    ref = j._select_candidates(key, jnp.asarray(rays), j_state, eps, tables=j.selection_tables(j_state))
    out = port._select_candidates(t(rays), state, eps, u=t(jax.random.uniform(key, (96, 48))),
                                  tables=port.selection_tables(state))
    close(out[0], ref[0])
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    close(out[2], ref[2])
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert 0 < out[1].sum() < out[1].numel()


@pytest.fixture(scope="module")
def small_models():
    """tests/test_occupancy.py's ``_small_model_and_params`` in both packages,
    the port's in f32 and in bf16."""
    flax_model = FlaxNeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)
    zeros = jnp.zeros((1, 3))
    params = jax.device_get(flax_model.init(dict(params=jax.random.PRNGKey(0)), zeros, zeros)["params"])
    ports = {dtype: port_model(params, dtype, input_layers=1, mid_layers=1) for dtype in ("float32", "bfloat16")}
    return flax_model, params, ports


def _frame_uniforms(key, tiles, tile_size, candidates):
    return t(np.stack([np.asarray(jax.random.uniform(k, (tile_size, candidates)))
                       for k in jax.random.split(key, tiles)]))


FRAME_LEVERS = {
    "span": dict(span_candidates=64),
    "block words 2": dict(block_gather_stride=2),
    "span and block words 4": dict(span_candidates=64, span_block_gather=4, block_gather_stride=4),
}


@pytest.mark.parametrize("depth", [False, True], ids=["outputs", "depth outputs"])
@pytest.mark.parametrize("path", ["fixed-K", "pooled", "fused"])
@pytest.mark.parametrize("levers", list(FRAME_LEVERS))
def test_frames_with_levers_match_jax(small_models, levers, path, depth):
    """Whole frames with each lever against learn_nerf_tpu's, each tile
    fed JAX's uniforms: 1e-5 in f32.  The fused route runs the bf16 model
    (held to JAX's f32 frame at the fused route's bound of
    tests/test_torch_render.py, 2e-2) and takes render_rays for depth."""
    flax_model, params, ports = small_models
    r = 64
    j_grid, j_state, grid, state = grids(r, word_grid(r, "blobs", seed=13) * 2.0)
    dtype = "bfloat16" if path == "fused" else "float32"
    j, port = renderers(j_grid, grid, (flax_model, ports[dtype]), candidates=48, samples=12,
                        **FRAME_LEVERS[levers])
    rays = rays_into_bbox(100, seed=11)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    budget = 6.0 if path == "pooled" else None
    key = jax.random.PRNGKey(7)
    ref = jocc.render_frame_occupancy(j, key, jnp.asarray(rays), params, jnp.asarray(bg), j_state,
                                      tile_size=32, budget_per_ray=budget, transmittance_eps=1e-2,
                                      include_depth_outputs=depth)
    fr.counter.reset()
    with torch.no_grad():
        out = occ_render.render_frame_occupancy(port, t(rays), t(bg), state, tile_size=32,
                                                budget_per_ray=budget, transmittance_eps=1e-2,
                                                uniforms=_frame_uniforms(key, 4, 32, 48),
                                                include_depth_outputs=depth)
    assert fr.counter.plain_calls == (4 if path == "fused" and not depth else 0)
    assert set(out) == set(ref)
    tol = dict(rtol=0, atol=2e-2) if path == "fused" else F32
    for k in ("outputs", "alphas", "coords"):
        if k in ref:
            assert out[k].shape == ref[k].shape
            close(out[k], ref[k], **tol)
    if path == "pooled":
        assert int(out["dropped"]) == int(ref["dropped"]) and int(out["selected"]) == int(ref["selected"])


def test_hierarchy_frame_depth_outputs_match_jax():
    """render_frame's ``alphas``/``coords`` (the fine pass's) against
    learn_nerf_tpu.render.render_frame's, each tile fed JAX's coarse and
    fine uniforms, at the bounds of tests/test_torch_render.py's golden
    hierarchy test."""
    params = load_params_pickle(os.path.join(GOLDEN, "vanilla_params.pkl"))
    hierarchy = dict(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3, coarse_ts=6, fine_ts=5)
    j = jrender.Renderer(coarse=FlaxNeRFModel(hidden_dim=32, color_layer_dim=16),
                         fine=FlaxNeRFModel(hidden_dim=48, color_layer_dim=16), **hierarchy)
    port = render.Renderer(coarse=port_model(params["coarse"]), fine=port_model(params["fine"]), **hierarchy)
    rng = np.random.RandomState(0)
    origins = rng.randn(45, 3).astype(np.float32) * 2
    dirs = -origins + rng.randn(45, 3).astype(np.float32) * 0.3
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = np.stack([origins, dirs], axis=1)
    bg = np.array([0.2, -0.1, 0.4], np.float32)
    key = jax.random.PRNGKey(9)
    ref = jrender.render_frame(j, key, jnp.asarray(rays), params["coarse"], params["fine"], jnp.asarray(bg),
                               tile_size=16, include_depth_outputs=True)
    uniforms = []
    for k in jax.random.split(key, 3):
        coarse_key, fine_key = jax.random.split(k)
        uniforms.append((t(jax.random.uniform(coarse_key, (16, 6))), t(jax.random.uniform(fine_key, (16, 5)))))
    with torch.no_grad():
        frame = render.render_frame(port, t(rays), t(bg), tile_size=16, uniforms=uniforms, include_depth_outputs=True)
        plain = render.render_frame(port, t(rays), t(bg), tile_size=16, uniforms=uniforms)
    assert set(frame) == set(ref) == {"outputs", "alphas", "coords"} and set(plain) == {"outputs"}
    assert frame["alphas"].shape == (45, 1) and frame["coords"].shape == (45, 3)
    close(frame["outputs"], ref["outputs"], rtol=1e-4, atol=1e-5)
    close(frame["alphas"], ref["alphas"], rtol=1e-4, atol=1e-5)
    close(frame["coords"], ref["coords"], rtol=1e-4, atol=1e-4)
    assert torch.equal(plain["outputs"], frame["outputs"])


@pytest.mark.parametrize("budget", [None, "auto"])
def test_frame_session_returns_depth_outputs(small_models, budget):
    flax_model, params, ports = small_models
    _, _, grid, state = grids(32, word_grid(32, "random", seed=2) * 2.0)
    port = occ_render.OccupancyRenderer(model=ports["float32"], grid=grid, candidates=48, samples=12,
                                        span_candidates=64, span_pool_factor=4, block_gather_stride=2, **CUBE)
    rays = t(rays_into_bbox(70, seed=1))
    outs = {}
    for depth in (False, True):
        session = occ_render.OccupancyFrameSession(port, torch.zeros(3), state, tile_size=32, budget_cfg=budget,
                                                   include_depth_outputs=depth)
        with torch.no_grad():
            outs[depth] = session.render(rays, torch.Generator().manual_seed(0))
    assert "alphas" not in outs[False] and outs[True]["alphas"].shape == (70, 1)
    assert outs[True]["coords"].shape == (70, 3)
    torch.testing.assert_close(outs[True]["outputs"], outs[False]["outputs"], rtol=0, atol=0)
    assert ((outs[True]["alphas"] >= 0) & (outs[True]["alphas"] <= 1)).all()


# The JAX package's span and block-word tests (tests/test_occupancy.py),
# run against the port.


def test_two_phase_span_finds_single_cell():
    """A single occupied cell anywhere in the grid survives two-phase
    selection."""
    r = 32
    grid = acceleration.OccupancyGrid(resolution=r, **CUBE)
    renderer = occ_render.OccupancyRenderer(model=None, grid=grid, candidates=96, samples=16, span_candidates=64,
                                            span_pool_factor=8, **CUBE)
    rng = np.random.RandomState(4)
    for trial in range(6):
        cell = rng.randint(0, r, size=3)
        densities = np.zeros(r**3, np.float32)
        densities[cell[0] + r * (cell[1] + r * cell[2])] = 1.0
        state = acceleration.OccupancyGridState(t(densities), grid.warmup_updates)
        center = (cell + 0.5) / r * 2.0 - 1.0
        d = rng.randn(3).astype(np.float32)
        d /= np.linalg.norm(d)
        rays = t(np.stack([center - d * 3.0, d], axis=0)[None].astype(np.float32))
        _, occ, _, mask = renderer._select_candidates(rays, state, generator=torch.Generator().manual_seed(trial))
        assert bool(mask[0]) and int(occ.sum()) >= 1, f"trial {trial}: cell {cell} lost"


def _corner_chord(grid, bbox, sc, factor, span_candidates, along):
    """A ray clipping the (max-x, max-y) corner of supercell ``sc`` over a
    chord of ``0.01 * sqrt(2)``; returns the span and the chord's ends."""
    r = grid.resolution
    rs = r // factor
    lo, hi = np.asarray(bbox["bbox_min"]), np.asarray(bbox["bbox_max"])
    side = (hi - lo) / rs
    densities = np.zeros((r, r, r), np.float32)  # [z, y, x]
    densities[sc[2] * factor:(sc[2] + 1) * factor, sc[1] * factor:(sc[1] + 1) * factor,
              sc[0] * factor:(sc[0] + 1) * factor] = 1.0
    state = acceleration.OccupancyGridState(t(densities.reshape(-1)), grid.warmup_updates)
    renderer = occ_render.OccupancyRenderer(model=None, grid=grid, candidates=96, samples=16,
                                            span_candidates=span_candidates, span_pool_factor=factor, **bbox)
    delta = 0.01
    corner = lo + (np.asarray(sc) + np.array([1.0, 1.0, 0.5])) * side
    mid = (corner - np.array([delta / 2, delta / 2, 0.0])).astype(np.float32)
    d = np.asarray([1.0, -1.0, 0.0], np.float32) / np.sqrt(2.0)
    origin = t((mid - along * d)[None].astype(np.float32))
    dirs = t(d[None])
    t_min, t_max, inside = ray_bbox_range(origin, dirs, torch.tensor(lo, dtype=torch.float32),
                                          torch.tensor(hi, dtype=torch.float32), renderer.min_t_range)
    assert bool(inside[0])
    half = delta * np.sqrt(2.0) / 2.0
    return renderer._occupied_span(origin, dirs, t_min, t_max, state), (along - half, along + half)


@pytest.mark.parametrize("sc", [(4, 4, 3), (5, 2, 6), (2, 6, 1)])
def test_two_phase_span_covers_corner_grazing_chord(sc):
    grid = acceleration.OccupancyGrid(resolution=64, **CUBE)
    (t_lo, t_hi, hit), (t_in, t_out) = _corner_chord(grid, CUBE, sc, 8, 32, 2.5)
    assert bool(hit[0]) and float(t_lo[0]) <= t_in and float(t_hi[0]) >= t_out


def test_two_phase_span_anisotropic_bbox():
    grid = acceleration.OccupancyGrid(resolution=64, **FLAT)
    # The cube's count (2*sqrt(3)*8 ~ 28) is not enough on a flat bbox.
    assert occ_render.min_span_candidates(64, 8, **FLAT) == 92 == jocc.min_span_candidates(64, 8, **FLAT)
    with pytest.raises(ValueError, match="occ_span_candidates"):
        _corner_chord(grid, FLAT, (4, 4, 3), 8, 32, 1.5)
    (t_lo, t_hi, hit), (t_in, t_out) = _corner_chord(grid, FLAT, (4, 4, 3), 8, 96, 1.5)
    assert bool(hit[0]) and float(t_lo[0]) <= t_in and float(t_hi[0]) >= t_out


@pytest.mark.parametrize("case", [
    dict(r=32, factor=8, span=8, match="need >= 14"),
    dict(r=32, factor=5, span=64, match="must divide"),
])
def test_undersized_probe_count_and_odd_factor_raise_jax_messages(case):
    grid = acceleration.OccupancyGrid(resolution=case["r"], **CUBE)
    j_grid = jacc.OccupancyGrid(resolution=case["r"], **CUBE)
    args = dict(candidates=32, samples=8, span_candidates=case["span"], span_pool_factor=case["factor"], **CUBE)
    port = occ_render.OccupancyRenderer(model=None, grid=grid, **args)
    j = jocc.OccupancyRenderer(model=None, grid=j_grid, **args)
    with pytest.raises(ValueError, match=case["match"]) as ours:
        port._occupied_span(torch.zeros(1, 3), torch.ones(1, 3), torch.zeros(1), torch.ones(1), grid.init())
    with pytest.raises(ValueError) as theirs:
        j._occupied_span(jnp.zeros((1, 3)), jnp.ones((1, 3)), jnp.zeros(1), jnp.ones(1), j_grid.init())
    assert str(ours.value) == str(theirs.value)


def test_block_word_selection_is_the_cell_path_at_stride_one_and_a_superset_at_four():
    r = 32
    rng = np.random.RandomState(7)
    densities = (rng.rand(r**3) < 0.08).astype(np.float32)
    _, _, grid, state = grids(r, densities)
    rays = t(rays_into_bbox(64))
    u = t(np.random.RandomState(0).rand(64, 96).astype(np.float32))

    def select(stride, eps=0.0, grid_state=state):
        renderer = occ_render.OccupancyRenderer(model=None, grid=grid, candidates=96, samples=16,
                                                block_gather_stride=stride, **CUBE)
        return renderer._select_candidates(rays, grid_state, eps, u=u)

    base, one, four = select(0), select(1), select(4)
    for a, b in zip(base, one):
        assert torch.equal(a, b)
    o0, o4 = base[1], four[1]
    assert not (o0 & ~o4).any(), "block words dropped an occupied candidate"
    assert (o4 & ~o0).float().mean() < 0.05
    assert not (select(4, 1e-6)[1] & ~o4).any()


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("lever", ["block_gather_stride", "span_block_gather"])
def test_block_word_paths_in_warmup_test_everything_occupied(lever, stride):
    """Both block-word paths keep occupied_from_densities' warmup rule: at
    grid step 0 every candidate is occupied and every span is the whole
    range, whatever the words say (here: an empty grid)."""
    r = 64
    grid = acceleration.OccupancyGrid(resolution=r, **CUBE)
    warm = acceleration.OccupancyGridState(torch.zeros(r**3), 0)
    levers = {lever: stride}
    if lever == "span_block_gather":
        levers["span_candidates"] = 32
    renderer = occ_render.OccupancyRenderer(model=None, grid=grid, candidates=96, samples=16, **levers, **CUBE)
    rays = t(rays_into_bbox(8, seed=5))
    _, occ, _, mask = renderer._select_candidates(rays, warm, generator=torch.Generator().manual_seed(0))
    assert mask.any() and occ[mask].all()
    if lever == "span_block_gather":
        t_min, t_max, _ = ray_bbox_range(rays[:, 0], rays[:, 1], -torch.ones(3), torch.ones(3))
        lo, hi, hit = renderer._occupied_span(rays[:, 0], rays[:, 1], t_min, t_max, warm)
        assert hit.all()
        torch.testing.assert_close(lo, t_min, rtol=0, atol=1e-6)
        torch.testing.assert_close(hi, t_max, rtol=0, atol=1e-6)
    if stride == 1:  # past warmup the empty grid's words cull everything
        past = acceleration.OccupancyGridState(torch.zeros(r**3), grid.warmup_updates)
        assert not renderer._select_candidates(rays, past, generator=torch.Generator().manual_seed(0))[1].any()


def test_span_block_gather_is_the_per_cell_span_at_stride_one_and_only_widens():
    r, factor = 64, 8
    rng = np.random.RandomState(17)
    _, _, grid, state = grids(r, (rng.rand(r**3) < 0.02).astype(np.float32))
    rays = rays_into_bbox(96, seed=5)

    def spans(stride, g=grid, s=state, span=32):
        renderer = occ_render.OccupancyRenderer(model=None, grid=g, candidates=96, samples=16, span_candidates=span,
                                                span_pool_factor=factor, span_block_gather=stride, **CUBE)
        return _spans(renderer, rays, s, CUBE, False)[:3]

    lo0, hi0, hit0 = spans(0)
    for a, b in zip(spans(1), (lo0, hi0, hit0)):
        np.testing.assert_array_equal(a, b)
    lo4, hi4, hit4 = spans(4)
    assert not (hit0 & ~hit4).any()
    both = hit0 & hit4
    assert (lo4[both] <= lo0[both] + 1e-6).all() and (hi4[both] >= hi0[both] - 1e-6).all()
    # A supergrid that does not tile into 4x4x2 blocks (16 / 8 = 2) takes
    # the per-cell probes, exactly.
    _, _, small, small_state = grids(16, (np.random.RandomState(3).rand(16**3) < 0.05).astype(np.float32))
    for a, b in zip(spans(0, small, small_state, 16), spans(2, small, small_state, 16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lever", [dict(block_gather_stride=1), dict(span_candidates=32, span_block_gather=1)],
                         ids=["block words", "span block words"])
def test_stride_one_renders_bit_equal_to_the_per_cell_path(small_models, lever):
    _, _, ports = small_models
    r = 64
    rng = np.random.RandomState(23)
    _, _, grid, state = grids(r, (rng.rand(r**3) < 0.05).astype(np.float32) * 2.0)
    rays = t(rays_into_bbox(32))
    u = t(np.random.RandomState(4).rand(32, 64).astype(np.float32))

    def frame(**levers):
        renderer = occ_render.OccupancyRenderer(model=ports["float32"], grid=grid, candidates=64, samples=16,
                                                **levers, **CUBE)
        with torch.no_grad():
            return renderer.render_rays(rays, torch.tensor([0.1, 0.2, 0.3]), state, u=u)[0]["outputs"]

    base = {"span_candidates": 32} if "span_candidates" in lever else {}
    assert torch.equal(frame(**lever), frame(**base))


def test_renderer_fields_equal_jax_and_span_pool_factor_reaches_it():
    port_fields = {f.name: f.default for f in dataclasses.fields(occ_render.OccupancyRenderer)}
    jax_fields = {f.name: f.default for f in dataclasses.fields(jocc.OccupancyRenderer)}
    assert port_fields == jax_fields
