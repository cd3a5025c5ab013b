"""The slice as a whole: the port's renderers against learn_nerf_tpu's.

* hierarchy: Renderer.render_rays on the renderer_e2e golden with
  PRNGKey(21)'s coarse and fine uniforms taken from JAX (bounds of
  tests/test_parity.py::test_renderer_end_to_end);
* occupancy fixed-K: render_rays and render_frame_occupancy against
  learn_nerf_tpu.occ_render on the grid of tests/test_fused_render.py,
  each tile fed JAX's uniforms: f32 at 1e-5, the bf16 fused-kernel route
  (its plain version on the CPU) at 2e-2 against the f32 path and at 2e-3
  against the Pallas fused_render_occupancy in interpret mode;
* pad_rays_to_tiles, the occupancy grid and strided compaction.
"""

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
from learn_nerf_tpu_torch import acceleration, occ_render, render
from learn_nerf_tpu_torch.checkpoint import load_params_pickle
from learn_nerf_tpu_torch.kernels import fused_render as fr
from learn_nerf_tpu_torch.ops.geometry import ray_bbox_range
from tools.pallas_recipe.fused_render import fused_render_occupancy, pack_vanilla_params

from .torch_helpers import port_model, t

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
F32 = dict(rtol=1e-5, atol=1e-5)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or F32))


def test_hierarchy_render_rays_matches_golden():
    g = np.load(os.path.join(GOLDEN, "renderer_e2e.npz"))
    params = load_params_pickle(os.path.join(GOLDEN, "vanilla_params.pkl"))
    renderer = render.Renderer(
        coarse=port_model(params["coarse"]),
        fine=port_model(params["fine"]),
        bbox_min=tuple(g["bbox_min"].tolist()),
        bbox_max=tuple(g["bbox_max"].tolist()),
        coarse_ts=8,
        fine_ts=12,
    )
    n = g["rays"].shape[0]
    coarse_key, fine_key = jax.random.split(jax.random.PRNGKey(21))
    with torch.no_grad():
        out = renderer.render_rays(
            t(g["rays"]), t(g["background"]),
            u_coarse=t(jax.random.uniform(coarse_key, (n, 8))),
            u_fine=t(jax.random.uniform(fine_key, (n, 12))),
        )
    close(out["coarse"]["outputs"], g["coarse_outputs"], rtol=1e-4, atol=1e-5)
    close(out["coarse"]["densities"], g["coarse_densities"], rtol=1e-4, atol=1e-5)
    close(out["fine"]["densities"], g["fine_densities"], rtol=1e-3, atol=1e-4)
    close(out["fine"]["outputs"], g["fine_outputs"], rtol=1e-4, atol=1e-5)
    close(out["fine"]["alphas"], g["fine_alphas"], rtol=1e-4, atol=1e-5)
    close(out["fine"]["coords"], g["fine_coords"], rtol=1e-4, atol=1e-4)
    assert set(out) == {"coarse", "fine", "coarse_aux", "fine_aux"}
    assert out["fine"]["weights"].shape == (n, 21)


class _JaxWithAux:
    """A flax model's ``apply`` with one per-sample aux loss (|x|^2)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, x, d):
        density, rgb, _ = self.model.apply(variables, x, d)
        return density, rgb, {"sq": jnp.sum(x * x, axis=-1)}


class _PortWithAux(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, d):
        density, rgb, _ = self.model(x, d)
        return density, rgb, {"sq": (x * x).sum(dim=-1)}


@pytest.mark.parametrize("samples", [8, 70])
def test_render_ray_samples_matches_jax_with_per_sample_widths_and_aux(samples):
    """One pass of the hierarchy (per-sample bin widths, the points and an
    aux loss blended as extras) against learn_nerf_tpu.render's, on the
    golden rays and weights, at a short pass and one past 64 samples."""
    g = np.load(os.path.join(GOLDEN, "renderer_e2e.npz"))
    params = load_params_pickle(os.path.join(GOLDEN, "vanilla_params.pkl"))
    rays = g["rays"]
    n = rays.shape[0]
    t_min, t_max, mask = ray_bbox_range(t(rays[:, 0]), t(rays[:, 1]), t(g["bbox_min"]), t(g["bbox_max"]))
    rng = np.random.RandomState(samples)
    frac = np.sort(rng.rand(n, samples).astype(np.float32), axis=1)
    ts = t_min[:, None] + (t_max - t_min)[:, None] * t(frac)
    j_args = [jnp.asarray(a.numpy()) for a in (ts, t_min, t_max, mask)]
    ref, ref_aux = jrender.render_ray_samples(
        _JaxWithAux(FlaxNeRFModel(hidden_dim=48, color_layer_dim=16)), params["fine"], jnp.asarray(g["background"]),
        jnp.asarray(rays), *j_args)
    with torch.no_grad():
        out, aux = render.render_ray_samples(
            _PortWithAux(port_model(params["fine"])), t(g["background"]), t(rays), ts, t_min, t_max, mask)
    assert set(out) == set(ref) and set(aux) == set(ref_aux) == {"sq"}
    for key in ("outputs", "alphas", "coords", "weights", "densities", "rgbs"):
        close(out[key], ref[key], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(aux["sq"].item(), float(ref_aux["sq"]), rtol=1e-5, atol=1e-6)


def _hierarchy(seed=0):
    params = load_params_pickle(os.path.join(GOLDEN, "vanilla_params.pkl"))
    renderer = render.Renderer(
        coarse=port_model(params["coarse"]), fine=port_model(params["fine"]),
        bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3, coarse_ts=6, fine_ts=5,
    )
    rng = np.random.RandomState(seed)
    origins = rng.randn(45, 3).astype(np.float32) * 2
    dirs = -origins + rng.randn(45, 3).astype(np.float32) * 0.3
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return renderer, t(np.stack([origins, dirs], axis=1)), torch.tensor([0.2, -0.1, 0.4])


def test_render_frame_tiles_match_render_rays():
    renderer, rays, bg = _hierarchy()
    rng = np.random.RandomState(1)
    uniforms = [(t(rng.rand(16, 6).astype(np.float32)), t(rng.rand(16, 5).astype(np.float32)))
                for _ in range(3)]
    with torch.no_grad():
        frame = render.render_frame(renderer, rays, bg, tile_size=16, uniforms=uniforms)
        padded, _ = render.pad_rays_to_tiles(rays, 16, renderer.bbox_max)
        expect = [
            renderer.render_rays(padded[16 * i : 16 * (i + 1)], bg, u_coarse=u_c, u_fine=u_f)["fine"]
            for i, (u_c, u_f) in enumerate(uniforms)
        ]
    assert set(frame) == {"outputs"} and frame["outputs"].shape == (45, 3)
    torch.testing.assert_close(frame["outputs"], torch.cat([e["outputs"] for e in expect])[:45])


def test_render_frame_is_deterministic_per_generator_seed():
    renderer, rays, bg = _hierarchy()
    with torch.no_grad():
        a, b = (
            render.render_frame(renderer, rays, bg, tile_size=32,
                                generator=torch.Generator().manual_seed(5))["outputs"]
            for _ in range(2)
        )
        c = render.render_frame(renderer, rays, bg, tile_size=32,
                                generator=torch.Generator().manual_seed(6))["outputs"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_pad_rays_to_tiles_pads_with_rays_that_miss():
    rays = np.random.RandomState(2).randn(10, 2, 3).astype(np.float32)
    bbox_max = (0.5, 0.7, 0.9)
    padded, tiles = render.pad_rays_to_tiles(t(rays), 4, bbox_max)
    j_padded, j_tiles = jrender.pad_rays_to_tiles(jnp.asarray(rays), 4, None, bbox_max)
    assert tiles == j_tiles == 3 and padded.shape == (12, 2, 3)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(j_padded))
    _, _, mask = ray_bbox_range(
        padded[10:, 0], padded[10:, 1], -torch.tensor(bbox_max), torch.tensor(bbox_max)
    )
    assert not mask.any()
    same, tiles = render.pad_rays_to_tiles(t(rays), 5, bbox_max)
    assert tiles == 2 and torch.equal(same, t(rays))


@pytest.fixture(scope="module")
def occupancy_setup():
    """The grid and rays of tests/test_fused_render.py:_setup, in both
    packages with the same weights."""
    flax_model = FlaxNeRFModel()
    zeros = jnp.zeros((1, 3))
    params = jax.device_get(flax_model.init(dict(params=jax.random.PRNGKey(0)), zeros, zeros)["params"])
    bbox = dict(bbox_min=(-1, -1, -1), bbox_max=(1, 1, 1))
    rng = np.random.RandomState(3)
    densities = (rng.rand(8**3) < 0.5).astype(np.float32)
    j_grid = jacc.OccupancyGrid(resolution=8, **bbox)
    j_state = j_grid.init().replace(
        densities=jnp.asarray(densities), step=jnp.asarray(j_grid.warmup_updates, jnp.int32)
    )
    j_renderer = jocc.OccupancyRenderer(model=flax_model, grid=j_grid, candidates=24, samples=8, **bbox)
    grid = acceleration.OccupancyGrid(resolution=8, **bbox)
    state = acceleration.OccupancyGridState(densities=t(densities), step=grid.warmup_updates)
    renderers = {
        dtype: occ_render.OccupancyRenderer(
            model=port_model(params, dtype), grid=grid, candidates=24, samples=8, **bbox
        )
        for dtype in ("float32", "bfloat16")
    }
    origins = rng.randn(96, 3).astype(np.float32) * 2.5
    dirs = rng.randn(96, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = np.stack([origins, dirs], axis=1)
    bg = np.array([0.4, -0.1, 0.7], np.float32)
    return dict(params=params, j_renderer=j_renderer, j_state=j_state, renderers=renderers,
                state=state, rays=rays, bg=bg)


def test_occupancy_render_rays_matches_jax(occupancy_setup):
    s = occupancy_setup
    key = jax.random.PRNGKey(11)
    ref, ref_aux = s["j_renderer"].render_rays(
        key, jnp.asarray(s["rays"]), s["params"], jnp.asarray(s["bg"]), s["j_state"]
    )
    u = jax.random.uniform(key, (96, 24))
    with torch.no_grad():
        out, aux = s["renderers"]["float32"].render_rays(t(s["rays"]), t(s["bg"]), s["state"], u=t(u))
    assert set(out) == set(ref) and aux == {} and ref_aux == {}
    np.testing.assert_array_equal(out["sample_mask"].numpy(), np.asarray(ref["sample_mask"]))
    for k in ("ts", "densities", "weights", "outputs", "alphas", "coords", "rgbs"):
        close(out[k], ref[k])


def test_occupancy_transmittance_prune_matches_jax(occupancy_setup):
    s = occupancy_setup
    key = jax.random.PRNGKey(12)
    ref = s["j_renderer"]._select_candidates(key, jnp.asarray(s["rays"]), s["j_state"], 0.5)
    out = s["renderers"]["float32"]._select_candidates(
        t(s["rays"]), s["state"], 0.5, u=t(jax.random.uniform(key, (96, 24)))
    )
    for port, jax_value in zip(out, ref):
        close(port.float(), np.asarray(jax_value, np.float32))
    assert 0 < out[1].sum() < s["renderers"]["float32"]._select_candidates(
        t(s["rays"]), s["state"], 0.0, u=t(jax.random.uniform(key, (96, 24)))
    )[1].sum()


def _frame_uniforms(key, tiles, tile_size, candidates):
    return t(np.stack([
        np.asarray(jax.random.uniform(k, (tile_size, candidates)))
        for k in jax.random.split(key, tiles)
    ]))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_render_frame_occupancy_matches_jax_f32_frame(occupancy_setup, dtype, tol):
    s = occupancy_setup
    key = jax.random.PRNGKey(5)
    rays = s["rays"][:70]  # not a tile multiple: 3 tiles of 32, padded
    ref = jocc.render_frame_occupancy(
        s["j_renderer"], key, jnp.asarray(rays), s["params"], jnp.asarray(s["bg"]),
        s["j_state"], tile_size=32,
    )
    renderer = s["renderers"][dtype]
    assert renderer.fused == (dtype == "bfloat16")
    fr.counter.reset()
    with torch.no_grad():
        out = occ_render.render_frame_occupancy(
            renderer, t(rays), t(s["bg"]), s["state"], tile_size=32,
            uniforms=_frame_uniforms(key, 3, 32, 24),
        )
    assert fr.counter.plain_calls == (3 if renderer.fused else 0)
    assert out["outputs"].shape == (70, 3)
    close(out["outputs"], ref["outputs"], rtol=tol, atol=tol)


def test_fused_route_matches_pallas_fused_render_occupancy(occupancy_setup):
    s = occupancy_setup
    key = jax.random.PRNGKey(11)
    ref = fused_render_occupancy(
        s["j_renderer"], pack_vanilla_params(s["params"]), key, jnp.asarray(s["rays"]),
        jnp.asarray(s["bg"]), s["j_state"], interpret=True,
    )
    with torch.no_grad():
        out = s["renderers"]["bfloat16"].render_rays_fused(
            t(s["rays"]), t(s["bg"]), s["state"], u=t(jax.random.uniform(key, (96, 24)))
        )
    close(out["outputs"], ref["outputs"], rtol=0, atol=2e-3)
    close(out["alphas"], ref["alphas"], rtol=0, atol=2e-3)


def test_occupancy_frame_session_renders_and_refuses_unported_levers(occupancy_setup):
    """The frame session renders, with each selection lever too (which
    were refused until they were ported), and a bbox that is not the
    grid's still refuses."""
    s = occupancy_setup
    renderer = s["renderers"]["float32"]
    session = occ_render.OccupancyFrameSession(renderer, t(s["bg"]), s["state"], tile_size=64)
    with torch.no_grad():
        out = session.render(t(s["rays"]), torch.Generator().manual_seed(0))
    assert set(out) == {"outputs"} and out["outputs"].shape == (96, 3)
    assert torch.isfinite(out["outputs"]).all()
    for lever in ("span_candidates", "block_gather_stride", "span_block_gather"):
        with_lever = occ_render.OccupancyRenderer(
            model=renderer.model, grid=renderer.grid, bbox_min=renderer.bbox_min, bbox_max=renderer.bbox_max,
            candidates=renderer.candidates, samples=renderer.samples, **{lever: 64},
        )
        session = occ_render.OccupancyFrameSession(with_lever, t(s["bg"]), s["state"], tile_size=64)
        with torch.no_grad():
            lever_out = session.render(t(s["rays"]), torch.Generator().manual_seed(0))["outputs"]
        assert lever_out.shape == (96, 3) and torch.isfinite(lever_out).all()
        if lever == "span_block_gather":  # without span_candidates it changes nothing
            assert torch.equal(lever_out, out["outputs"])
    with pytest.raises(ValueError, match="must equal its grid"):
        occ_render.OccupancyRenderer(
            model=renderer.model, grid=renderer.grid, bbox_min=(-2, -1, -1), bbox_max=(1, 1, 1)
        )


@pytest.mark.parametrize("count", [1, 5, 8, 13])
def test_compact_occupied_strided_matches_jax(count):
    rng = np.random.RandomState(count)
    ts = np.sort(rng.rand(20, 13).astype(np.float32), axis=1)
    occ = rng.rand(20, 13) < rng.rand(20, 1)  # from empty to full rows
    occ[0] = False
    occ[1] = True
    out = acceleration.compact_occupied_strided(t(ts), t(occ), count)
    ref = jacc.compact_occupied_strided(jnp.asarray(ts), jnp.asarray(occ), count)
    for port, jax_value in zip(out, ref):
        np.testing.assert_array_equal(port.numpy(), np.asarray(jax_value))


def test_occupancy_grid_quantization_warmup_and_checkpoint_state():
    bbox = dict(bbox_min=(-1.0, -0.5, 0.0), bbox_max=(1.0, 0.5, 2.0))
    grid = acceleration.OccupancyGrid(resolution=4, **bbox)
    j_grid = jacc.OccupancyGrid(resolution=4, **bbox)
    x = np.random.RandomState(4).uniform(-1.5, 2.5, (50, 3)).astype(np.float32)
    x[0] = (1.0, 0.5, 2.0)  # the max corner lands in the last cell
    np.testing.assert_array_equal(
        grid.cell_indices(t(x)).numpy(), np.asarray(j_grid.cell_indices(jnp.asarray(x)))
    )
    assert grid.cell_indices(t(x[:1])).item() == 63

    fresh = grid.init()
    assert fresh.step == 0 and torch.allclose(fresh.densities, torch.full((64,), 0.02))
    zeros = acceleration.OccupancyGridState(densities=torch.zeros(64), step=0)
    assert grid.occupied(zeros, t(x)).all()  # warmup: everything occupied
    cold = acceleration.OccupancyGridState(densities=torch.zeros(64), step=16)
    assert not grid.occupied(cold, t(x)).any()

    densities = np.zeros(64, np.float32)
    densities[::3] = 1.0
    state = grid.state_from_checkpoint({"occupancy_densities": densities, "occupancy_resolution": 4})
    assert state.step == grid.warmup_updates
    j_state = j_grid.state_from_checkpoint({"occupancy_densities": densities})
    np.testing.assert_array_equal(
        grid.occupied(state, t(x)).numpy(), np.asarray(j_grid.occupied(j_state, jnp.asarray(x)))
    )
    assert grid.state_from_checkpoint({}).step == 0
    with pytest.raises(ValueError, match="--occ_grid 2"):
        grid.state_from_checkpoint({"occupancy_densities": np.zeros(8, np.float32)})
    with pytest.raises(ValueError, match="corrupt"):
        grid.state_from_checkpoint({"occupancy_densities": np.zeros(60, np.float32)})
