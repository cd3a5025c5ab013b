"""The port's Instant-NGP serving path against learn_nerf_tpu.

* InstantNGPModel: f32 within 1e-5 of flax, bf16 within 2e-2 of flax's
  bf16 (the same bf16 rounding points; f32 sums in another order can flip
  a bf16 rounding), ``spatial_only``;
* the weight bridge both ways, and the reference-named checkpoint
  (tests/golden/ngp_reference_checkpoint.pkl) against its golden outputs
  (the bounds of tests/test_parity.py::test_reference_ngp_checkpoint_cross_load);
* the three render modes (hierarchy, fixed-K occupancy, pooled) against
  the JAX package's renderers with JAX's uniforms, at 1e-5;
* the pooled path as tests/test_occupancy.py holds it: equal to fixed-K
  when the budget suffices, the budget buckets and escalation, the drop
  counters, and the scan's precision on a large pool (where a global
  cumsum minus each ray's base is shown to fail the same bound);
* ``serve_nerf --instant_ngp --occupancy --occ_budget_per_ray auto`` on
  the CPU answers a PNG.
"""

import io
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from learn_nerf_tpu import acceleration as jacc
from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu import render as jrender
from learn_nerf_tpu.models import InstantNGPModel as FlaxNGP
from learn_nerf_tpu_torch import acceleration, checkpoint, occ_render, render
from learn_nerf_tpu_torch.kernels import hashgrid as khash
from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
from learn_nerf_tpu_torch.kernels import table_gather as tg
from learn_nerf_tpu_torch.models import InstantNGPModel
from learn_nerf_tpu_torch.scripts import render_nerf, serve_nerf

from .synthetic_scene import write_dataset
from .torch_helpers import points_and_dirs, t

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BBOX = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
SMALL = dict(table_sizes=[2**10] * 4, grid_sizes=[4, 8, 16, 32])
F32 = dict(rtol=1e-5, atol=1e-5)


def flax_ngp_params(seed, table_sizes, grid_sizes, bbox=BBOX, **kw):
    """A flax NGP tree with unit-scale tables and small nonzero biases (so
    the encoding's errors are not hidden by the +-1e-4 init)."""
    model = FlaxNGP(table_sizes=table_sizes, grid_sizes=grid_sizes, **bbox, **kw)
    zeros = jnp.zeros((1, 3))
    params = jax.device_get(jax.jit(model.init)(dict(params=jax.random.PRNGKey(seed)), zeros, zeros)["params"])
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for name, table in params["HashGridEncoding_0"].items():
        params["HashGridEncoding_0"][name] = rng.uniform(-1, 1, table.shape).astype(np.float32)
    for name, layer in params.items():
        if name.startswith("Dense_"):
            layer["bias"] = (0.1 * rng.randn(*layer["bias"].shape)).astype(np.float32)
    return params


def port_ngp(tree, table_sizes, grid_sizes, bbox=BBOX, **kw):
    model = InstantNGPModel(table_sizes=table_sizes, grid_sizes=grid_sizes, **bbox, **kw)
    model.load_state_dict(checkpoint.ngp_params_from_flax(tree))
    return model.eval()


@pytest.fixture(scope="module")
def small_tree():
    return flax_ngp_params(0, **SMALL)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_model_matches_flax(small_tree, dtype, tol):
    x, d = points_and_dirs(1, 300, scale=1.2)
    ref_density, ref_rgb, _ = jax.jit(FlaxNGP(**SMALL, **BBOX, compute_dtype=dtype).apply)(
        dict(params=small_tree), jnp.asarray(x), jnp.asarray(d)
    )
    model = port_ngp(small_tree, **SMALL, compute_dtype=dtype)
    with torch.no_grad():
        density, rgb, aux = model(t(x).reshape(3, 100, 3), t(d).reshape(3, 100, 3))
    assert aux == {} and density.shape == (3, 100, 1) and density.dtype == torch.float32
    ref_density = np.asarray(ref_density).reshape(3, 100, 1)
    # exp of an output that is off by `tol` is off by `tol` relative.
    np.testing.assert_allclose(density.numpy(), ref_density, rtol=tol, atol=tol)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb).reshape(3, 100, 3), rtol=tol, atol=tol)


def test_spatial_only_returns_density_features(small_tree):
    x, d = points_and_dirs(2, 50)
    ref = jax.jit(FlaxNGP(**SMALL, **BBOX).apply, static_argnames="spatial_only")(
        dict(params=small_tree), jnp.asarray(x), jnp.asarray(d), spatial_only=True
    )
    model = port_ngp(small_tree, **SMALL)
    with torch.no_grad():
        out = model(t(x), t(d), spatial_only=True)
        density, _, _ = model(t(x), t(d))
    assert out.shape == (50, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    torch.testing.assert_close(density, torch.exp(out[:, :1]))


def test_weight_bridge_round_trips_exactly(small_tree):
    state = checkpoint.ngp_params_from_flax(small_tree)
    model = InstantNGPModel(**SMALL, **BBOX)
    assert sorted(state) == sorted(model.state_dict())
    layers = dict(model.named_modules())
    assert [layers[n] for n in checkpoint.ngp_dense_names()] == model.dense_layers()
    np.testing.assert_array_equal(
        state["encoding.table_2"].numpy(), small_tree["HashGridEncoding_0"]["table_2"]
    )
    np.testing.assert_array_equal(state["color_layers.0.weight"].numpy(), small_tree["Dense_2"]["kernel"].T)
    back = checkpoint.ngp_params_to_flax(state)
    assert back.keys() == small_tree.keys()
    for name, layer in small_tree.items():
        for key, value in layer.items():
            np.testing.assert_array_equal(back[name][key], value)
    # The pickle-contract bridge dispatches on the tree's kind.
    ckpt = checkpoint.checkpoint_from_flax(dict(coarse=small_tree, background=np.zeros(3, np.float32)))
    assert "encoding.table_0" in ckpt["coarse"]
    assert checkpoint.checkpoint_to_flax(ckpt)["coarse"].keys() == small_tree.keys()
    with pytest.raises(ValueError, match="not an Instant-NGP tree"):
        checkpoint.ngp_params_from_flax(dict(small_tree, extra={}))


def test_reference_checkpoint_loads_and_reproduces_its_outputs():
    g = np.load(os.path.join(GOLDEN, "ngp_reference_outputs.npz"))
    params = checkpoint.load_params_pickle(os.path.join(GOLDEN, "ngp_reference_checkpoint.pkl"))
    assert "HashGridEncoding_0" in params["fine"]
    bbox = dict(bbox_min=tuple(g["bbox_min"].tolist()), bbox_max=tuple(g["bbox_max"].tolist()))
    model = port_ngp(params["fine"], [2**12] * 3, [4, 8, 64], bbox=bbox)
    with torch.no_grad():
        density, rgb, _ = model(t(g["x"]), t(g["d"]))
    np.testing.assert_allclose(density.numpy(), g["density"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rgb.numpy(), g["rgb"], rtol=1e-5, atol=1e-6)


def _rays(n, seed, spread=2.5, aim=False):
    rng = np.random.RandomState(seed)
    origins = rng.randn(n, 3).astype(np.float32) * spread
    dirs = -origins if aim else rng.randn(n, 3).astype(np.float32)
    dirs = dirs + (0.3 * rng.randn(n, 3).astype(np.float32) if aim else 0)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return np.stack([origins, dirs], axis=1).astype(np.float32)


def test_hierarchy_render_matches_jax(small_tree):
    fine_tree = flax_ngp_params(1, **SMALL)
    j_renderer = jrender.Renderer(
        coarse=FlaxNGP(**SMALL, **BBOX), fine=FlaxNGP(**SMALL, **BBOX),
        coarse_ts=8, fine_ts=8, **BBOX,
    )
    rays = _rays(64, 3, aim=True)
    bg = np.array([0.3, -0.2, 0.9], np.float32)
    key = jax.random.PRNGKey(4)
    ref = jax.jit(j_renderer.render_rays)(key, jnp.asarray(rays), small_tree, fine_tree, jnp.asarray(bg))
    renderer = render.Renderer(
        coarse=port_ngp(small_tree, **SMALL), fine=port_ngp(fine_tree, **SMALL),
        coarse_ts=8, fine_ts=8, **BBOX,
    )
    coarse_key, fine_key = jax.random.split(key)
    with torch.no_grad():
        out = renderer.render_rays(
            t(rays), t(bg),
            u_coarse=t(jax.random.uniform(coarse_key, (64, 8))),
            u_fine=t(jax.random.uniform(fine_key, (64, 8))),
        )
    for level in ("coarse", "fine"):
        for k in ("outputs", "alphas", "densities"):
            np.testing.assert_allclose(out[level][k].numpy(), np.asarray(ref[level][k]), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def occ_setup(small_tree):
    """An 8^3 grid with ~40 % occupied cells, in both packages, and an NGP
    model with the same weights."""
    rng = np.random.RandomState(3)
    densities = (rng.rand(8**3) < 0.4).astype(np.float32) * 3.0
    j_grid = jacc.OccupancyGrid(resolution=8, **BBOX)
    j_state = j_grid.init().replace(
        densities=jnp.asarray(densities), step=jnp.asarray(j_grid.warmup_updates, jnp.int32)
    )
    grid = acceleration.OccupancyGrid(resolution=8, **BBOX)
    state = acceleration.OccupancyGridState(densities=t(densities), step=grid.warmup_updates)

    def renderers(candidates, samples):
        return (
            jocc.OccupancyRenderer(model=FlaxNGP(**SMALL, **BBOX), grid=j_grid,
                                   candidates=candidates, samples=samples, **BBOX),
            occ_render.OccupancyRenderer(model=port_ngp(small_tree, **SMALL), grid=grid,
                                         candidates=candidates, samples=samples, **BBOX),
        )

    return dict(params=small_tree, j_state=j_state, state=state, renderers=renderers,
                bg=np.array([0.4, -0.1, 0.7], np.float32))


def test_fixed_k_render_matches_jax(occ_setup):
    s = occ_setup
    j_renderer, renderer = s["renderers"](24, 8)
    rays, key = _rays(80, 5), jax.random.PRNGKey(6)
    ref, _ = jax.jit(j_renderer.render_rays)(
        key, jnp.asarray(rays), s["params"], jnp.asarray(s["bg"]), s["j_state"]
    )
    with torch.no_grad():
        out, _ = renderer.render_rays(t(rays), t(s["bg"]), s["state"], u=t(jax.random.uniform(key, (80, 24))))
    assert not renderer.fused  # NGP never takes the vanilla fused kernel
    for k in ("outputs", "alphas", "coords", "densities", "weights"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **F32)


@pytest.mark.parametrize("budget,eps", [(80 * 8, 0.0), (80 * 3, 1e-2), (50, 0.0)])
def test_pooled_render_matches_jax(occ_setup, budget, eps):
    s = occ_setup
    j_renderer, renderer = s["renderers"](24, 8)
    rays, key = _rays(80, 7, aim=True), jax.random.PRNGKey(8)
    ref = jax.jit(j_renderer.render_rays_pooled, static_argnums=(5, 6))(
        key, jnp.asarray(rays), s["params"], jnp.asarray(s["bg"]), s["j_state"], budget, eps
    )
    with torch.no_grad():
        out = renderer.render_rays_pooled(
            t(rays), t(s["bg"]), s["state"], budget, eps, u=t(jax.random.uniform(key, (80, 24)))
        )
    assert int(out["selected"]) == int(ref["selected"]) and int(out["dropped"]) == int(ref["dropped"])
    if budget == 50:
        assert int(out["dropped"]) > 0  # the drop semantics are exercised
    for k in ("outputs", "alphas", "coords"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **F32)


@pytest.mark.parametrize("budget_per_ray", [None, 3.0])
def test_render_frame_occupancy_matches_jax(occ_setup, budget_per_ray):
    s = occ_setup
    j_renderer, renderer = s["renderers"](24, 8)
    rays, key = _rays(70, 9, aim=True), jax.random.PRNGKey(10)  # 3 tiles of 32, padded
    ref = jocc.render_frame_occupancy(
        j_renderer, key, jnp.asarray(rays), s["params"], jnp.asarray(s["bg"]), s["j_state"],
        tile_size=32, budget_per_ray=budget_per_ray, transmittance_eps=1e-2,
    )
    uniforms = t(np.stack([np.asarray(jax.random.uniform(k, (32, 24))) for k in jax.random.split(key, 3)]))
    for counter in (ke.counter, khash.counter, tg.counter):
        counter.reset()
    with torch.no_grad():
        out = occ_render.render_frame_occupancy(
            renderer, t(rays), t(s["bg"]), s["state"], tile_size=32, transmittance_eps=1e-2,
            uniforms=uniforms, budget_per_ray=budget_per_ray,
        )
    # One plain encode call per tile, for all levels; none of the corner
    # and gather wrappers.
    assert (ke.counter.plain_calls, khash.counter.plain_calls, tg.counter.plain_calls) == (3, 0, 0)
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["outputs"].numpy(), np.asarray(ref["outputs"]), **F32)
    if budget_per_ray is not None:
        assert int(out["selected"]) == int(ref["selected"]) and int(out["dropped"]) == int(ref["dropped"])


def test_pooled_render_matches_fixed_k(occ_setup):
    """With an ample budget, no termination eps and K = C, the pooled path
    reproduces render_rays (tests/test_occupancy.py::test_pooled_render_matches_fixed_k)."""
    s = occ_setup
    _, renderer = s["renderers"](24, 24)
    rays = t(_rays(48, 11))
    u = t(np.random.RandomState(12).rand(48, 24).astype(np.float32))
    with torch.no_grad():
        ref, _ = renderer.render_rays(rays, t(s["bg"]), s["state"], u=u)
        pooled = renderer.render_rays_pooled(rays, t(s["bg"]), s["state"], budget=48 * 24, u=u)
    assert int(pooled["dropped"]) == 0
    for k in ("outputs", "alphas"):
        torch.testing.assert_close(pooled[k], ref[k], **F32)
    torch.testing.assert_close(pooled["coords"], ref["coords"], rtol=1e-4, atol=1e-5)


def test_budget_buckets_cap_and_escalation():
    assert acceleration.AUTO_BUDGET_BUCKETS == jacc.AUTO_BUDGET_BUCKETS
    assert acceleration.AUTO_BUDGET_MARGIN == jacc.AUTO_BUDGET_MARGIN
    assert acceleration.quantize_budget(5.2, 32) == 6
    assert acceleration.quantize_budget(70.0, 128) == 96
    assert acceleration.quantize_budget(70.0, 64) == 64
    assert acceleration.next_budget_bucket(8, 32) == 12
    assert acceleration.next_budget_bucket(32, 32) == 32
    assert acceleration.next_budget_bucket(128, 256) == 192
    for demand in np.linspace(0.0, 300.0, 301):
        for cap in (8, 32, 64, 128, 256):
            assert acceleration.quantize_budget(demand, cap) == jacc.quantize_budget(demand, cap)
            assert acceleration.auto_budget_from_demand(demand, cap) == jacc.auto_budget_from_demand(demand, cap)
    for budget in list(range(1, 70)) + [96, 128, 192, 256]:
        for cap in (32, 64, 256, 512):
            assert acceleration.next_budget_bucket(budget, cap) == jacc.next_budget_bucket(budget, cap)


def test_pooled_drop_counters(occ_setup):
    s = occ_setup
    _, renderer = s["renderers"](16, 16)
    warm = acceleration.OccupancyGridState(densities=s["state"].densities, step=0)  # all occupied
    rays = t(_rays(24, 1))
    u = t(np.random.RandomState(2).rand(24, 16).astype(np.float32))
    with torch.no_grad():
        ample = renderer.render_rays_pooled(rays, t(s["bg"]), warm, budget=24 * 16, u=u)
        sel = int(ample["selected"])
        assert sel > 0 and int(ample["dropped"]) == 0
        tight = renderer.render_rays_pooled(rays, t(s["bg"]), warm, budget=max(sel // 3, 1), u=u)
    assert int(tight["selected"]) == sel and int(tight["dropped"]) == sel - max(sel // 3, 1)
    with pytest.raises(ValueError, match="at least one sample"):
        renderer.render_rays_pooled(rays, t(s["bg"]), warm, budget=0, u=u)


def test_frame_session_reports_and_escalates(occ_setup, capsys):
    s = occ_setup
    _, renderer = s["renderers"](16, 16)
    warm = acceleration.OccupancyGridState(densities=s["state"].densities, step=0)
    rays = t(_rays(64, 2, aim=True))
    generator = torch.Generator().manual_seed(0)
    manual = occ_render.OccupancyFrameSession(renderer, t(s["bg"]), warm, tile_size=32, budget_cfg=1.0)
    with torch.no_grad():
        out = manual.render(rays, generator)
    assert int(out["dropped"]) > 0
    assert manual.last_pool == dict(budget=1.0, selected=int(out["selected"]), dropped=int(out["dropped"]))
    captured = capsys.readouterr().out
    assert "WARNING" in captured and "dropped" in captured

    auto = occ_render.OccupancyFrameSession(renderer, t(s["bg"]), warm, tile_size=32, budget_cfg="auto")
    with torch.no_grad():
        out = auto.render(rays, generator)
    assert int(out["dropped"]) == 0
    assert "auto render budget" in capsys.readouterr().out

    # A budget below demand escalates up the buckets until nothing drops,
    # and later frames start from the escalated floor.
    demand = renderer.mean_sample_demand(rays, warm, generator=torch.Generator().manual_seed(0))
    assert demand.item() > 4 and auto._escalated_floor == 0
    auto._demand_fn = lambda generator, r, g: torch.tensor(1.0)  # undersized on purpose
    with torch.no_grad():
        out = auto.render(rays, generator)
    assert int(out["dropped"]) == 0
    captured = capsys.readouterr().out
    assert "escalating budget 2 -> 3" in captured and auto._escalated_floor >= 3


def test_resolve_auto_budget_strides_over_the_whole_frame(occ_setup):
    s = occ_setup
    _, renderer = s["renderers"](16, 16)
    rays = t(_rays(100, 4, aim=True))
    seen = []

    def demand_fn(generator, subset, grid_state):
        seen.append(subset)
        return torch.tensor(5.0)

    budget = occ_render.resolve_auto_budget(renderer, s["state"], rays, sample_rays=30,
                                            demand_fn=demand_fn, quiet=True)
    assert budget == acceleration.auto_budget_from_demand(5.0, 16) == 8
    # ceil(100 / 30) = 4: rays 0, 4, ..., 96 reach the frame's last rows.
    torch.testing.assert_close(seen[0], rays[::4][:30])


def test_pooled_transmittance_precision_at_scale(occ_setup):
    """Compositing precision must not degrade with pool size: the pooled
    path scans per ray, and a global cumsum minus each ray's base (whose
    f32 error grows with the pool's total optical depth) fails the bound
    (tests/test_occupancy.py::test_pooled_transmittance_precision_at_scale)."""
    s = occ_setup
    _, renderer = s["renderers"](16, 16)
    full = acceleration.OccupancyGridState(densities=torch.ones(8**3), step=16)
    n = 2048
    rays = t(_rays(n, 11))
    u = t(np.random.RandomState(13).rand(n, 16).astype(np.float32))
    with torch.no_grad():
        ref, _ = renderer.render_rays(rays, t(s["bg"]), full, u=u)
        pooled = renderer.render_rays_pooled(rays, t(s["bg"]), full, budget=n * 16, u=u)
    err = (pooled["outputs"] - ref["outputs"]).abs().max().item()
    assert err <= 2e-6
    # The rejected scan on the same samples: a global cumsum over the
    # ray-major pool minus each ray's base.
    _, _, _, dt, mask = renderer._select_samples(rays, full, 0.0, u, None)
    sig = ref["densities"] * dt  # [n, 16], 0 in padding slots
    flat = torch.cumsum(sig.reshape(-1), 0).reshape(n, 16)
    acc = flat - (flat[:, :1] - sig[:, :1])
    weights = torch.exp(-(acc - sig)) * (1.0 - torch.exp(-sig))
    fg = torch.einsum("nk,nkc->nc", weights, ref["rgbs"]) + torch.exp(-acc[:, -1:]) * t(s["bg"])
    global_err = (torch.where(mask[:, None], fg, t(s["bg"])) - ref["outputs"]).abs().max().item()
    assert global_err > 2e-6, global_err


def _ngp_tree_full(rng, levels):
    grids = [2 ** (4 + i // 2) for i in range(levels)]
    tables = {
        f"table_{i}": rng.uniform(-1, 1, (min(g**3, 2**18), 2)).astype(np.float32)
        for i, g in enumerate(grids)
    }
    shapes = [(2 * levels, 64), (64, 16), (24 + 16, 64), (64, 64), (64, 3)]
    tree = {f"Dense_{i}": dict(kernel=(rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
                               bias=(0.1 * rng.randn(s[1])).astype(np.float32))
            for i, s in enumerate(shapes)}
    return dict(tree, HashGridEncoding_0=tables)


def test_serve_ngp_pooled_answers_a_png(tmp_path):
    scene = str(tmp_path / "scene")
    write_dataset(scene, num_views=1, resolution=16)
    rng = np.random.RandomState(0)
    pkl = str(tmp_path / "ngp.pkl")
    checkpoint.save_params_pickle(pkl, dict(
        coarse=_ngp_tree_full(rng, 6), fine=_ngp_tree_full(rng, 16),
        background=np.array([0.3, -0.2, 0.9], np.float32),
        occupancy_densities=(rng.rand(8**3) < 0.5).astype(np.float32), occupancy_resolution=8,
    ))
    flags = ["--device", "cpu", "--seed", "0", "--batch_size", "64", "--width", "16", "--height", "16",
             "--occ_candidates", "16", "--occ_samples", "8", "--model_path", pkl,
             "--instant_ngp", "--occupancy", "--occ_budget_per_ray", "auto", "--occ_t_eps", "1e-2"]
    argv = flags + ["--port", "0", f"{scene}/metadata.json"]
    server = serve_nerf.make_server(serve_nerf.argparser().parse_args(argv))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address[:2]
        with open(f"{scene}/0000.json", "rb") as f:
            body = f.read()
        req = urllib.request.Request(f"http://{host}:{port}/render", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, ctype, png = resp.status, resp.headers.get("Content-Type"), resp.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert status == 200 and ctype == "image/png"
    assert np.asarray(Image.open(io.BytesIO(png))).shape == (16, 16, 3)
    session = render_nerf.RenderSession(
        render_nerf.argparser().parse_args(flags + [f"{scene}/metadata.json"])
    )
    assert len(session.fine.encoding.tables()) == 16 and len(session.coarse.encoding.tables()) == 6
    assert session.frames.budget_cfg == "auto"
