"""The port's baked Instant-NGP serving against learn_nerf_tpu.baked.

* the JAX bake carried across (``baked_from_flax``) into the port's
  ``BakedInstantNGP``: within 1e-5 of the JAX ``BakedInstantNGP.apply``, in
  f32 and bf16, at packs 1, 2, 4 and 8, at a resolution where the JAX table
  comes from `_segments_from_physical` (S = 8 divides r = 16) and one
  where it does not;
* the port's own bake against the JAX bake of the same weights: f32 within
  1e-5; in bf16 each table is its own f32 bake rounded to nearest even,
  and the two differ on at most 2 % of the entries, by one bf16 ulp (the
  f32 features differ in the last bits, which moves a few roundings), or
  by more only within the f32 bound of 1e-5 near 0;
* every pack bit-equal to pack 1 (lookups and model outputs), the packed
  layout pinned against its definition, the bake's z-plane chunks;
* the baked field at lattice vertices against the live model (exact up to
  f32 rounding of the vertex positions, and in bf16 up to the storage
  rounding);
* a baked pooled and a baked fixed-K frame against the JAX
  ``render_frame_occupancy`` with the same uniforms (1e-5);
* the wrapper's refusals (grad, shapes) with its card launcher faked;
* ``--baked_cache``: write, reuse, stale after a newer checkpoint, a new
  file for another bbox, the JAX package's ``.seg128`` file never read;
* ``render_nerf --device cpu --instant_ngp --occupancy --baked 17``.
"""

import os
import time
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from learn_nerf_tpu import acceleration as jacc
from learn_nerf_tpu import baked as jbaked
from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu.models import InstantNGPModel as FlaxNGP
from learn_nerf_tpu_torch import acceleration, baked, checkpoint, occ_render
from learn_nerf_tpu_torch.kernels import baked as kbaked
from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
from learn_nerf_tpu_torch.models import InstantNGPModel
from learn_nerf_tpu_torch.scripts import baked_ablations, common, render_nerf

from .torch_helpers import t

torch.set_num_threads(1)

BBOX = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
TINY = dict(table_sizes=[256] * 4, grid_sizes=[4, 4, 8, 8])
HIDDEN = 8
F32 = dict(rtol=1e-5, atol=1e-5)
# (density_dim, resolution): S = 32 does not divide 9^2 (the JAX sweep's
# logical path and pack_baked_grid); S = 8 divides 16 (its physical sweep
# and _segments_from_physical).
SHAPES = [(4, 9), (16, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULP_SHARE = 0.02


def tiny_tree(seed, density_dim):
    """A flax tree of the tiny NGP with unit-scale tables and small nonzero
    biases, so the baked features are far from 0."""
    model = FlaxNGP(**TINY, **BBOX, hidden_dim=HIDDEN, density_dim=density_dim)
    zeros = jnp.zeros((1, 3))
    params = jax.device_get(model.init(dict(params=jax.random.PRNGKey(seed)), zeros, zeros)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(seed)
    for name, table in params["HashGridEncoding_0"].items():
        params["HashGridEncoding_0"][name] = rng.uniform(-1, 1, table.shape).astype(np.float32)
    for name, layer in params.items():
        if name.startswith("Dense_"):
            layer["bias"] = (0.1 * rng.randn(*layer["bias"].shape)).astype(np.float32)
    return model, params


def port_ngp(tree, density_dim, compute_dtype="float32"):
    model = InstantNGPModel(**TINY, **BBOX, hidden_dim=HIDDEN, density_dim=density_dim,
                            compute_dtype=compute_dtype)
    model.load_state_dict(checkpoint.ngp_params_from_flax(tree))
    return model.eval()


def jax_bake(model, params, r, dtype, pack):
    return jbaked.bake_instant_ngp(model, params, r, dtype=dtype, pack=pack, verbose=False)


def carried(bp, r, pack, density_dim):
    """The JAX baked params as the port's BakedInstantNGP."""
    host = jax.device_get(bp)
    tree = dict(host, grid=np.asarray(host["grid"]))
    if tree["grid"].dtype != np.float32:
        tree["grid"] = tree["grid"].view(np.uint16)
    state = baked.baked_from_flax(tree, r, pack, density_dim)
    model = baked.BakedInstantNGP(state["grid"], r, **BBOX, hidden_dim=HIDDEN,
                                  density_dim=density_dim, pack=pack)
    model.load_state_dict(state)
    return model.eval()


def probe_points(seed, n=300):
    """Random points inside and outside the bbox, and points on its faces
    and on lattice-cell faces."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    x[:20, rng.randint(0, 3, 20)] = rng.choice([-1.0, 1.0], 20)
    x[20:40] = np.round(x[20:40] * 4) / 4  # cell faces of r = 9
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d


@pytest.mark.parametrize("density_dim,r", SHAPES)
@pytest.mark.parametrize("pack", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_bake_carried_across_matches_jax_apply(density_dim, r, pack, dtype):
    model, params = tiny_tree(0, density_dim)
    j_baked, bp = jax_bake(model, params, r, DTYPES[dtype][0], pack)
    x, d = probe_points(1)
    ref_density, ref_rgb, _ = j_baked.apply(dict(params=bp), jnp.asarray(x), jnp.asarray(d))
    port = carried(bp, r, pack, density_dim)
    assert port.grid.dtype == DTYPES[dtype][1] and port.grid.shape == (r**3, pack * density_dim)
    with torch.no_grad():
        density, rgb, aux = port(t(x).reshape(3, 100, 3), t(d).reshape(3, 100, 3))
    assert aux == {} and density.shape == (3, 100, 1)
    np.testing.assert_allclose(density.numpy().reshape(-1, 1), np.asarray(ref_density), **F32)
    np.testing.assert_allclose(rgb.numpy().reshape(-1, 3), np.asarray(ref_rgb), **F32)


def bf16_ulps(a, b):
    """Distance in bf16 ulps of two bf16 tensors (same-sign values; a sign
    change counts from zero on both sides)."""
    def ordered(v):
        bits = v.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("density_dim,r,pack", [(4, 9, 1), (16, 16, 1), (16, 16, 4), (4, 9, 8)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_bake_matches_jax_bake(density_dim, r, pack, dtype):
    model, params = tiny_tree(2, density_dim)
    _, bp = jax_bake(model, params, r, DTYPES[dtype][0], pack)
    want = carried(bp, r, pack, density_dim)
    got = baked.bake_instant_ngp(port_ngp(params, density_dim), r, dtype=DTYPES[dtype][1], pack=pack,
                                 verbose=False)
    assert got.grid.dtype == want.grid.dtype and got.grid.shape == want.grid.shape
    if dtype == "float32":
        torch.testing.assert_close(got.grid, want.grid, **F32)
    else:
        # Each table is its own f32 bake rounded to nearest even ...
        port32 = baked.bake_instant_ngp(port_ngp(params, density_dim), r, dtype=torch.float32, pack=pack,
                                        verbose=False)
        jax32 = carried(jax_bake(model, params, r, jnp.float32, pack)[1], r, pack, density_dim)
        assert torch.equal(got.grid, port32.grid.to(torch.bfloat16))
        assert torch.equal(want.grid, jax32.grid.to(torch.bfloat16))
        # ... so the two are one ulp apart where the f32 features round
        # differently, and further apart only near 0, where the f32
        # features' own 1e-5 bound is wider than a bf16 ulp.
        ulps = bf16_ulps(got.grid, want.grid)
        near_zero = (got.grid.float() - want.grid.float()).abs() <= F32["atol"]
        share = (ulps > 0).double().mean().item()
        assert bool(((ulps <= 1) | near_zero).all()) and share <= BF16_ULP_SHARE, (ulps.max().item(), share)
    for name in ("color_layers.0", "color_layers.1", "rgb"):
        for key in ("weight", "bias"):
            torch.testing.assert_close(got.state_dict()[f"{name}.{key}"],
                                       want.state_dict()[f"{name}.{key}"], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_pack_is_bit_equal_to_pack_one(dtype, monkeypatch):
    _, params = tiny_tree(3, 16)
    live = port_ngp(params, 16)
    r = 11
    monkeypatch.setattr(baked, "SWEEP_POINTS", 3 * r * r)  # chunks of 3 planes, the last of 2
    one = baked.bake_instant_ngp(live, r, dtype=dtype, pack=1, verbose=False)
    x, d = probe_points(4)
    with torch.no_grad():
        ref = one(t(x), t(d))
        ref_features = one.features(t(x))
    for pack in (2, 4, 8):
        packed = baked.bake_instant_ngp(live, r, dtype=dtype, pack=pack, verbose=False)
        assert torch.equal(packed.grid, baked.pack_baked_grid(one.grid, r, pack))
        with torch.no_grad():
            out = packed(t(x), t(d))
            assert torch.equal(packed.features(t(x)), ref_features)
        for a, b in zip(out[:2], ref[:2]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("r", [2, 3, 5])
def test_packed_layout_is_the_clamped_corner_shift(r):
    rng = np.random.RandomState(r)
    g = rng.randn(r, r, r, 3).astype(np.float32)  # [z, y, x, F]
    clamp = lambda v: min(v, r - 1)
    for pack in (1, 2, 4, 8):
        got = baked.pack_baked_grid(t(g.reshape(-1, 3)), r, pack).numpy().reshape(r, r, r, pack, 3)
        want = np.empty_like(got)
        for z in range(r):
            for y in range(r):
                for x in range(r):
                    for s in range(pack):
                        dz, dy, dx = s & 1, (s >> 1) & 1, (s >> 2) & 1
                        want[z, y, x, s] = g[clamp(z + dz), clamp(y + dy), clamp(x + dx)]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pack", [1, 2, 4, 8])
def test_probe_rows_are_the_packed_tables_rows(dtype, pack):
    """baked_ablations' random-row probe reads runs of a packed row's bytes,
    as many a point as the lookup reads rows."""
    grid = baked.pack_baked_grid(torch.zeros((27, kbaked.KERNEL_FEATURES), dtype=dtype), 3, pack)
    assert baked_ablations.run_bytes(dtype, pack) == grid.shape[1] * grid.element_size()
    assert baked_ablations.run_bytes(dtype, pack) // pack == (32 if dtype == torch.bfloat16 else 64)


def test_least_bytes_counts_each_vertex_once():
    """The baked lookup's byte bound counts one copy of each distinct lattice
    vertex the points read (16 features each), the points and the output."""
    r, lo, hi = 5, (-1.0,) * 3, (1.0,) * 3
    per_point = 3 * 4 + kbaked.KERNEL_FEATURES * 4
    vertex = kbaked.KERNEL_FEATURES * 2  # bf16
    cases = [
        (8, [[0.1, 0.1, 0.1]]),  # one cell
        (8, [[0.1, 0.1, 0.1], [0.2, 0.4, 0.3]]),  # the same cell
        (12, [[0.1, 0.1, 0.1], [0.6, 0.1, 0.1]]),  # two cells that share a face
        (16, [[0.1, 0.1, 0.1], [-0.9, -0.9, -0.9]]),  # two cells apart
    ]
    for vertices, pts in cases:
        x = t(np.array(pts, np.float32))
        got = baked_ablations.least_bytes(x, r, 2, lo, hi)
        assert got == vertices * vertex + len(pts) * per_point, pts


def test_ablation_shapes_are_the_frames_point_counts():
    """The four shapes the baked kernels are timed at: 2^20 random points in
    the bbox +- 0.05, 2^20 points along rays, a pooled frame tile's pool
    (8,192 rays at budget 6: 37,736 samples, the unused rows one point
    outside the bbox, as render_rays_pooled pads them) and a fixed-K tile,
    samples 0.01 apart along each ray."""
    pts = baked_ablations.shapes(np.random.RandomState(0), torch.device("cpu"))
    assert {k: v.shape[0] for k, v in pts.items()} == {
        "random": 1 << 20, "rays": 1 << 20, "pooled tile": 8192 * 6, "fixed-K tile": 8192 * 32}
    pad = pts["pooled tile"][37_736:]
    assert (pad == pad[0]).all() and pad[0].abs().max() > 1.0
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in pts.values())
    assert pts["random"].abs().max() <= 0.75
    for name, per_ray in (("rays", 128), ("fixed-K tile", 32)):
        steps = pts[name].view(-1, per_ray, 3).diff(dim=1).norm(dim=-1)
        torch.testing.assert_close(steps, torch.full_like(steps, 0.01), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_baked_field_at_lattice_vertices_equals_the_live_model(dtype):
    _, params = tiny_tree(5, 4)
    live = port_ngp(params, 4)
    r = 9
    bake = baked.bake_instant_ngp(live, r, dtype=dtype, pack=2, verbose=False)
    ax = np.linspace(-1.0, 1.0, r).astype(np.float32)
    pts = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    _, d = probe_points(6, len(pts))
    with torch.no_grad():
        want = live(t(pts), t(d), spatial_only=True)
        got = bake.features(t(pts))
        ref_density, ref_rgb, _ = live(t(pts), t(d))
        density, rgb, _ = bake(t(pts), t(d))
    if dtype == torch.float32:
        # The JAX package's bounds (tests/test_baked.py): the vertex
        # positions' f32 rounding leaves weights of 1 - 1e-7 and 1e-7.
        np.testing.assert_allclose(density.numpy(), ref_density.numpy(), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(rgb.numpy(), ref_rgb.numpy(), rtol=1e-4, atol=1e-5)
    else:
        # Each feature is the live one rounded to bf16 (half an ulp: at most
        # 2^-8 relative), up to that same f32 rounding.
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2**-8 + 1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want.to(torch.bfloat16).float().numpy(), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def occ_scene():
    """An 8^3 grid with ~40 % occupied cells in both packages, and the JAX
    bake of a tiny NGP (F = 16, r = 16) at packs 1 and 4."""
    rng = np.random.RandomState(3)
    densities = (rng.rand(8**3) < 0.4).astype(np.float32) * 3.0
    j_grid = jacc.OccupancyGrid(resolution=8, **BBOX)
    j_state = j_grid.init().replace(
        densities=jnp.asarray(densities), step=jnp.asarray(j_grid.warmup_updates, jnp.int32))
    grid = acceleration.OccupancyGrid(resolution=8, **BBOX)
    state = acceleration.OccupancyGridState(densities=t(densities), step=grid.warmup_updates)
    model, params = tiny_tree(7, 16)
    bakes = {pack: jax_bake(model, params, 16, jnp.bfloat16, pack) for pack in (1, 4)}
    return dict(j_grid=j_grid, j_state=j_state, grid=grid, state=state, bakes=bakes,
                bg=np.array([0.4, -0.1, 0.7], np.float32))


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    origins = rng.randn(n, 3).astype(np.float32) * 2.5
    dirs = -origins + 0.3 * rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return np.stack([origins, dirs], axis=1).astype(np.float32)


@pytest.mark.parametrize("pack", [1, 4])
@pytest.mark.parametrize("budget_per_ray", [None, 3.0])
def test_baked_frame_matches_jax(occ_scene, pack, budget_per_ray):
    s = occ_scene
    j_baked, bp = s["bakes"][pack]
    j_renderer = jocc.OccupancyRenderer(model=j_baked, grid=s["j_grid"], candidates=24, samples=8, **BBOX)
    renderer = occ_render.OccupancyRenderer(model=carried(bp, 16, pack, 16), grid=s["grid"],
                                            candidates=24, samples=8, **BBOX)
    rays, key = _rays(70, 9), jax.random.PRNGKey(10)  # 3 tiles of 32, the last padded
    ref = jocc.render_frame_occupancy(
        j_renderer, key, jnp.asarray(rays), bp, jnp.asarray(s["bg"]), s["j_state"],
        tile_size=32, budget_per_ray=budget_per_ray, transmittance_eps=1e-2,
    )
    uniforms = t(np.stack([np.asarray(jax.random.uniform(k, (32, 24))) for k in jax.random.split(key, 3)]))
    for counter in (kbaked.counter, ke.counter):
        counter.reset()
    with torch.no_grad():
        out = occ_render.render_frame_occupancy(
            renderer, t(rays), t(s["bg"]), s["state"], tile_size=32, transmittance_eps=1e-2,
            uniforms=uniforms, budget_per_ray=budget_per_ray,
        )
    # One lookup a tile, and no hash-grid encoding.
    assert (kbaked.counter.plain_calls, ke.counter.plain_calls, ke.counter.launches) == (3, 0, 0)
    np.testing.assert_allclose(out["outputs"].numpy(), np.asarray(ref["outputs"]), **F32)
    if budget_per_ray is not None:
        assert int(out["selected"]) == int(ref["selected"]) and int(out["dropped"]) == int(ref["dropped"])


def test_lookup_refuses_grad_and_takes_the_card_route_off_the_cpu(monkeypatch):
    """Meta tensors stand in for the card's: the wrapper hands them to its
    card launcher (faked here), never to the plain version, and refuses a
    table or points that require grad on either route."""
    calls = []
    monkeypatch.setattr(kbaked, "_cuda_launcher", lambda grid, x, *rest: calls.append(rest) or x[:, :1])
    r, pack = 3, 2
    for device in ("meta", "cpu"):
        grid = torch.zeros((r**3, pack * 16), device=device)
        x = torch.zeros((5, 3), device=device)
        with pytest.raises(NotImplementedError, match="inference only"):
            kbaked.baked_lookup(grid.requires_grad_(), x, r, pack, (-1,) * 3, (1,) * 3)
        with pytest.raises(NotImplementedError, match="inference only"):
            kbaked.baked_lookup(grid.detach(), x.requires_grad_(), r, pack, (-1,) * 3, (1,) * 3)
        with torch.no_grad():  # no graph to lose
            kbaked.baked_lookup(grid, x, r, pack, (-1,) * 3, (1,) * 3)
    assert calls == [(r, pack, (-1,) * 3, (1,) * 3)]
    plain = kbaked.counter.plain_calls
    with pytest.raises(ValueError, match="pack must be"):
        kbaked.baked_lookup(torch.zeros(27, 48), torch.zeros(2, 3), 3, 3, (-1,) * 3, (1,) * 3)
    with pytest.raises(ValueError, match="want grid"):
        kbaked.baked_lookup(torch.zeros(26, 32), torch.zeros(2, 3), 3, 2, (-1,) * 3, (1,) * 3)
    with pytest.raises(ValueError, match="on a CUDA device"):
        kbaked.launch_lookup(torch.zeros(27, 16), torch.zeros(2, 3), 3, 1, (-1,) * 3, (1,) * 3)
    assert kbaked.counter.plain_calls == plain


def _cache_args(tmp_path, **kw):
    return Namespace(**dict(dict(baked=9, baked_dtype="bfloat16", baked_cache=True, baked_pack=2,
                                 occupancy=True, model_path=str(tmp_path / "m.pkl")), **kw))


def test_baked_cache_write_reuse_stale_bbox_and_jax_file(tmp_path, capsys):
    _, params = tiny_tree(8, 4)
    (tmp_path / "m.pkl").write_bytes(b"checkpoint")
    args = _cache_args(tmp_path)
    first = common.apply_baking(args, port_ngp(params, 4))
    assert "wrote baked grid cache" in capsys.readouterr().out
    path = common.baked_cache_path(args, port_ngp(params, 4))
    assert path.endswith(".bfloat16.p2." + path.split(".")[-3] + ".logical.npz") and os.path.exists(path)

    again = common.apply_baking(args, port_ngp(params, 4))
    assert "loaded baked grid cache" in capsys.readouterr().out
    assert again.grid.dtype == torch.bfloat16 and torch.equal(again.grid, first.grid)
    x, d = probe_points(9)
    with torch.no_grad():
        for a, b in zip(again(t(x), t(d))[:2], first(t(x), t(d))[:2]):
            assert torch.equal(a, b)

    # A newer checkpoint makes the cache stale: bake again, rewrite.
    later = os.path.getmtime(path) + 10
    os.utime(tmp_path / "m.pkl", (later, later))
    common.apply_baking(args, port_ngp(params, 4))
    assert "wrote baked grid cache" in capsys.readouterr().out

    # Another bbox is another file.
    shifted = InstantNGPModel(**TINY, bbox_min=(-2.0,) * 3, bbox_max=(2.0,) * 3, hidden_dim=HIDDEN,
                              density_dim=4)
    shifted.load_state_dict(checkpoint.ngp_params_from_flax(params))
    assert common.baked_cache_path(args, shifted) != path
    common.apply_baking(args, shifted.eval())
    assert "wrote baked grid cache" in capsys.readouterr().out

    # The JAX package's file for the same checkpoint is never read, even
    # when it is the only one there and fresh.
    os.remove(path)
    jax_path = path.replace(".logical.npz", ".seg128.npz")
    np.savez(jax_path, grid=np.zeros((1, 1), np.uint16))
    future = time.time() + 100
    os.utime(jax_path, (future, future))
    common.apply_baking(args, port_ngp(params, 4))
    assert "wrote baked grid cache" in capsys.readouterr().out


def test_baking_needs_occupancy_and_the_plain_ngp(tmp_path):
    from learn_nerf_tpu_torch.models import NeRFModel

    with pytest.raises(SystemExit, match="--baked requires --occupancy"):
        common.apply_baking(_cache_args(tmp_path, occupancy=False), port_ngp(tiny_tree(0, 4)[1], 4))
    with pytest.raises(ValueError, match="plain Instant-NGP"):
        common.apply_baking(_cache_args(tmp_path), NeRFModel())
    with pytest.raises(ValueError, match="at least 2"):
        baked.bake_instant_ngp(port_ngp(tiny_tree(0, 4)[1], 4), 1)
    # Without --baked the live model is served as it is.
    live = port_ngp(tiny_tree(0, 4)[1], 4)
    assert common.apply_baking(_cache_args(tmp_path, baked=None), live) is live


def test_render_cli_baked(tmp_path, capsys):
    """render_nerf --baked end to end on the CPU (tests/test_baked.py::
    test_render_cli_baked): bake at startup, render a frame."""
    from learn_nerf_tpu_torch.data.dataset import ModelMetadata

    meta = tmp_path / "metadata.json"
    meta.write_text('{"min": [-1, -1, -1], "max": [1, 1, 1]}')
    view = tmp_path / "view.json"
    view.write_text('{"origin": [0, 0, 3], "x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, -1], '
                    '"x_fov": 0.8, "y_fov": 0.8}')
    torch.manual_seed(0)
    args = Namespace(instant_ngp=True, ref_nerf=False, bf16=False)
    coarse, fine, _ = common.create_model(args, ModelMetadata(bbox_min=(-1,) * 3, bbox_max=(1,) * 3))
    ckpt = checkpoint.checkpoint_to_flax(dict(coarse=coarse.state_dict(), fine=fine.state_dict()))
    ckpt.update(background=np.zeros(3, np.float32), occupancy_densities=np.full(8**3, 1.0, np.float32),
                occupancy_resolution=np.int32(8))
    checkpoint.save_params_pickle(str(tmp_path / "m.pkl"), ckpt)
    out = tmp_path / "out.png"
    render_nerf.main([
        "--device", "cpu", "--seed", "0", "--batch_size", "64", "--width", "16", "--height", "16",
        "--model_path", str(tmp_path / "m.pkl"), "--instant_ngp", "--occupancy",
        "--occ_candidates", "32", "--occ_samples", "16", "--occ_grid", "8", "--occ_budget_per_ray", "auto",
        "--baked", "17", "--baked_dtype", "float32", "--baked_pack", "2",
        str(meta), str(view), str(out),
    ])
    assert "baked 17^3 x 16 spatial grid (0.00 GB float32, pack 2, 32-wide rows)" in capsys.readouterr().out
    assert np.asarray(Image.open(out)).shape == (16, 16, 3)
