"""The port's ray ops (learn_nerf_tpu_torch.ops, .data) against the JAX
package and the goldens: geometry, encoding, sampling with JAX's own
uniforms, and compositing.  Tolerance 1e-5 (f32 on both sides; the only
differences are summation orders)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu.data.camera import CameraView as JaxCameraView
from learn_nerf_tpu.ops import encoding as jenc
from learn_nerf_tpu.ops import geometry as jgeo
from learn_nerf_tpu.ops import sampling as jsam
from learn_nerf_tpu.ops import volume as jvol
from learn_nerf_tpu_torch.data import CameraView, ModelMetadata
from learn_nerf_tpu_torch.ops import encoding, geometry, sampling, volume

from .torch_helpers import t

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = dict(rtol=1e-5, atol=1e-5)


def load(name):
    return np.load(os.path.join(GOLDEN, name + ".npz"))


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


def test_ray_bbox_range_matches_golden_and_jax():
    g = load("ray_t_range")
    t_min, t_max, mask = geometry.ray_bbox_range(
        t(g["origins"]), t(g["dirs"]), t(g["bbox_min"]), t(g["bbox_max"])
    )
    j_min, j_max, j_mask = jgeo.ray_bbox_range(
        jnp.asarray(g["origins"]), jnp.asarray(g["dirs"]),
        jnp.asarray(g["bbox_min"]), jnp.asarray(g["bbox_max"]),
    )
    np.testing.assert_array_equal(mask.numpy(), g["mask"])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    close(t_min, g["t_min"])
    close(t_max, g["t_max"])
    close(t_min, j_min)
    close(t_max, j_max)


def test_ray_bbox_range_sign_preserving_epsilon_and_misses():
    # Tiny negative components must stay negative (an additive epsilon
    # would cancel them to 0 and turn a hit into a NaN miss); missed rays
    # get (0, min_t_range).
    origins = np.array(
        [[0.0, 0.0, -3.0], [0.0, 0.0, -3.0], [5.0, 5.0, 5.0], [0.2, -0.1, 0.0]],
        np.float32,
    )
    dirs = np.array(
        [[-1e-8, 0.0, 1.0], [0.0, 5e-9, 1.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]],
        np.float32,
    )
    lo, hi = np.full(3, -1.0, np.float32), np.ones(3, np.float32)
    t_min, t_max, mask = geometry.ray_bbox_range(t(origins), t(dirs), t(lo), t(hi))
    j_min, j_max, j_mask = jgeo.ray_bbox_range(
        jnp.asarray(origins), jnp.asarray(dirs), jnp.asarray(lo), jnp.asarray(hi)
    )
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert mask.tolist()[:3] == [True, True, False]
    close(t_min, j_min)
    close(t_max, j_max)
    assert t_min[2].item() == 0.0 and t_max[2].item() == pytest.approx(1e-3)


@pytest.mark.parametrize("freqs,key", [(10, "emb10"), (4, "emb4")])
def test_sinusoidal_features(freqs, key):
    g = load("sinusoidal")
    out = encoding.sinusoidal_features(t(g["coords"]), freqs)
    close(out, g[key])
    close(out, jenc.sinusoidal_features(jnp.asarray(g["coords"]), freqs))


def test_sinusoidal_features_leading_dims_and_high_frequency():
    x = np.random.RandomState(0).uniform(-3, 3, (4, 5, 3)).astype(np.float32)
    out = encoding.sinusoidal_features(t(x), 10)
    assert out.shape == (4, 5, 60)
    close(out, jenc.sinusoidal_features(jnp.asarray(x), 10))


def test_stratified_ts_with_jax_uniforms():
    g = load("sampling")
    key = jax.random.PRNGKey(7)
    u = jax.random.uniform(key, (g["t_min"].shape[0], 16))
    ts = sampling.stratified_ts(t(g["t_min"]), t(g["t_max"]), 16, u=t(u))
    close(ts, g["ts"])
    close(ts, jsam.stratified_ts(key, jnp.asarray(g["t_min"]), jnp.asarray(g["t_max"]), 16))


def test_stratified_ts_draws_from_generator():
    t_min, t_max = torch.zeros(5), torch.full((5,), 2.0)
    a = sampling.stratified_ts(t_min, t_max, 8, generator=torch.Generator().manual_seed(3))
    b = sampling.stratified_ts(t_min, t_max, 8, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ((a[:, 1:] - a[:, :-1]) > 0).all()
    assert (a >= 0).all() and (a < 2).all()


def test_batched_interp_matches_jax_including_clamps():
    rng = np.random.RandomState(1)
    xp = np.sort(rng.rand(6, 9).astype(np.float32), axis=1)
    xp[0, 3:5] = xp[0, 2]  # repeated knots (zero-width segments)
    fp = rng.randn(6, 9).astype(np.float32)
    x = rng.uniform(-0.5, 1.5, (6, 11)).astype(np.float32)  # some outside
    out = sampling.batched_interp(t(x), t(xp), t(fp))
    close(out, jsam.batched_interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))


def test_inverse_cdf_and_merge_with_jax_uniforms():
    g = load("sampling")
    ts, t_min, t_max = t(g["ts"]), t(g["t_min"]), t(g["t_max"])
    _, ends, deltas = volume.bin_deltas(ts, t_min, t_max)
    w = volume.termination_weights(t(g["densities"]), deltas)[:, :-1]
    key = jax.random.PRNGKey(8)
    u = jax.random.uniform(key, (ts.shape[0], 24))  # inverse_cdf_ts' inner draw
    new_ts = sampling.inverse_cdf_ts(w, t_min, ends, 24, u=t(u))
    merged = sampling.merge_sorted(ts, new_ts)
    np.testing.assert_allclose(merged.numpy(), g["fine_ts"], rtol=1e-4, atol=1e-5)
    j_new = jsam.inverse_cdf_ts(
        key, jnp.asarray(w.numpy()), jnp.asarray(g["t_min"]), jnp.asarray(ends.numpy()), 24
    )
    close(new_ts, j_new)
    close(merged, jsam.merge_sorted(jnp.asarray(g["ts"]), j_new))


def test_bin_deltas_and_termination_weights():
    g = load("sampling")
    starts, ends, deltas = volume.bin_deltas(t(g["ts"]), t(g["t_min"]), t(g["t_max"]))
    close(starts, g["starts"])
    close(ends, g["ends"])
    close(deltas, g["deltas"])
    w = volume.termination_weights(t(g["densities"]), deltas)
    close(w, g["probs"])
    close(w.sum(1), np.ones(w.shape[0], np.float32))
    close(w, jvol.termination_weights(jnp.asarray(g["densities"]), jnp.asarray(deltas.numpy())))


def test_composite_alpha_and_aux_match_golden():
    g, c = load("sampling"), load("compositing")
    _, _, deltas = volume.bin_deltas(t(g["ts"]), t(g["t_min"]), t(g["t_max"]))
    w = volume.termination_weights(t(g["densities"]), deltas)
    mask = t(g["mask"])
    close(volume.composite(w, t(c["rgbs"]), t(c["background"]), mask), c["outputs"])
    close(volume.composite_alpha(w, mask), c["alphas"])
    aux = volume.average_aux(w, {"a": t(c["aux_in"])}, torch.ones_like(mask))
    np.testing.assert_allclose(aux["a"].item(), float(c["aux_mean"]), rtol=1e-5)


def test_average_aux_is_the_masked_mean_of_the_jax_package():
    rng = np.random.RandomState(2)
    w = rng.rand(10, 7).astype(np.float32)
    v = rng.randn(10, 6).astype(np.float32)
    mask = rng.rand(10) < 0.6
    out = volume.average_aux(t(w), {"a": t(v)}, t(mask))
    ref = jvol.average_aux(jnp.asarray(w), {"a": jnp.asarray(v)}, jnp.asarray(mask))
    np.testing.assert_allclose(out["a"].item(), float(ref["a"]), rtol=1e-5)


def test_camera_rays_match_golden_and_jax_camera():
    kwargs = dict(
        camera_direction=(0.3, -0.5, 0.81),
        camera_origin=(1.0, 2.0, -3.0),
        x_axis=(0.8, 0.6, 0.0),
        y_axis=(0.0, 0.6, -0.8),
        x_fov=1.047,
        y_fov=0.785,
    )
    rays = CameraView(**kwargs).bare_rays(17, 13)
    np.testing.assert_allclose(rays, load("camera")["rays"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(rays, JaxCameraView(**kwargs).bare_rays(17, 13))
    view = CameraView(**kwargs)
    assert CameraView.from_dict(json.loads(view.to_json())) == view


def test_model_metadata_reads_min_max(tmp_path):
    path = tmp_path / "metadata.json"
    path.write_text('{"min": [-1, -2, -3], "max": [1, 2, 3]}')
    md = ModelMetadata.from_json(str(path))
    assert md.bbox_min == (-1, -2, -3) and md.bbox_max == (1, 2, 3)
