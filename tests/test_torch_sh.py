"""The port's spherical harmonics, integrated directional encoding, sRGB
curve and leaky clip (``learn_nerf_tpu_torch.ops.sh``,
``models.ref_nerf``) against learn_nerf_tpu and the goldens, on the CPU.

Tolerances: against the JAX functions on the same inputs, 2e-7 absolute
(the same recurrences in the same order; measured up to 6.0e-8 over
degrees 1-8); against the goldens (outputs of the
reference implementation's hand-unrolled polynomials) the JAX package's
own bounds, rtol 2e-4 / atol 1e-5 for SH and the IDE, 1e-5 / 1e-6 for
sRGB.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu.models import ref_nerf as jref
from learn_nerf_tpu.ops import sh as jsh
from learn_nerf_tpu_torch.models import ref_nerf
from learn_nerf_tpu_torch.ops import sh

from .torch_helpers import t

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
JAX_BOUND = 2e-7


def load(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npz"))


def unit_vectors(seed, n=300):
    v = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[:6] = np.eye(3, dtype=np.float32).repeat(2, 0) * np.array([[1], [-1]] * 3, np.float32)  # the poles
    return v


@pytest.mark.parametrize("degree", range(1, 9))
def test_spherical_harmonics_match_jax_and_the_golden(degree):
    v = unit_vectors(degree)
    got = sh.spherical_harmonics(degree, t(v)).numpy()
    want = np.asarray(jsh.spherical_harmonics(degree, jnp.asarray(v)))
    assert got.shape == (len(v), degree**2)
    assert np.abs(got - want).max() <= JAX_BOUND
    g = load("sh")
    np.testing.assert_allclose(sh.spherical_harmonics(degree, t(g["coords"])).numpy(), g[f"sh{degree}"],
                               rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("degree", range(1, 9))
def test_integrated_dir_enc_matches_jax(degree):
    v = unit_vectors(10 + degree)
    roughness = np.random.RandomState(degree).exponential(0.5, (len(v), 1)).astype(np.float32)
    got = sh.integrated_dir_enc(degree, t(v), t(roughness)).numpy()
    want = np.asarray(jsh.integrated_dir_enc(degree, jnp.asarray(v), jnp.asarray(roughness)))
    assert np.abs(got - want).max() <= JAX_BOUND
    assert sh.sh_band_indices(degree).tolist() == np.asarray(jsh.sh_band_indices(degree)).tolist()


def test_integrated_dir_enc_matches_the_golden():
    g = load("sh")
    out = sh.integrated_dir_enc(4, t(g["coords"]), t(g["roughness"]))
    np.testing.assert_allclose(out.numpy(), g["ide4"], rtol=2e-4, atol=1e-5)


def test_degree_out_of_range_raises():
    with pytest.raises(ValueError, match="degree"):
        sh.spherical_harmonics(9, torch.zeros(1, 3))


def test_srgb_and_leaky_clip_match_the_golden_and_jax():
    g = load("srgb")
    colors = t(g["colors"])
    np.testing.assert_allclose(ref_nerf.linear_to_srgb(colors).numpy(), g["srgb"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref_nerf.leaky_clip(colors).numpy(), g["clipped"], rtol=1e-6)
    wide = np.linspace(-0.5, 1.5, 401).astype(np.float32)
    np.testing.assert_allclose(ref_nerf.linear_to_srgb(t(wide)).numpy(),
                               np.asarray(jref.linear_to_srgb(jnp.asarray(wide))), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ref_nerf.leaky_clip(t(wide)).numpy(),
                                  np.asarray(jref.leaky_clip(jnp.asarray(wide))))


def test_leaky_clip_passes_the_identity_gradient_and_srgb_is_nan_safe():
    x = t(np.array([-0.5, 0.0, 0.5, 1.5], np.float32)).requires_grad_()
    ref_nerf.leaky_clip(x).sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0, 1.0]
    c = t(np.array([0.0, -1.0, 1e-3, 0.5], np.float32)).requires_grad_()
    ref_nerf.linear_to_srgb(c).sum().backward()
    assert torch.isfinite(c.grad).all()
    v = torch.zeros(2, 3)
    assert torch.isfinite(ref_nerf.safe_normalize(v)).all()
