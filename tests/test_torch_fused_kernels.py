"""The fused kernels' plain PyTorch versions against the Pallas kernels run
in interpret mode, and the port's bf16 NeRFModel against flax's.

fused_mlp_reference / fused_render_reference round at the Pallas kernels'
points (bf16 product operands, f32 sums and biases), so the only
differences are f32 summation orders, which can flip a bf16 rounding of an
activation: atol 2e-3.  Against flax's bf16 module (which rounds layer
outputs and biases to bf16 too) the bounds are those of
tests/test_fused_mlp.py: rgb atol 5e-3, density rtol 2e-2 / atol 5e-3.
The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py); here each wrapper must take its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu.models import NeRFModel as FlaxNeRFModel
from learn_nerf_tpu_torch.kernels import fused_mlp as fm
from learn_nerf_tpu_torch.kernels import fused_render as fr
from tools.pallas_recipe.fused_mlp import fused_nerf_forward
from tools.pallas_recipe.fused_mlp import pack_vanilla_params as jax_pack
from tools.pallas_recipe.fused_render import fused_render_tiles

from .torch_helpers import points_and_dirs, port_model, random_flax_tree, t

torch.set_num_threads(1)

KERNEL_ATOL = 2e-3

WIDTHS = {
    # as tests/test_fused_mlp.py:42
    "narrow": dict(input_layers=2, mid_layers=2, hidden=64, color=32),
    "full": dict(input_layers=5, mid_layers=4, hidden=256, color=128),
}


def _setup(width, seed):
    w = WIDTHS[width]
    tree = random_flax_tree(seed, **w)
    layers = dict(input_layers=w["input_layers"], mid_layers=w["mid_layers"])
    model = port_model(tree, "bfloat16", **layers)
    return tree, layers, model


@pytest.mark.parametrize("width,n", [("narrow", 300), ("full", 128)])
def test_fused_mlp_reference_matches_pallas(width, n):
    tree, layers, model = _setup(width, seed=0)
    x, d = points_and_dirs(1, n)
    out = fm.fused_mlp_reference(model.packed(), t(x), t(d))
    density, rgb = fused_nerf_forward(
        jax_pack(tree, **layers), jnp.asarray(x), jnp.asarray(d), interpret=True, **layers
    )
    assert out.shape == (n, 4)
    np.testing.assert_allclose(out[:, :1].numpy(), np.asarray(density), atol=KERNEL_ATOL)
    np.testing.assert_allclose(out[:, 1:].numpy(), np.asarray(rgb), atol=KERNEL_ATOL)


@pytest.mark.parametrize("width,n,k", [("narrow", 40, 8), ("full", 12, 24)])
def test_fused_render_reference_matches_pallas(width, n, k):
    tree, layers, model = _setup(width, seed=2)
    rng = np.random.RandomState(3)
    points = rng.uniform(-1, 1, (n, k, 3)).astype(np.float32)
    _, dirs = points_and_dirs(4, n)
    # Zero deltas in padding slots, as the occupancy path passes them.
    deltas = (rng.rand(n, k) * 0.1 * (rng.rand(n, k) < 0.8)).astype(np.float32)
    out = fr.fused_render_reference(model.packed(), t(points), t(dirs), t(deltas))
    ref = fused_render_tiles(
        jax_pack(tree, **layers), jnp.asarray(points), jnp.asarray(dirs),
        jnp.asarray(deltas), interpret=True, **layers,
    )
    assert out.shape == (n, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)
    # Background weights are transmittances in (0, 1].
    assert (out[:, 3] > 0).all() and (out[:, 3] <= 1).all()


def test_bf16_model_matches_flax_bf16_model():
    flax_model = FlaxNeRFModel(compute_dtype="bfloat16")
    x, d = points_and_dirs(5, 300)
    params = flax_model.init(
        dict(params=jax.random.PRNGKey(0)), jnp.asarray(x[:1]), jnp.asarray(d[:1])
    )["params"]
    density_ref, rgb_ref, _ = flax_model.apply(dict(params=params), jnp.asarray(x), jnp.asarray(d))
    model = port_model(jax.device_get(params), "bfloat16")
    with torch.no_grad():  # the fused route serves; it refuses to build a graph
        density, rgb, aux = model(t(x), t(d))
    assert aux == {} and density.shape == (300, 1) and rgb.shape == (300, 3)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref, np.float32), atol=5e-3)
    np.testing.assert_allclose(
        density.numpy(), np.asarray(density_ref, np.float32), rtol=2e-2, atol=5e-3
    )


def test_packed_layout_pads_with_zeros_and_splits_concats():
    tree = random_flax_tree(6, input_layers=2, mid_layers=2, hidden=40, color=20)
    packed = port_model(tree, "bfloat16", input_layers=2, mid_layers=2).packed()
    assert (packed.hidden, packed.color) == (48, 32)  # padded to 16
    assert packed.weights.dtype == torch.bfloat16 and packed.biases.dtype == torch.float32
    shapes = packed.matrix_shapes()
    assert shapes == [
        (64, 48), (48, 48), (48, 48), (64, 48), (48, 48), (48, 16), (48, 32), (32, 32), (32, 16)
    ]
    assert packed.weights.numel() == sum(k * n for k, n in shapes)
    assert packed.biases.numel() == sum(packed.bias_sizes())
    mats = list(packed.matrices())
    skip = tree["Dense_2"]["kernel"]  # [40 + 60, 40]
    np.testing.assert_array_equal(
        mats[2][:40, :40].float().numpy(), t(skip[:40]).bfloat16().float().numpy()
    )
    np.testing.assert_array_equal(
        mats[3][:60, :40].float().numpy(), t(skip[40:]).bfloat16().float().numpy()
    )
    assert all(m.float().abs().sum() > 0 for m in mats)
    assert mats[0][60:].float().abs().sum() == 0 and mats[0][:, 40:].float().abs().sum() == 0
    assert mats[5][:, 1:].float().abs().sum() == 0  # density head: column 0 only
    assert mats[8][:, 3:].float().abs().sum() == 0  # rgb head: columns 0-2 only


def test_packed_weights_follow_weight_updates():
    model = port_model(random_flax_tree(7, input_layers=1, mid_layers=1, hidden=16, color=16),
                       "bfloat16", input_layers=1, mid_layers=1)
    first = model.packed()
    assert model.packed() is first  # cached while the weights are unchanged
    with torch.no_grad():
        model.rgb.bias.add_(1.0)
    assert model.packed() is not first


def test_wrappers_take_the_plain_version_for_cpu_tensors_only():
    model = port_model(random_flax_tree(8, input_layers=1, mid_layers=1, hidden=16, color=16),
                       "bfloat16", input_layers=1, mid_layers=1)
    packed = model.packed()
    fm.counter.reset()
    fr.counter.reset()
    x, d = points_and_dirs(9, 10)
    density, rgb = fm.fused_mlp(packed, t(x).reshape(2, 5, 3), t(d).reshape(2, 5, 3))
    assert density.shape == (2, 5, 1) and rgb.shape == (2, 5, 3)
    out = fr.fused_render(packed, t(x).reshape(2, 5, 3), t(d)[:2], torch.full((2, 5), 0.1))
    assert out.shape == (2, 4)
    assert (fm.counter.plain_calls, fm.counter.launches) == (1, 0)
    assert (fr.counter.plain_calls, fr.counter.launches) == (1, 0)
    # No CPU fallback inside the kernel entry points: they refuse CPU tensors.
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fm.fused_mlp_cuda(packed, t(x), t(d))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        fr.fused_render_cuda(packed, t(x).reshape(2, 5, 3), t(d)[:2], torch.ones(2, 5))
    assert fm.counter.launches == 0 and fr.counter.launches == 0
