"""The port's NeRFModel and checkpoint bridge against flax: the weight
bridge round-trips exactly, and the f32 model matches flax within 1e-5 on
the golden vanilla params (coarse hidden 32, fine hidden 48, color 16)."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu.models import NeRFModel as FlaxNeRFModel
from learn_nerf_tpu_torch import checkpoint
from learn_nerf_tpu_torch.models import NeRFModel

from .torch_helpers import points_and_dirs, port_model, random_flax_tree, t

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_WIDTHS = {"coarse": (32, 16), "fine": (48, 16)}


@pytest.fixture(scope="module")
def golden_params():
    return checkpoint.load_params_pickle(os.path.join(GOLDEN, "vanilla_params.pkl"))


@pytest.mark.parametrize("which", ["coarse", "fine"])
def test_weight_bridge_round_trips_exactly(golden_params, which):
    tree = golden_params[which]
    state = checkpoint.params_from_flax(tree)
    back = checkpoint.params_to_flax(state)
    assert back.keys() == tree.keys()
    for name, layer in tree.items():
        np.testing.assert_array_equal(back[name]["kernel"], layer["kernel"])
        np.testing.assert_array_equal(back[name]["bias"], layer["bias"])
    # Flax kernel [in, out] is torch weight [out, in].
    np.testing.assert_array_equal(state["skip.weight"].numpy(), tree["Dense_5"]["kernel"].T)


def test_dense_names_map_one_submodule_each():
    model = NeRFModel()
    names = checkpoint.dense_names()
    assert names[5] == "skip" and names[9:] == ["density", "color", "rgb"]
    assert [n for n, _ in model.named_children()] == [
        "input_layers", "skip", "mid_layers", "density", "color", "rgb"
    ]
    layers = dict(model.named_modules())
    assert [layers[n] for n in names] == model.dense_layers()
    assert sorted(model.state_dict()) == sorted(
        f"{n}.{p}" for n in names for p in ("weight", "bias")
    )


@pytest.mark.parametrize("which", ["coarse", "fine"])
def test_f32_model_matches_flax_on_golden_params(golden_params, which):
    hidden, color = GOLDEN_WIDTHS[which]
    tree = golden_params[which]
    x, d = points_and_dirs(0, 200, scale=2.0)
    ref_density, ref_rgb, _ = FlaxNeRFModel(hidden_dim=hidden, color_layer_dim=color).apply(
        dict(params=tree), jnp.asarray(x), jnp.asarray(d)
    )
    model = port_model(tree)
    with torch.no_grad():
        density, rgb, aux = model(t(x), t(d))
    assert aux == {}
    np.testing.assert_allclose(density.numpy(), np.asarray(ref_density), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb), rtol=1e-5, atol=1e-5)


def test_model_takes_any_leading_dims():
    model = port_model(random_flax_tree(1, hidden=32, color=16))
    x, d = points_and_dirs(2, 24)
    with torch.no_grad():
        flat = model(t(x), t(d))
        shaped = model(t(x).reshape(2, 3, 4, 3), t(d).reshape(2, 3, 4, 3))
    assert shaped[0].shape == (2, 3, 4, 1) and shaped[1].shape == (2, 3, 4, 3)
    torch.testing.assert_close(shaped[0].reshape(-1, 1), flat[0])
    torch.testing.assert_close(shaped[1].reshape(-1, 3), flat[1])


def test_model_rejects_unknown_compute_dtype():
    with pytest.raises(ValueError):
        NeRFModel(compute_dtype="float16")


def test_checkpoint_round_trip_passes_through_background_and_grid(tmp_path):
    tree = random_flax_tree(3, hidden=32, color=16)
    densities = np.random.RandomState(4).rand(8**3).astype(np.float32)
    params = dict(
        coarse=tree, fine=tree, background=np.array([0.1, 0.2, 0.3], np.float32),
        occupancy_densities=densities, occupancy_resolution=8,
    )
    path = str(tmp_path / "ckpt.pkl")
    checkpoint.save_params_pickle(path, params)
    ckpt = checkpoint.checkpoint_from_flax(checkpoint.load_params_pickle(path))
    assert set(ckpt) == set(params)
    assert isinstance(ckpt["fine"]["rgb.weight"], torch.Tensor)
    np.testing.assert_array_equal(ckpt["occupancy_densities"], densities)
    assert ckpt["occupancy_resolution"] == 8
    back = checkpoint.checkpoint_to_flax(ckpt)
    np.testing.assert_array_equal(back["background"], params["background"])
    for name in tree:
        np.testing.assert_array_equal(back["coarse"][name]["kernel"], tree[name]["kernel"])


def test_golden_pickle_loads_without_jax_and_jax_pickles_are_refused(tmp_path):
    # The guard: a pickle that stores jax arrays needs jax and says so.
    path = str(tmp_path / "jax.pkl")
    with open(path, "wb") as f:
        pickle.dump({"background": jnp.zeros(3)}, f)
    with pytest.raises(pickle.UnpicklingError, match="needs jax"):
        checkpoint.load_params_pickle(path)
    params = checkpoint.load_params_pickle(os.path.join(GOLDEN, "vanilla_params.pkl"))
    assert set(params) == {"background", "coarse", "fine"}
