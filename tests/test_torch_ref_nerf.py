"""The port's Ref-NeRF models (``learn_nerf_tpu_torch.models.ref_nerf``,
``models.instant_ngp.InstantNGPRefNeRFModel``) and the hash-grid
encoding's gradient in the points (``ops.hashgrid.hash_grid_encode_dx``,
``kernels.hashgrid_dx``) against learn_nerf_tpu, on the CPU at a small
size (vanilla: 2 + 2 layers of 32, a 16-wide directional branch; the
hybrid: 3 smooth levels of 2^10 rows, 32-wide MLPs; SH degree 4).

Both packages get the same NumPy-seeded weights through the checkpoint
bridge.  Held here:

* density, rgb and both aux losses against the JAX models and the two
  golden checkpoints' outputs, within 1e-5 absolute and relative (measured
  up to 7.2e-7 on density and rgb, 5.5e-6 on a ``normal_mse`` of values up
  to 4), with grad, under ``torch.no_grad()`` and under
  ``torch.inference_mode()``;
* the gradient of an aux-weighted loss in every parameter against
  ``jax.grad`` through the JAX model's ``jax.vjp``, within 4e-6 + 2e-5 *
  the tensor's max (measured up to 1.2e-6 absolute, 5.4e-6 of a tensor's
  max), at the train loops' weights and with ``normal_mse`` alone;
* points exactly on the bbox's faces, where JAX's ``clip`` gives half the
  slope and ``torch.clamp`` the whole: the port's normal follows JAX's;
* the plain points-VJP and its backward under ``gradcheck`` and
  ``gradgradcheck`` in f64, and the explicit backward against autograd;
* :class:`~learn_nerf_tpu_torch.kernels.hashgrid_dx.HashGridDx` with its
  launchers faked: gradients reach the cotangent and the tables, a
  detached launch is caught, points that require grad raise;
* a ``TrainLoop`` step of each model against the JAX loop's (its logged
  dict), and the hybrid's occupancy loss and gradients, dense and pooled,
  against the JAX loop's loss functions, each within about three times
  its measured error; an ``OccupancyTrainLoop`` step of the hybrid, dense
  then pooled; the JAX widths that ``create_model`` builds.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu import render as jrender
from learn_nerf_tpu import train as jtrain
from learn_nerf_tpu.models import InstantNGPRefNeRFModel as FlaxHybrid
from learn_nerf_tpu.models import RefNeRFModel as FlaxRefNeRF
from learn_nerf_tpu.ops import hashgrid as jhash
from learn_nerf_tpu.scripts.common import create_model as jax_create_model
from learn_nerf_tpu_torch import checkpoint, occ_render, render, train
from learn_nerf_tpu_torch.data.dataset import ModelMetadata
from learn_nerf_tpu_torch.kernels import hashgrid_dx as kd
from learn_nerf_tpu_torch.models import InstantNGPRefNeRFModel, RefNeRFModel
from learn_nerf_tpu_torch.ops import hashgrid
from learn_nerf_tpu_torch.scripts import common, train_nerf

from .test_torch_train import grid_densities, grid_states, grids, loss_draws, ray_batch
from .test_torch_train_hierarchy import COARSE_TS, FINE_TS, PENALTY_BATCH, jax_draws
from .torch_helpers import points_and_dirs, t

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BBOX = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
VANILLA = dict(sh_degree=4, input_layers=2, mid_layers=2, hidden_dim=32, color_layer_dim=16)
HYBRID = dict(sh_degree=4, table_sizes=[2**10] * 3, grid_sizes=[4, 8, 32], hidden_dim=32)
HYBRID_COARSE = dict(sh_degree=4, table_sizes=[2**10] * 2, grid_sizes=[4, 8], hidden_dim=16)
NGP_ADAM = dict(adam_eps=1e-15, adam_b1=0.9, adam_b2=0.99)
OUTPUT_BOUND = 1e-5
CANDIDATES, SAMPLES = 16, 4


def randomized(tree, seed, table_scale=1.0):
    """``tree`` with every kernel, bias and table drawn from a NumPy seed:
    lecun-normal kernels, small nonzero biases, uniform tables."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, value in sorted(tree.items()):
        if name == "HashGridEncoding_0":
            out[name] = {k: (table_scale * rng.uniform(-1, 1, v.shape)).astype(np.float32)
                         for k, v in sorted(value.items())}
        else:
            fan_in = value["kernel"].shape[0]
            out[name] = dict(kernel=(rng.randn(*value["kernel"].shape) / np.sqrt(fan_in)).astype(np.float32),
                             bias=(0.1 * rng.randn(*value["bias"].shape)).astype(np.float32))
    return out


def flax_model(kind, config=None):
    if kind == "vanilla":
        return FlaxRefNeRF(**(config or VANILLA))
    return FlaxHybrid(**(config or HYBRID), **BBOX)


def port_model(kind, tree, config=None):
    config = dict(config or (VANILLA if kind == "vanilla" else HYBRID))
    if kind == "vanilla":
        model = RefNeRFModel(**config)
    else:
        model = InstantNGPRefNeRFModel(**config, **BBOX)
    model.load_state_dict(checkpoint.model_params_from_flax(tree, **model.flax_layout()))
    return model


def flax_tree(kind, seed, config=None, table_scale=1.0):
    zeros = jnp.zeros((1, 3))
    params = jax.jit(flax_model(kind, config).init)(dict(params=jax.random.PRNGKey(seed)), zeros, zeros + 1.0)
    return randomized(jax.tree_util.tree_map(np.asarray, params["params"]), seed, table_scale)


@pytest.fixture(scope="module", params=["vanilla", "hybrid"])
def kind(request):
    return request.param


@pytest.fixture(scope="module")
def tree(kind):
    return flax_tree(kind, 3)


def jax_outputs(kind, tree, x, d):
    density, rgb, aux = jax.jit(flax_model(kind).apply)(dict(params=tree), jnp.asarray(x), jnp.asarray(d))
    return [np.asarray(v) for v in (density, rgb, aux["normal_mse"], aux["neg_normal"])]


def port_outputs(model, x, d):
    density, rgb, aux = model(t(x), t(d))
    return [v.detach().numpy() for v in (density, rgb, aux["normal_mse"], aux["neg_normal"])]


def test_models_match_jax(kind, tree):
    x, d = points_and_dirs(11, 257, scale=1.1)
    model = port_model(kind, tree)
    want = jax_outputs(kind, tree, x, d)
    for grad_mode in (torch.enable_grad, torch.no_grad, torch.inference_mode):
        with grad_mode():
            got = port_outputs(model, x, d)
        for name, a, b in zip(("density", "rgb", "normal_mse", "neg_normal"), got, want):
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a, b, rtol=OUTPUT_BOUND, atol=OUTPUT_BOUND, err_msg=f"{name} {grad_mode}")


def test_leading_dims_and_the_channel_check(kind, tree):
    x, d = points_and_dirs(12, 24)
    model = port_model(kind, tree)
    density, rgb, aux = model(t(x).view(4, 6, 3), t(d).view(4, 6, 3))
    assert density.shape == (4, 6, 1) and rgb.shape == (4, 6, 3) and aux["normal_mse"].shape == (4, 6)
    narrow = RefNeRFModel(sh_degree=4, input_layers=1, mid_layers=1, hidden_dim=8, color_layer_dim=8)
    with pytest.raises(ValueError, match="must emit >= 9"):
        narrow(t(x), t(d))


@pytest.mark.parametrize("name", ["vanilla", "hybrid"])
def test_golden_checkpoints_reproduce_their_outputs(name):
    """The reference implementation's pickles (the hybrid's in its
    ``MultiresHashTableEncoding`` layout, renamed on load) and outputs."""
    prefix = "refnerf" if name == "vanilla" else "ngp_refnerf"
    g = np.load(os.path.join(GOLDEN, f"{prefix}_reference_outputs.npz"))
    params = checkpoint.load_params_pickle(os.path.join(GOLDEN, f"{prefix}_reference_checkpoint.pkl"))
    if name == "vanilla":
        model = RefNeRFModel(**VANILLA)
    else:
        bbox = dict(bbox_min=tuple(g["bbox_min"].tolist()), bbox_max=tuple(g["bbox_max"].tolist()))
        model = InstantNGPRefNeRFModel(**HYBRID, **bbox)
    state = checkpoint.checkpoint_from_flax(params, **model.flax_layout())
    model.load_state_dict(state["fine"])
    with torch.inference_mode():
        got = port_outputs(model, g["x"], g["d"])
    for key, value in zip(("density", "rgb", "normal_mse", "neg_normal"), got):
        np.testing.assert_allclose(value, g[key], rtol=OUTPUT_BOUND, atol=OUTPUT_BOUND, err_msg=key)


def weighted_loss(density, rgb, aux, target, weights):
    return ((rgb - target) ** 2).mean() + 0.01 * density.mean() + weights[0] * aux["normal_mse"].mean() \
        + weights[1] * aux["neg_normal"].mean()


@pytest.mark.parametrize("weights", [(3e-4, 0.1), (1.0, 0.0)], ids=["loop weights", "normal_mse alone"])
def test_aux_loss_gradients_match_jax_grad_through_vjp(kind, tree, weights):
    x, d = points_and_dirs(13, 193, scale=1.1)
    target = np.random.RandomState(14).uniform(-1, 1, (len(x), 3)).astype(np.float32)
    flax = flax_model(kind)

    def jax_loss(params):
        density, rgb, aux = flax.apply(dict(params=params), jnp.asarray(x), jnp.asarray(d))
        return weighted_loss(density, rgb, aux, jnp.asarray(target), weights)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(tree)
    model = port_model(kind, tree)
    density, rgb, aux = model(t(x), t(d))
    loss = weighted_loss(density, rgb, aux, t(target), weights)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    want = checkpoint.model_params_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads), **model.flax_layout())
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        assert got[name] is not None and got[name].abs().max() > 0, name
        bound = 4e-6 + 2e-5 * ref.abs().max().item()
        assert (got[name] - ref).abs().max().item() <= bound, name


def test_points_on_the_bbox_faces_get_jax_normals():
    """On a face JAX's clip gives half the slope along that axis; autograd
    of the plain encode (``torch.clamp``) gives the whole.  The points-VJP
    and the hybrid's aux follow JAX there."""
    rng = np.random.RandomState(15)
    x = rng.uniform(-1, 1, (96, 3)).astype(np.float32)
    x[np.arange(96), np.arange(96) % 3] = np.where(np.arange(96) % 2 == 0, -1.0, 1.0)
    x[:8] = np.array([[-1, -1, -1], [1, 1, 1], [-1, 1, -1], [1, -1, 1]] * 2, np.float32)
    x = x.astype(np.float32)
    grids_, sizes = HYBRID["grid_sizes"], HYBRID["table_sizes"]
    tables = [rng.uniform(-1, 1, (hashgrid.dense_level_rows(g, s), 2)).astype(np.float32)
              for g, s in zip(grids_, sizes)]
    g = rng.randn(len(x), 2 * len(grids_)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jhash.hash_grid_encode([jnp.asarray(v) for v in tables], xx, grids_, sizes,
                                                       jnp.asarray(BBOX["bbox_min"]), jnp.asarray(BBOX["bbox_max"]),
                                                       smooth=True), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = hashgrid.hash_grid_encode_dx(
        [t(v) for v in tables], t(x), t(g), grids_, sizes, BBOX["bbox_min"], BBOX["bbox_max"], smooth=True).numpy()
    assert np.abs(got - want).max() <= 4e-7 * np.abs(want).max()  # measured 1.1e-7
    xr = t(x).requires_grad_()
    hashgrid.hash_grid_encode_reference([t(v) for v in tables], xr, grids_, sizes, BBOX["bbox_min"],
                                        BBOX["bbox_max"], smooth=True).backward(t(g))
    assert np.abs(xr.grad.numpy() - want).max() > 0.1 * np.abs(want).max()  # clamp's slope on the faces

    tree = flax_tree("hybrid", 16)
    d = points_and_dirs(17, len(x))[1]
    np.testing.assert_allclose(port_outputs(port_model("hybrid", tree), x, d)[2], jax_outputs("hybrid", tree, x, d)[2],
                               rtol=OUTPUT_BOUND, atol=OUTPUT_BOUND)


# -- the plain points-VJP and its backward -------------------------------


def small_levels(seed, dtype=torch.float64, features=2):
    rng = np.random.RandomState(seed)
    grids_, sizes = [3, 5, 9], [64, 2**10, 64]  # dense, dense, hashed
    tables = [t(rng.uniform(-1, 1, (hashgrid.dense_level_rows(g, s), features))).to(dtype)
              for g, s in zip(grids_, sizes)]
    x = t(rng.uniform(-0.95, 0.95, (7, 3))).to(dtype)
    g = t(rng.randn(7, features * len(grids_))).to(dtype)
    return tables, x, g, grids_, sizes


@pytest.mark.parametrize("smooth", [False, True])
def test_plain_points_vjp_passes_gradcheck_and_gradgradcheck(smooth):
    tables, x, g, grids_, sizes = small_levels(18)

    def dx(g, *tables):
        return hashgrid.hash_grid_encode_dx_reference(list(tables), x, g, grids_, sizes, BBOX["bbox_min"],
                                                      BBOX["bbox_max"], smooth)

    inputs = (g.requires_grad_(), *(v.requires_grad_() for v in tables))
    assert torch.autograd.gradcheck(dx, inputs)
    assert torch.autograd.gradgradcheck(dx, inputs)


@pytest.mark.parametrize("smooth", [False, True])
def test_explicit_backward_equals_autograd_of_the_points_vjp(smooth):
    tables, x, g, grids_, sizes = small_levels(19)
    h = t(np.random.RandomState(20).randn(len(x), 3))
    leaves = [g.requires_grad_(), *(v.requires_grad_() for v in tables)]
    out = hashgrid.hash_grid_encode_dx_reference(tables, x, g, grids_, sizes, BBOX["bbox_min"], BBOX["bbox_max"],
                                                 smooth)
    want = torch.autograd.grad(out, leaves, h)
    grad_g, grad_tables = hashgrid.hash_grid_encode_dx_backward_reference(
        tables, x, g.detach(), h, grids_, sizes, BBOX["bbox_min"], BBOX["bbox_max"], smooth)
    for a, b in zip([grad_g, *grad_tables], want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


# -- HashGridDx's wiring with its launchers faked --------------------------


class _FakeArgs:
    def __init__(self, tables, grids_, sizes, smooth):
        self.tables, self.grids, self.sizes, self.smooth = list(tables), grids_, sizes, smooth


@pytest.fixture
def faked_dx_route(monkeypatch):
    """The CUDA route of hashgrid_dx with plain launchers swapped in."""
    monkeypatch.setattr(kd, "encode_args",
                        lambda tables, device, grids_, sizes, lo, hi, smooth: _FakeArgs(tables, grids_, sizes, smooth))

    def launch(args, x, g):
        with torch.no_grad():  # as the kernel: a result with no graph
            return hashgrid.hash_grid_encode_dx_reference(args.tables, x, g, args.grids, args.sizes,
                                                          BBOX["bbox_min"], BBOX["bbox_max"], args.smooth)

    def backward(args, x, g, h):
        with torch.no_grad():
            return hashgrid.hash_grid_encode_dx_backward_reference(args.tables, x, g, h, args.grids, args.sizes,
                                                                   BBOX["bbox_min"], BBOX["bbox_max"], args.smooth)

    monkeypatch.setattr(kd, "_cuda_launcher", launch)
    monkeypatch.setattr(kd, "_backward_launcher", backward)


def test_dx_function_reaches_the_cotangent_and_the_tables(faked_dx_route):
    tables, x, g, grids_, sizes = small_levels(21, torch.float32)
    params = [torch.nn.Parameter(v) for v in tables]
    cot = g.clone().requires_grad_()
    out = kd._dx_on_card(params, x, cot, grids_, sizes, BBOX["bbox_min"], BBOX["bbox_max"], True)
    assert out.grad_fn is not None
    h = t(np.random.RandomState(22).randn(len(x), 3).astype(np.float32))
    out.backward(h)
    got = [cot.grad.clone()] + [p.grad.clone() for p in params]
    assert all(v.abs().max() > 0 for v in got)
    leaves = [g.clone().requires_grad_()] + [v.clone().requires_grad_() for v in tables]
    ref = hashgrid.hash_grid_encode_dx_reference(leaves[1:], x, leaves[0], grids_, sizes, BBOX["bbox_min"],
                                                 BBOX["bbox_max"], True)
    for a, b in zip(got, torch.autograd.grad(ref, leaves, h)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # Only what requires grad gets one; nothing is saved with grad off.
    frozen = [params[0].detach(), *params[1:]]
    kd._dx_on_card(frozen, x, g, grids_, sizes, BBOX["bbox_min"], BBOX["bbox_max"], True).sum().backward()
    with torch.no_grad():
        assert kd._dx_on_card(params, x, cot, grids_, sizes, BBOX["bbox_min"], BBOX["bbox_max"], True).grad_fn is None


def test_dx_function_catches_a_detached_launch_and_refuses_points_that_require_grad(faked_dx_route):
    """The trap HashGridDx closes: the launch returns a tensor with no
    graph, which would train nothing behind it; through the Function the
    tables train.  Points that require grad raise."""
    tables, x, g, grids_, sizes = small_levels(23, torch.float32)
    params = [torch.nn.Parameter(v) for v in tables]
    raw = kd._cuda_launcher(_FakeArgs(params, grids_, sizes, False), x, g)
    assert raw.grad_fn is None
    out = kd._dx_on_card(params, x, g, grids_, sizes, BBOX["bbox_min"], BBOX["bbox_max"], False)
    out.sum().backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0 for p in params)
    with pytest.raises(NotImplementedError, match="points"):
        kd.hashgrid_dx(params, x.clone().requires_grad_(), g, grids_, sizes, (-1,) * 3, (1,) * 3, False)


def test_plain_route_counts_its_calls():
    tables, x, g, grids_, sizes = small_levels(24, torch.float32)
    before = (kd.counter.plain_calls, kd.counter.launches)
    kd.hashgrid_dx(tables, x, g, grids_, sizes, BBOX["bbox_min"], BBOX["bbox_max"], True)
    assert (kd.counter.plain_calls, kd.counter.launches) == (before[0] + 1, before[1])


# -- the train loops -----------------------------------------------------


def hierarchy_trees(kind, seed):
    if kind == "vanilla":
        return flax_tree("vanilla", seed), flax_tree("vanilla", seed + 1)
    return (flax_tree("hybrid", seed, HYBRID_COARSE, table_scale=0.5),
            flax_tree("hybrid", seed + 1, dict(HYBRID, hidden_dim=16), table_scale=0.5))


def hierarchy_configs(kind):
    return (None, None) if kind == "vanilla" else (HYBRID_COARSE, dict(HYBRID, hidden_dim=16))


def jax_hierarchy_step(kind, density_penalty):
    """The JAX hierarchy loop's step body (``_grad_step`` over
    ``compute_losses``), jitted without its mesh."""
    coarse_cfg, fine_cfg = hierarchy_configs(kind)
    renderer = jrender.Renderer(coarse=flax_model(kind, coarse_cfg), fine=flax_model(kind, fine_cfg),
                                coarse_ts=COARSE_TS, fine_ts=FINE_TS, **BBOX)
    loss_fn = functools.partial(jtrain.compute_losses, renderer, loss_weights=jtrain.default_loss_weights(),
                                density_penalty=density_penalty, density_penalty_batch_size=PENALTY_BATCH)
    return jax.jit(lambda state, key, batch: jtrain._grad_step(loss_fn, state, None, key=key, batch=batch))


# The aux terms of the vanilla model's fine pass: its fine samples follow
# the coarse weights, which the two packages round apart in the last
# place, and the normal differentiates sin(2^9 x): over seeds 30-32 the
# terms differed by up to 1.3e-5 (first step) and 2.1e-4 (second step),
# relative; the hybrid's by under 1e-6.  The bounds are about three times
# that; every other logged value keeps 1e-5 and 1e-4.
AUX_STEP_BOUNDS = (4e-5, 6e-4)


def test_train_loop_step_matches_jax(kind):
    """Two steps' logged dicts (the losses with both aux terms of each pass,
    grad_norm, param_norm): the first within 1e-5, the second, on the
    updated parameters, within 1e-4 (Adam's first updates are about
    ``lr * sign(g)``); the aux terms within AUX_STEP_BOUNDS."""
    coarse_tree, fine_tree = hierarchy_trees(kind, 30)
    adam = NGP_ADAM if kind == "hybrid" else {}
    params = dict(coarse=jax.tree_util.tree_map(jnp.asarray, coarse_tree),
                  fine=jax.tree_util.tree_map(jnp.asarray, fine_tree), background=jnp.array([-1.0, -1.0, -1.0]))
    tx = optax.adam(1e-3, b1=adam.get("adam_b1", 0.9), b2=adam.get("adam_b2", 0.999), eps=adam.get("adam_eps", 1e-7))
    state = jtrain.EmaTrainState.create(apply_fn=None, params=params, tx=tx)
    step_fn = jax_hierarchy_step(kind, 0.05)
    coarse_cfg, fine_cfg = hierarchy_configs(kind)
    loop = train.TrainLoop(port_model(kind, coarse_tree, coarse_cfg), port_model(kind, fine_tree, fine_cfg), lr=1e-3,
                           coarse_ts=COARSE_TS, fine_ts=FINE_TS, density_penalty=0.05,
                           density_penalty_batch_size=PENALTY_BATCH, **BBOX, **adam)
    for step in range(2):
        key = jax.random.PRNGKey(40 + step)
        batch = ray_batch(41 + step)
        state, ref = step_fn(state, key, jnp.asarray(batch))
        ref = {k: float(v) for k, v in ref.items()}
        got = {k: float(v) for k, v in loop.step(batch, **jax_draws(key)).items()}
        assert sorted(got) == sorted(ref) and "fine_normal_mse" in got and "coarse_neg_normal" in got
        for name, value in ref.items():
            bound = AUX_STEP_BOUNDS[step] if name.endswith("normal") or name.endswith("normal_mse") else (
                1e-5 if step == 0 else 1e-4)
            np.testing.assert_allclose(got[name], value, rtol=bound, err_msg=f"step {step}: {name}")


@pytest.fixture(scope="module")
def occupancy_tree():
    return flax_tree("hybrid", 50, dict(HYBRID, hidden_dim=16), table_scale=0.5)


@pytest.mark.parametrize("budget", [None, 64 * SAMPLES, 60], ids=["dense", "pooled", "pooled, dropping"])
def test_occupancy_losses_and_gradients_match_jax(occupancy_tree, budget):
    config = dict(HYBRID, hidden_dim=16)
    jgrid, pgrid = grids()
    renderer = jocc.OccupancyRenderer(model=flax_model("hybrid", config), grid=jgrid, candidates=CANDIDATES,
                                      samples=SAMPLES, **BBOX)

    def loss(params, key, batch, grid_state):
        kw = dict(density_penalty=0.1, density_penalty_batch_size=32)
        if budget is None:
            return jtrain.compute_losses_occupancy(renderer, params, key, batch, grid_state,
                                                   jtrain.default_loss_weights(), **kw)
        return jtrain.compute_losses_occupancy_pooled(renderer, params, key, batch, grid_state,
                                                      jtrain.default_loss_weights(), budget=budget, **kw)

    batch = ray_batch(51)
    background = np.array([-1.0, 0.2, 0.7], np.float32)
    jstate, pstate = grid_states(grid_densities(52), step=16)
    key = jax.random.PRNGKey(53)
    (ref_total, ref_dict), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        dict(fine=occupancy_tree, background=jnp.asarray(background)), key, jnp.asarray(batch), jstate)

    model = port_model("hybrid", occupancy_tree, config)
    port_renderer = occ_render.OccupancyRenderer(model=model, grid=pgrid, candidates=CANDIDATES, samples=SAMPLES,
                                                 **BBOX)
    bg = t(background).requires_grad_()
    u, density_draws = loss_draws(key)
    args = (port_renderer, bg, t(batch), pstate, train.default_loss_weights())
    kw = dict(density_penalty=0.1, density_penalty_batch_size=32, u=u, density_draws=density_draws)
    if budget is None:
        total, loss_dict = train.compute_losses_occupancy(*args, **kw)
    else:
        total, loss_dict = train.compute_losses_occupancy_pooled(*args, budget, **kw)
    total.backward()
    # Measured: the loss within 6.1e-8 and each term within 3.5e-7
    # (relative); gradients within 3.0e-8 absolute and 4.1e-6 of a tensor's
    # max, the background's within 6.0e-8.  The bounds are about three
    # times that.
    assert sorted(loss_dict) == sorted(ref_dict) and "fine_normal_mse" in loss_dict
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=2e-7)
    for name, value in ref_dict.items():
        np.testing.assert_allclose(loss_dict[name].item(), float(value), rtol=1e-6, atol=1e-7, err_msg=name)
    want = checkpoint.ngp_params_from_flax(jax.tree_util.tree_map(np.asarray, ref_grads["fine"]))
    for name, ref in want.items():
        grad = dict(model.named_parameters())[name].grad
        assert grad is not None and grad.abs().max() > 0, name
        assert (grad - ref).abs().max().item() <= 1e-7 + 1.5e-5 * ref.abs().max().item(), name
    assert np.abs(bg.grad.numpy() - np.asarray(ref_grads["background"])).max() <= 2e-7


def test_occupancy_loop_takes_a_step(occupancy_tree):
    """OccupancyTrainLoop.step on the hybrid, dense and then pooled: both
    aux terms logged, every parameter moved."""
    model = port_model("hybrid", occupancy_tree, dict(HYBRID, hidden_dim=16))
    loop = train.OccupancyTrainLoop(model, lr=1e-3, candidates=CANDIDATES, samples=SAMPLES, grid_resolution=16,
                                    pool_budget_per_ray=4.0, pool_start_step=1, **BBOX, **NGP_ADAM)
    before = [p.detach().clone() for p in model.parameters()]
    for step in range(2):
        values = loop.step_auto(step, ray_batch(60 + step))
        assert {"fine_normal_mse", "fine_neg_normal"} <= set(values)
        assert ("fine_pool_dropped" in values) == (step == 1)
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


# -- create_model and the weight bridge ------------------------------------


@pytest.mark.parametrize("flags", [["--ref_nerf"], ["--instant_ngp", "--ref_nerf"], ["--ref_nerf", "--bf16"]])
def test_create_model_builds_the_jax_widths(flags):
    """The JAX CLI's models, f32 whatever --bf16 says: every Dense and table
    of the port's trees has the JAX tree's shape (RefNeRFModel: Dense_5
    [316, 256], Dense_9 [273, 128]; the hybrid: 16 smooth fine levels,
    Dense_2 [33, 64]), and the hybrid trains with the NGP Adam settings."""
    args = train_nerf.build_parser().parse_args([*flags, "data"])
    metadata = ModelMetadata(bbox_min=(-1.5,) * 3, bbox_max=(1.5,) * 3)
    coarse, fine, kwargs = common.create_model(args, metadata)
    jax_coarse, jax_fine, jax_kwargs = jax_create_model(args, metadata)
    assert kwargs == jax_kwargs
    zeros = jnp.zeros((1, 3))
    for port, flax in ((coarse, jax_coarse), (fine, jax_fine)):
        shapes = jax.eval_shape(lambda: flax.init(jax.random.PRNGKey(0), zeros, zeros))["params"]
        want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
        tree = checkpoint.checkpoint_to_flax(dict(fine=port.state_dict()), **port.flax_layout())["fine"]
        assert jax.tree_util.tree_map(np.shape, tree) == want
        assert all(p.dtype == torch.float32 for p in port.parameters())
    if "--instant_ngp" in flags:
        assert isinstance(fine, InstantNGPRefNeRFModel) and fine.encoding.smooth
        assert len(fine.encoding.grid_sizes) == 16 and kwargs == NGP_ADAM
    else:
        assert isinstance(fine, RefNeRFModel)
        assert fine.mid_layers[0].weight.shape == (256, 316) and fine.color.weight.shape == (128, 273)


def test_weight_bridge_round_trips_both_trees(kind, tree):
    model = port_model(kind, tree)
    back = checkpoint.checkpoint_to_flax(dict(fine=model.state_dict()), **model.flax_layout())["fine"]
    assert jax.tree_util.tree_map(np.shape, back) == jax.tree_util.tree_map(np.shape, tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
