"""The port's coarse/fine hierarchy training against learn_nerf_tpu, on the
CPU at a small size (vanilla: 2 + 2 layers of 32, a 16-wide colour branch;
NGP: 2 coarse and 4 fine hash levels of 2^10 rows, 16-wide MLPs; batch 64,
8 coarse + 8 fine samples).

Both packages get the same weights (flax trees through the checkpoint
bridge) and JAX's own uniforms (``u_coarse=``, ``u_fine=``,
``density_draws=``, reproduced from the key splits of
``learn_nerf_tpu.train.compute_losses`` and ``render.Renderer``).  Held
here:

* ``compute_losses``: every logged term within 1e-5 relative and every
  gradient within 1e-5 + 1e-4 * max of ``jax.grad``, vanilla and NGP, with
  the density penalty;
* the bf16 vanilla model's training route against flax's bf16 model:
  loss and gradients within BF16_LOSS_BOUND / BF16_GRAD_BOUND;
* one ``TrainLoop.step`` against the JAX loop's step body (its logged dict,
  and the next step's), ``step_auto_many`` bit for
  bit ``step_auto``, EMA in ``eval_losses``, the params pickle both ways;
* the fused bf16 route refusing gradients, and the loops selecting the
  flax-rounded route;
* ``train_nerf`` without ``--occupancy``: f32, ``--bf16`` and
  ``--instant_ngp``; ``profile_train --hierarchy``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learn_nerf_tpu import render as jrender
from learn_nerf_tpu import train as jtrain
from learn_nerf_tpu.checkpoint import load_params_pickle as jax_load_params_pickle
from learn_nerf_tpu.checkpoint import save_params_pickle as jax_save_params_pickle
from learn_nerf_tpu.models import InstantNGPModel as FlaxNGP
from learn_nerf_tpu.models import NeRFModel as FlaxNeRF
from learn_nerf_tpu_torch import checkpoint, render, train
from learn_nerf_tpu_torch.models import NeRFModel
from learn_nerf_tpu_torch.scripts import render_nerf, train_nerf

from .synthetic_scene import write_dataset
from .test_torch_ngp import flax_ngp_params, port_ngp
from .test_torch_train import ray_batch
from .torch_helpers import port_model, random_flax_tree, t

torch.set_num_threads(1)

BBOX = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
RAYS, COARSE_TS, FINE_TS, PENALTY_BATCH = 64, 8, 8, 32
VANILLA = dict(input_layers=2, mid_layers=2)
VANILLA_WIDTHS = dict(hidden_dim=32, color_layer_dim=16)
NGP_COARSE = dict(table_sizes=[2**10] * 2, grid_sizes=[4, 8], hidden_dim=16)
NGP_FINE = dict(table_sizes=[2**10] * 4, grid_sizes=[4, 8, 16, 32], hidden_dim=16)
NGP_ADAM = dict(adam_eps=1e-15, adam_b1=0.9, adam_b2=0.99)
# The bf16 training route against flax's bf16 model: both round operands,
# biases and layer outputs to bf16 and sum in f32 in another order, so a
# rounding may flip.  Over six seeds of these inputs the loss differed by
# 8e-6 to 1.0e-4 (relative) and all gradients together by 8.0e-3 to 1.6e-2
# (L2 norm of the difference over the norm of flax's): inside bf16's own
# noise, since flax's bf16 gradients sit 1.3e-2 to 1.9e-2 from its f32 ones.
# A single tensor's max is no measure here: a scalar bias's gradient is a
# cancelling sum, and flax's bf16 one is 28 % from its f32 one.  The bounds
# are about three times the largest measured.
BF16_LOSS_BOUND, BF16_GRAD_BOUND = 3e-4, 5e-2


def trees(kind, seed=0):
    """(coarse, fine) flax trees of the small models."""
    if kind == "vanilla":
        return (random_flax_tree(seed, hidden=32, color=16, **VANILLA),
                random_flax_tree(seed + 1, hidden=32, color=16, **VANILLA))
    coarse, fine = flax_ngp_params(seed, **NGP_COARSE), flax_ngp_params(seed + 1, **NGP_FINE)
    for tree in (coarse, fine):  # half-scale tables: densities of order one
        for name, table in tree["HashGridEncoding_0"].items():
            tree["HashGridEncoding_0"][name] = 0.5 * table
    return coarse, fine


def flax_models(kind, dtype="float32"):
    if kind == "vanilla":
        return (FlaxNeRF(**VANILLA, **VANILLA_WIDTHS, compute_dtype=dtype),
                FlaxNeRF(**VANILLA, **VANILLA_WIDTHS, compute_dtype=dtype))
    return FlaxNGP(**NGP_COARSE, **BBOX), FlaxNGP(**NGP_FINE, **BBOX)


def port_models(kind, coarse_tree, fine_tree, dtype="float32"):
    if kind == "vanilla":
        return port_model(coarse_tree, dtype, **VANILLA), port_model(fine_tree, dtype, **VANILLA)
    return port_ngp(coarse_tree, **NGP_COARSE), port_ngp(fine_tree, **NGP_FINE)


def state_of(kind, tree):
    return (checkpoint.params_from_flax(tree, **VANILLA) if kind == "vanilla"
            else checkpoint.ngp_params_from_flax(tree))


def jax_draws(key, n=RAYS):
    """What ``compute_losses`` draws from its key: the coarse and fine
    uniforms of the render, and the density penalty's uniforms and normals
    (one key)."""
    key, density_key = jax.random.split(key)
    coarse_key, fine_key = jax.random.split(key)
    return dict(
        u_coarse=t(np.asarray(jax.random.uniform(coarse_key, (n, COARSE_TS)))),
        u_fine=t(np.asarray(jax.random.uniform(fine_key, (n, FINE_TS)))),
        density_draws=(t(np.asarray(jax.random.uniform(density_key, (PENALTY_BATCH, 3)))),
                       t(np.asarray(jax.random.normal(density_key, (PENALTY_BATCH, 3))))),
    )


def jax_value_and_grad(kind, density_penalty, dtype="float32"):
    coarse, fine = flax_models(kind, dtype)
    renderer = jrender.Renderer(coarse=coarse, fine=fine, coarse_ts=COARSE_TS, fine_ts=FINE_TS, **BBOX)

    def loss(params, key, batch):
        return jtrain.compute_losses(renderer, params, key, batch, jtrain.default_loss_weights(),
                                     density_penalty=density_penalty,
                                     density_penalty_batch_size=PENALTY_BATCH)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def port_losses(kind, coarse_tree, fine_tree, background, batch, draws, density_penalty, dtype="float32"):
    coarse, fine = port_models(kind, coarse_tree, fine_tree, dtype)
    for model in (coarse, fine):
        if isinstance(model, NeRFModel):
            model.set_bf16_route("flax")
    renderer = render.Renderer(coarse=coarse, fine=fine, coarse_ts=COARSE_TS, fine_ts=FINE_TS, **BBOX)
    bg = t(background).requires_grad_()
    total, loss_dict = train.compute_losses(
        renderer, bg, t(batch), train.default_loss_weights(), density_penalty=density_penalty,
        density_penalty_batch_size=PENALTY_BATCH, **draws)
    total.backward()
    grads = {f"coarse.{k}": p.grad for k, p in coarse.named_parameters()}
    grads.update({f"fine.{k}": p.grad for k, p in fine.named_parameters()})
    grads["background"] = bg.grad
    return total, loss_dict, grads


def reference_grads(kind, ref_grads):
    out = {}
    for name in ("coarse", "fine"):
        tree = jax.tree_util.tree_map(np.asarray, ref_grads[name])
        out.update({f"{name}.{k}": v for k, v in state_of(kind, tree).items()})
    out["background"] = t(ref_grads["background"])
    return out


@pytest.mark.parametrize("kind", ["vanilla", "ngp"])
def test_compute_losses_matches_jax(kind, density_penalty=0.1):
    coarse_tree, fine_tree = trees(kind)
    batch = ray_batch(1)
    background = np.array([-1.0, 0.2, 0.7], np.float32)
    key = jax.random.PRNGKey(3)
    (ref_total, ref_dict), ref_grads = jax_value_and_grad(kind, density_penalty)(
        dict(coarse=coarse_tree, fine=fine_tree, background=jnp.asarray(background)), key, jnp.asarray(batch))
    total, loss_dict, grads = port_losses(kind, coarse_tree, fine_tree, background, batch, jax_draws(key),
                                          density_penalty)
    assert sorted(loss_dict) == sorted(ref_dict)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5)
    for name, value in ref_dict.items():
        np.testing.assert_allclose(loss_dict[name].item(), float(value), rtol=1e-5, atol=1e-7)
    want = reference_grads(kind, ref_grads)
    assert sorted(grads) == sorted(want)
    for name, ref in want.items():
        assert grads[name] is not None and grads[name].abs().max() > 0, name
        bound = 1e-5 + 1e-4 * ref.abs().max().item()
        assert (grads[name] - ref).abs().max().item() <= bound, name


def test_bf16_route_matches_flax_bf16_model():
    coarse_tree, fine_tree = trees("vanilla", seed=4)
    batch = ray_batch(2)
    background = np.array([-1.0, -1.0, -1.0], np.float32)
    key = jax.random.PRNGKey(5)
    (ref_total, _), ref_grads = jax_value_and_grad("vanilla", 0.1, "bfloat16")(
        dict(coarse=coarse_tree, fine=fine_tree, background=jnp.asarray(background)), key, jnp.asarray(batch))
    total, _, grads = port_losses("vanilla", coarse_tree, fine_tree, background, batch, jax_draws(key), 0.1,
                                  "bfloat16")
    assert abs(total.item() - float(ref_total)) <= BF16_LOSS_BOUND * abs(float(ref_total))
    want = reference_grads("vanilla", ref_grads)
    assert all(grads[name].abs().max() > 0 for name in want)
    got, ref = (torch.cat([d[k].flatten() for k in sorted(want)]) for d in (grads, want))
    assert ((got - ref).norm() / ref.norm()).item() <= BF16_GRAD_BOUND


def jax_step(kind, density_penalty):
    """The JAX hierarchy loop's step body, jitted without its mesh:
    ``learn_nerf_tpu.train._grad_step`` over ``compute_losses`` on an
    ``EmaTrainState`` with the loop's optax Adam."""
    coarse, fine = flax_models(kind)
    renderer = jrender.Renderer(coarse=coarse, fine=fine, coarse_ts=COARSE_TS, fine_ts=FINE_TS, **BBOX)
    loss_fn = functools.partial(jtrain.compute_losses, renderer, loss_weights=jtrain.default_loss_weights(),
                                density_penalty=density_penalty, density_penalty_batch_size=PENALTY_BATCH)
    return jax.jit(lambda state, key, batch: jtrain._grad_step(loss_fn, state, None, key=key, batch=batch))


def jax_state(kind, coarse_tree, fine_tree):
    adam = NGP_ADAM if kind == "ngp" else {}
    params = dict(coarse=jax.tree_util.tree_map(jnp.asarray, coarse_tree),
                  fine=jax.tree_util.tree_map(jnp.asarray, fine_tree), background=jnp.array([-1.0, -1.0, -1.0]))
    tx = optax.adam(1e-3, b1=adam.get("adam_b1", 0.9), b2=adam.get("adam_b2", 0.999),
                    eps=adam.get("adam_eps", 1e-7))
    return jtrain.EmaTrainState.create(apply_fn=None, params=params, tx=tx)


def port_loop(kind="vanilla", coarse_tree=None, fine_tree=None, **kw):
    if coarse_tree is None:
        coarse_tree, fine_tree = trees(kind)
    coarse, fine = port_models(kind, coarse_tree, fine_tree)
    adam = NGP_ADAM if kind == "ngp" else {}
    return train.TrainLoop(coarse, fine, lr=kw.pop("lr", 1e-3), coarse_ts=COARSE_TS, fine_ts=FINE_TS, **BBOX,
                           **adam, **kw)


@pytest.mark.parametrize("kind", ["vanilla", "ngp"])
def test_train_loop_step_matches_jax(kind):
    """One step's logged dict (losses, grad_norm, param_norm) within 1e-5,
    and the next step's loss, taken on the updated parameters, within
    1e-4 (Adam's first updates are about ``lr * sign(g)``, so a gradient
    that is rounding noise moves its parameter by a different sign)."""
    coarse_tree, fine_tree = trees(kind)
    step_fn, state = jax_step(kind, 0.05), jax_state(kind, coarse_tree, fine_tree)
    loop = port_loop(kind, coarse_tree, fine_tree, density_penalty=0.05, density_penalty_batch_size=PENALTY_BATCH)
    for step in range(2):
        key = jax.random.PRNGKey(10 + step)
        batch = ray_batch(100)
        state, ref = step_fn(state, key, jnp.asarray(batch))
        ref = {k: float(v) for k, v in ref.items()}
        got = {k: float(v) for k, v in loop.step(batch, **jax_draws(key)).items()}
        assert sorted(got) == sorted(ref)
        np.testing.assert_allclose([got[k] for k in ref], list(ref.values()), rtol=1e-5 if step == 0 else 1e-4)
    assert loop.step_count == loop._opt_count == int(state.step) == 2


def test_step_auto_many_is_step_auto_bit_for_bit():
    batches = [ray_batch(s) for s in range(3)]
    a, b = port_loop(), port_loop()
    for batch in batches:
        a_values = a.step_auto(7, batch)
    b_values = b.step_auto_many(7, np.stack(batches))
    for pa, pb in zip(a._leaves(), b._leaves()):
        assert torch.equal(pa, pb)
    assert {k: float(v) for k, v in a_values.items()} == {k: float(v) for k, v in b_values.items()}
    assert a.step_count == b.step_count == 3
    with pytest.raises(ValueError, match="at least one batch"):
        b.step_auto_many(7, [])


def test_eval_losses_read_the_average():
    loop = port_loop(ema_decay=0.9)
    for step in range(2):
        loop.step_auto(1, ray_batch(step))
    draws = jax_draws(jax.random.PRNGKey(0))
    on_ema = loop.eval_losses(ray_batch(9), **draws)
    ema = loop.eval_params
    raw = port_loop()
    raw.coarse.load_state_dict(ema["coarse"])
    raw.fine.load_state_dict(ema["fine"])
    with torch.no_grad():
        raw.background.copy_(ema["background"])
    assert {k: float(v) for k, v in on_ema.items()} == {
        k: float(v) for k, v in raw.eval_losses(ray_batch(9), **draws).items()}
    assert not torch.equal(ema["fine"]["skip.weight"], loop.fine.skip.weight)


@pytest.mark.parametrize("kind", ["vanilla", "ngp"])
def test_port_pickle_renders_in_jax(kind, tmp_path):
    loop = port_loop(kind)
    for step in range(2):
        loop.step_auto(3, ray_batch(step))
    path = str(tmp_path / "h.pkl")
    loop.save(path)
    payload = jax_load_params_pickle(path)
    assert set(payload) == {"coarse", "fine", "background", "train_host_step"}
    assert int(payload["train_host_step"]) == 2
    coarse, fine = flax_models(kind)
    renderer = jrender.Renderer(coarse=coarse, fine=fine, coarse_ts=COARSE_TS, fine_ts=FINE_TS, **BBOX)
    key = jax.random.PRNGKey(4)
    rays = ray_batch(5)[:, :2]
    ref = jax.jit(renderer.render_rays)(key, jnp.asarray(rays), payload["coarse"], payload["fine"],
                                        jnp.asarray(payload["background"]))
    coarse_key, fine_key = jax.random.split(key)  # the render's own splits
    with torch.no_grad():
        out = loop.renderer.render_rays(t(rays), loop.background,
                                        u_coarse=t(jax.random.uniform(coarse_key, (RAYS, COARSE_TS))),
                                        u_fine=t(jax.random.uniform(fine_key, (RAYS, FINE_TS))))
    for name in ("coarse", "fine"):
        np.testing.assert_allclose(out[name]["outputs"].numpy(), np.asarray(ref[name]["outputs"]), atol=1e-5)


def test_jax_pickle_loads_into_the_port(tmp_path):
    coarse_tree, fine_tree = trees("vanilla", seed=6)
    params = dict(coarse=coarse_tree, fine=fine_tree, background=np.array([0.1, -0.2, 0.3], np.float32))
    path = str(tmp_path / "jax.pkl")
    jax_save_params_pickle(path, dict(params, train_host_step=np.int64(1)))  # learn_nerf_tpu's TrainLoop.save
    loop = port_loop(ema_decay=0.99)
    loop.load(path)
    for name, model in (("coarse", loop.coarse), ("fine", loop.fine)):
        for k, v in checkpoint.params_from_flax(jax.tree_util.tree_map(np.asarray, params[name]),
                                                **VANILLA).items():
            assert torch.equal(model.state_dict()[k], v), k
        # The average is reseeded from the loaded tree.
        for k, v in model.state_dict().items():
            assert torch.equal(loop.eval_params[name][k], v)
    np.testing.assert_array_equal(loop.background.detach().numpy(), np.asarray(params["background"]))
    assert loop.step_count == 1


def test_fused_bf16_route_refuses_gradients_and_the_loops_pick_the_flax_route():
    coarse_tree, fine_tree = trees("vanilla")
    model = port_model(fine_tree, "bfloat16", **VANILLA)
    x = torch.rand(5, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        model(x, x)
    with torch.no_grad():
        density, _, _ = model(x, x)  # serving: the fused route's plain version
    flax_density, _, _ = model.set_bf16_route("flax")(x, x)
    assert flax_density.requires_grad and (flax_density - density).abs().max() < 0.05
    with pytest.raises(ValueError, match="bf16_route"):
        model.set_bf16_route("kernel")
    coarse, fine = port_models("vanilla", coarse_tree, fine_tree, "bfloat16")
    loop = train.TrainLoop(coarse, fine, lr=1e-3, coarse_ts=COARSE_TS, fine_ts=FINE_TS, **BBOX)
    assert coarse.bf16_route == fine.bf16_route == "flax"
    values = loop.step_auto(0, ray_batch(0))
    assert all(p.grad is not None for p in loop._leaves()) and np.isfinite(float(values["fine"]))


def test_loop_on_a_one_device_mesh_steps_as_without_one():
    """``mesh=`` of one device and no process group: the loop trains on the
    mesh's device, step for step as without a mesh."""
    from learn_nerf_tpu_torch.parallel.mesh import default_mesh

    loops = [port_loop(mesh=default_mesh([torch.device("cpu")])), port_loop()]
    got, want = ({k: float(v) for k, v in loop.step_auto(2, ray_batch(3)).items()} for loop in loops)
    assert got == want and loops[0].device == torch.device("cpu")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("scene")), num_views=3, resolution=12)


CLI_FLAGS = ["--batch_size", "64", "--coarse_samples", "8", "--fine_samples", "8", "--lr", "1e-3", "--seed", "0",
             "--device", "cpu"]


@pytest.mark.parametrize("flags", [[], ["--bf16"], ["--instant_ngp"]])
def test_train_cli_trains_the_hierarchy(scene, tmp_path, capsys, flags):
    pkl = str(tmp_path / "h.pkl")
    loop = train_nerf.main([*CLI_FLAGS, *flags, "--steps", "3", "--save_path", pkl, scene])
    assert isinstance(loop, train.TrainLoop) and loop.step_count == 3
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("step ")]
    assert [line.split(":")[0] for line in lines] == ["step 0", "step 1", "step 2"]
    assert all("coarse=" in line and "fine=" in line for line in lines)
    payload = jax_load_params_pickle(pkl)
    assert set(payload) == {"coarse", "fine", "background", "train_host_step"}
    # The port's renderer serves what it trained (bf16: the fused route).
    argv = [*flags, "--seed", "0", "--batch_size", "64", "--coarse_samples", "8", "--fine_samples", "8",
            "--width", "6", "--height", "6", "--device", "cpu", "--model_path", pkl, f"{scene}/metadata.json"]
    session = render_nerf.RenderSession(render_nerf.argparser().parse_args(argv))
    assert session.render_view(session_view(scene)).shape == (6, 6, 3)


def test_profile_train_hierarchy_profiles_the_hierarchy_step(scene):
    from learn_nerf_tpu_torch.scripts import profile_train

    argv = [*CLI_FLAGS, "--hierarchy", "--occupancy", "--repeats", "2", "--warmup_steps", "1", scene]
    result = profile_train.profile_args(profile_train.argparser().parse_args(argv))
    assert len(result["step_ms"]) == 2 and result["refresh_step_ms"] == [] and result["batch_size"] == 64
    assert result["device_ms"] is None and result["gemm_ms"] is None  # no card: not measured
    assert result["matmul_flops"] > 0 and result["tflops"] is None and result["mfu"] is None
    with pytest.raises(SystemExit, match="--hierarchy and --pooled"):
        profile_train.profile_args(profile_train.argparser().parse_args([*argv, "--pooled"]))


def session_view(scene):
    from learn_nerf_tpu_torch.data.camera import CameraView

    return CameraView.from_json(f"{scene}/0000.json")
