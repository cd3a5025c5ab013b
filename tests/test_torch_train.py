"""The port's occupancy train step against learn_nerf_tpu, on the CPU at a
small size (4 hash levels of 2^10 rows, 16-wide MLPs, batch 64, 16
candidates -> 4 samples, a 16^3 grid).

Both packages get the same weights (flax trees through the checkpoint
bridge) and the same random numbers: the test reproduces the JAX code's key
splits and feeds the port JAX's own uniforms (``u=``, ``density_draws=``,
``grid_ids=``, ``grid_jitter=``).  Held here:

* ``compute_losses_occupancy``: loss within 1e-5 and every gradient
  (tables, MLP, background) within 1e-5 + 1e-4 * max of ``jax.grad``, with
  and without the density penalty;
* ``OccupancyGrid.update`` and ``cell_positions`` within 1e-6 (warmup and
  decay, duplicate cells, 1 and 3 samples per cell);
* Adam on its own: JAX's gradients fed to the port's optimizer for 5 steps
  leave the parameters within 1e-6 of optax's;
* the whole step over 8 steps by its LOSS trajectory only (see
  ``test_loss_trajectory_matches_jax_loop`` for why not by parameters);
* the cosine schedule, EMA, the refresh cadence and ``grid_freeze_after``,
  checkpoints in both directions, resume determinism of ``step_auto``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learn_nerf_tpu import acceleration as jacc
from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu import train as jtrain
from learn_nerf_tpu.models import InstantNGPModel as FlaxNGP
from learn_nerf_tpu_torch import acceleration, checkpoint, occ_render, train
from learn_nerf_tpu_torch.models import InstantNGPModel, NeRFModel

from .test_torch_ngp import flax_ngp_params, port_ngp
from .torch_helpers import t

torch.set_num_threads(1)

BBOX = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
SMALL = dict(table_sizes=[2**10] * 4, grid_sizes=[4, 8, 16, 32], hidden_dim=16)
RAYS, CANDIDATES, SAMPLES, GRID = 64, 16, 4, 16
NGP_ADAM = dict(adam_eps=1e-15, adam_b1=0.9, adam_b2=0.99)
LOOP = dict(candidates=CANDIDATES, samples=SAMPLES, grid_resolution=GRID, **BBOX)


def ray_batch(seed, n=RAYS):
    """``[n, 3, 3]`` rays from outside the bbox towards it (a few miss),
    with random target colours."""
    rng = np.random.RandomState(seed)
    origins = rng.randn(n, 3)
    origins = 2.5 * origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = rng.uniform(-0.8, 0.8, (n, 3)) - origins
    dirs[: n // 8] = rng.randn(n // 8, 3)  # mostly misses
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    colors = rng.uniform(-1, 1, (n, 3))
    return np.stack([origins, dirs, colors], axis=1).astype(np.float32)


def grid_densities(seed, occupied=0.6):
    """Cell densities around the threshold: ``occupied`` of them above it."""
    rng = np.random.RandomState(seed)
    return (rng.rand(GRID**3) < occupied).astype(np.float32) * 0.05 + 0.001


def grids(warmup_updates=16):
    kw = dict(resolution=GRID, warmup_updates=warmup_updates, **BBOX)
    return jacc.OccupancyGrid(**kw), acceleration.OccupancyGrid(**kw)


def grid_states(densities, step):
    return (
        jacc.OccupancyGridState(densities=jnp.asarray(densities), step=jnp.asarray(step, jnp.int32)),
        acceleration.OccupancyGridState(densities=t(densities), step=step),
    )


def loss_draws(step_key, n=RAYS, penalty_batch=32):
    """What ``compute_losses_occupancy`` draws from its key: the candidate
    uniforms, and the density penalty's uniforms and normals (one key)."""
    key, density_key = jax.random.split(step_key)
    u = jax.random.uniform(key, (n, CANDIDATES))
    coords_u = jax.random.uniform(density_key, (penalty_batch, 3))
    dirs_normal = jax.random.normal(density_key, (penalty_batch, 3))
    return t(np.asarray(u)), (t(np.asarray(coords_u)), t(np.asarray(dirs_normal)))


def update_draws(key, num_cells, num_samples):
    """What ``OccupancyGrid.update`` draws from its key: the cells and the
    per-sample jitter."""
    cell_key, jitter_key = jax.random.split(key)
    ids = jax.random.randint(cell_key, (num_cells,), 0, GRID**3)
    keys = [jitter_key] if num_samples <= 1 else [
        jax.random.fold_in(jitter_key, s) for s in range(num_samples)
    ]
    jitter = np.stack([np.asarray(jax.random.uniform(k, (num_cells, 3))) for k in keys])
    return t(np.asarray(ids)).long(), t(jitter)


def assert_tree_close(state, flax_tree, atol, rel=0.0, what=""):
    """A port state dict (or named gradients) against a flax NGP tree."""
    want = checkpoint.ngp_params_from_flax(jax.tree_util.tree_map(np.asarray, flax_tree))
    assert sorted(state) == sorted(want)
    for name, ref in want.items():
        ref = ref.numpy()
        bound = atol + rel * np.abs(ref).max()
        err = np.abs(state[name].detach().numpy() - ref).max()
        assert err <= bound, f"{what} {name}: {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module")
def tree():
    params = flax_ngp_params(0, **SMALL)
    # Half-scale tables: densities of order one, so culled and kept samples
    # both carry gradient.
    for name, table in params["HashGridEncoding_0"].items():
        params["HashGridEncoding_0"][name] = 0.5 * table
    return params


@pytest.fixture(scope="module")
def jax_value_and_grad():
    model = FlaxNGP(**SMALL, **BBOX)
    jgrid, _ = grids()
    renderer = jocc.OccupancyRenderer(
        model=model, grid=jgrid, candidates=CANDIDATES, samples=SAMPLES, **BBOX
    )

    def make(density_penalty):
        def loss(params, key, batch, grid_state):
            return jtrain.compute_losses_occupancy(
                renderer, params, key, batch, grid_state, jtrain.default_loss_weights(),
                density_penalty=density_penalty, density_penalty_batch_size=32,
            )

        return jax.jit(jax.value_and_grad(loss, has_aux=True))

    return make


@pytest.mark.parametrize("density_penalty", [None, 0.1])
def test_loss_and_gradients_match_jax(tree, jax_value_and_grad, density_penalty):
    batch = ray_batch(1)
    background = np.array([-1.0, 0.2, 0.7], np.float32)
    jstate, pstate = grid_states(grid_densities(2), step=16)  # past warmup: culling is on
    key = jax.random.PRNGKey(3)
    (ref_total, ref_dict), ref_grads = jax_value_and_grad(density_penalty)(
        dict(fine=tree, background=jnp.asarray(background)), key, jnp.asarray(batch), jstate
    )

    model = port_ngp(tree, SMALL["table_sizes"], SMALL["grid_sizes"], hidden_dim=16)
    _, pgrid = grids()
    renderer = occ_render.OccupancyRenderer(
        model=model, grid=pgrid, candidates=CANDIDATES, samples=SAMPLES, **BBOX
    )
    bg = t(background).requires_grad_()
    u, density_draws = loss_draws(key)
    total, loss_dict = train.compute_losses_occupancy(
        renderer, bg, t(batch), pstate, train.default_loss_weights(),
        density_penalty=density_penalty, density_penalty_batch_size=32,
        u=u, density_draws=density_draws,
    )
    total.backward()

    assert sorted(loss_dict) == sorted(ref_dict)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5, atol=1e-6)
    for name, value in ref_dict.items():
        np.testing.assert_allclose(loss_dict[name].item(), float(value), rtol=1e-5, atol=1e-6)
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert all(g is not None and g.abs().max() > 0 for g in grads.values())
    assert_tree_close(grads, ref_grads["fine"], atol=1e-5, rel=1e-4, what="gradient of")
    ref_bg = np.asarray(ref_grads["background"])
    assert np.abs(bg.grad.numpy() - ref_bg).max() <= 1e-5 + 1e-4 * np.abs(ref_bg).max()


def test_cell_positions_match_jax():
    jgrid, pgrid = grids()
    rng = np.random.RandomState(4)
    ids = rng.randint(0, GRID**3, 500)
    key = jax.random.PRNGKey(5)
    ref = jgrid.cell_positions(key, jnp.asarray(ids))
    jitter = t(np.asarray(jax.random.uniform(key, (500, 3))))
    out = pgrid.cell_positions(t(ids).long(), jitter)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("step,num_samples", [(0, 1), (0, 3), (20, 1), (20, 3)])
def test_grid_update_matches_jax(tree, step, num_samples):
    """No decay during warmup (step 0 < 16), decay 0.95 after; 3000 draws
    with replacement from 4096 cells repeat many cells."""
    jgrid, pgrid = grids()
    jstate, pstate = grid_states(grid_densities(6), step=step)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(
        lambda s, p, k: jgrid.update(s, FlaxNGP(**SMALL, **BBOX), p, k, num_cells=3000,
                                     num_samples=num_samples)
    )(jstate, tree, key)
    ids, jitter = update_draws(key, 3000, num_samples)
    assert len(np.unique(ids.numpy())) < 3000
    model = port_ngp(tree, SMALL["table_sizes"], SMALL["grid_sizes"], hidden_dim=16)
    before = pstate.densities.clone()
    out = pgrid.update(pstate, model, num_cells=3000, num_samples=num_samples, ids=ids, jitter=jitter)
    assert out.step == int(ref.step) == step + 1
    np.testing.assert_allclose(out.densities.numpy(), np.asarray(ref.densities), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(pstate.densities, before)  # the old state is left alone
    untouched = np.setdiff1d(np.arange(GRID**3), ids.numpy())
    decay = 1.0 if step < 16 else 0.95
    np.testing.assert_allclose(out.densities.numpy()[untouched], before.numpy()[untouched] * decay, rtol=1e-6)


def test_grid_update_draws_its_own_cells():
    """Without explicit draws the generator supplies them; all cells when
    ``num_cells`` covers the grid."""
    _, pgrid = grids()
    model = InstantNGPModel(**SMALL, **BBOX)
    state = pgrid.init()
    gen = torch.Generator().manual_seed(0)
    a = pgrid.update(state, model, num_cells=100, generator=gen)
    b = pgrid.update(state, model, num_cells=100, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a.densities, b.densities, rtol=0, atol=0)
    full = pgrid.update(state, model, generator=gen)
    assert full.step == 1 and full.densities.shape == (GRID**3,)


def jax_loop(**kw):
    return jtrain.OccupancyTrainLoop(
        FlaxNGP(**SMALL, **BBOX), init_rng=jax.random.PRNGKey(0), lr=1e-2, **LOOP, **NGP_ADAM, **kw
    )


def port_loop(tree=None, lr=1e-2, **kw):
    model = InstantNGPModel(**SMALL, **BBOX)
    if tree is not None:
        model.load_state_dict(checkpoint.train_state_from_flax(tree)["fine"])
    return train.OccupancyTrainLoop(model, lr=lr, **LOOP, **NGP_ADAM, **kw)


def test_adam_matches_optax_given_equal_gradients(tree, jax_value_and_grad):
    """Adam held on its own: JAX's gradients, taken at JAX's parameters,
    go to both optimizers for 5 steps."""
    params = dict(fine=tree, background=jnp.array([-1.0, -1.0, -1.0]))
    tx = optax.adam(1e-2, b1=0.9, b2=0.99, eps=1e-15)
    opt_state = tx.init(params)
    loop = port_loop(params)
    jstate, _ = grid_states(grid_densities(2), step=16)
    grad_fn = jax_value_and_grad(None)
    for step in range(5):
        _, grads = grad_fn(params, jax.random.PRNGKey(step), jnp.asarray(ray_batch(step)), jstate)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port_grads = checkpoint.train_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
        for name, p in loop.model.named_parameters():
            p.grad = port_grads["fine"][name]
        loop.background.grad = port_grads["background"]
        loop.optimizer.step()
    assert_tree_close(loop.model.state_dict(), params["fine"], atol=1e-6, what="after 5 Adam steps,")
    np.testing.assert_allclose(
        loop.background.detach().numpy(), np.asarray(params["background"]), atol=1e-6
    )
    # The moments cross the bridge too.
    adam = opt_state[0]
    bridged = checkpoint.train_state_from_flax(
        jax.tree_util.tree_map(np.asarray, params),
        dict(mu=jax.tree_util.tree_map(np.asarray, adam.mu),
             nu=jax.tree_util.tree_map(np.asarray, adam.nu), count=adam.count),
    )
    assert bridged["step"] == 5
    for name, p in loop.model.named_parameters():
        state = loop.optimizer.state[p]
        assert int(state["step"]) == 5
        bound = 1e-6 * max(bridged["exp_avg"]["fine"][name].abs().max().item(), 1e-30) + 1e-12
        assert (state["exp_avg"] - bridged["exp_avg"]["fine"][name]).abs().max() <= bound
        bound = 1e-5 * max(bridged["exp_avg_sq"]["fine"][name].abs().max().item(), 1e-30) + 1e-15
        assert (state["exp_avg_sq"] - bridged["exp_avg_sq"]["fine"][name]).abs().max() <= bound


def test_loss_trajectory_matches_jax_loop():
    """Eight whole steps of both loops from one state, with JAX's draws.

    Parameters are NOT held through the whole step: with eps 1e-15 Adam's
    first updates are ``lr * sign(g)``, so a table row whose gradient is
    rounding noise of opposite sign in the two packages moves by 2 * lr
    apart while mattering to nothing.  The loss trajectory is what both
    runs must share: within 1e-4 relative (measured 2.5e-7 here)."""
    jloop = jax_loop(update_interval=4, update_cells=1000, grid_warmup_updates=1)
    loop = port_loop(jax.device_get(jloop.state.params), update_interval=4, update_cells=1000,
                     grid_warmup_updates=1)
    key = jax.random.PRNGKey(11)
    ref_losses, losses = [], []
    for step in range(8):
        key, sub = jax.random.split(key)
        batch = ray_batch(100)  # one batch throughout: the loss must fall
        ref_losses.append(float(jloop.step(sub, batch)["fine"]))
        step_key, grid_key = jax.random.split(sub)
        u, _ = loss_draws(step_key)
        ids, jitter = update_draws(grid_key, 1000, 1)
        losses.append(float(loop.step(batch, u=u, grid_ids=ids, grid_jitter=jitter)["fine"]))
    assert loop.grid_state.step == int(jloop.grid_state.step) == 2
    assert loop._host_step == jloop._host_step == 8
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(
        loop.grid_state.densities.numpy(), np.asarray(jloop.grid_state.densities), atol=5e-3
    )


def test_cosine_schedule_matches_optax():
    steps = 200
    ref = optax.cosine_decay_schedule(init_value=3e-3, decay_steps=steps, alpha=0.1)
    ours = train.cosine_decay_schedule(3e-3, steps, 0.1)
    for count in (0, 1, steps // 2, steps - 1, steps, 2 * steps):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6)
    # The loop sets the schedule's value before each optimizer step.
    loop = port_loop(lr=train.cosine_decay_schedule(1e-2, 4, 0.5))
    seen = []
    for step in range(5):
        loop.step_auto(0, ray_batch(step))
        seen.append(loop.optimizer.param_groups[0]["lr"])
    np.testing.assert_allclose(seen, [float(optax.cosine_decay_schedule(1e-2, 4, 0.5)(c)) for c in range(5)],
                               rtol=1e-6)


def test_ema_after_three_steps():
    """``ema <- decay * ema + (1 - decay) * params`` after each step, seeded
    from a copy; checkpoints and ``eval_losses`` read the average."""
    loop = port_loop(ema_decay=0.9)
    expected = {k: v.clone() for k, v in loop.model.state_dict().items()}
    expected_bg = loop.background.detach().clone()
    for step in range(3):
        loop.step_auto(1, ray_batch(step))
        for k, v in loop.model.state_dict().items():
            expected[k] = expected[k] * 0.9 + v * (1.0 - 0.9)
        expected_bg = expected_bg * 0.9 + loop.background.detach() * (1.0 - 0.9)
    ema = loop.eval_params
    for k in expected:
        torch.testing.assert_close(ema["fine"][k], expected[k], rtol=1e-6, atol=1e-8)
        assert not torch.equal(ema["fine"][k], loop.model.state_dict()[k])
    torch.testing.assert_close(ema["background"], expected_bg, rtol=1e-6, atol=1e-8)
    assert all(not p.requires_grad for p in loop._ema_models["fine"].parameters())
    # eval_losses evaluates the average, not the raw parameters.
    batch = ray_batch(9)
    u = torch.rand(RAYS, CANDIDATES, generator=torch.Generator().manual_seed(0))
    on_ema = loop.eval_losses(batch, u=u)["fine"]
    raw = port_loop()
    raw.model.load_state_dict(loop.model.state_dict())
    with torch.no_grad():
        raw.background.copy_(loop.background)
    raw.grid_state = loop.grid_state
    assert abs(on_ema.item() - raw.eval_losses(batch, u=u)["fine"].item()) > 1e-7
    assert port_loop().eval_params["background"].tolist() == [-1.0, -1.0, -1.0]


def test_refresh_cadence_and_grid_freeze_after():
    """Refreshes fire BEFORE the step at host steps 0 and 2 (interval 2),
    stop at the freeze step 4, and ``step_auto_many`` follows the same rule
    (tests/test_occupancy.py::test_grid_freeze_after)."""
    def make():
        torch.manual_seed(0)
        return port_loop(update_interval=2, grid_warmup_updates=1, grid_freeze_after=4)

    batches = [ray_batch(s) for s in range(8)]
    a, dens, steps = make(), [], []
    for batch in batches:
        a.step_auto(5, batch)
        dens.append(a.grid_state.densities.clone())
        steps.append(a.grid_state.step)
    assert steps == [1, 1, 2, 2, 2, 2, 2, 2]
    assert not torch.equal(dens[1], dens[3])  # the refresh at step 2 landed
    for s in range(4, 8):
        assert torch.equal(dens[s], dens[3])
    b = make()
    for chunk in (batches[:4], batches[4:]):
        values = b.step_auto_many(5, chunk)
    assert torch.equal(b.grid_state.densities, dens[-1]) and b._host_step == 8
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    assert set(values) == {"fine", "grad_norm", "param_norm"}


def test_port_checkpoint_loads_in_jax_loop(tmp_path):
    loop = port_loop(update_interval=2)
    for step in range(3):
        loop.step_auto(2, ray_batch(step))
    path = str(tmp_path / "port.pkl")
    loop.save(path)
    jloop = jax_loop()
    jloop.load(path)
    assert_tree_close(loop.model.state_dict(), jax.device_get(jloop.state.params["fine"]), atol=0)
    np.testing.assert_array_equal(
        np.asarray(jloop.state.params["background"]), loop.background.detach().numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jloop.grid_state.densities), loop.grid_state.densities.numpy()
    )
    assert jloop._host_step == int(jloop.state.step) == loop._host_step == 3
    assert int(jloop.grid_state.step) == jloop.grid.warmup_updates  # marked past warmup
    payload = checkpoint.load_params_pickle(path)
    assert payload["occupancy_resolution"].dtype == np.int32
    assert payload["occupancy_host_step"].dtype == np.int64


def test_jax_checkpoint_loads_in_port_loop(tmp_path, tree):
    jloop = jax_loop()
    densities = grid_densities(8)
    jloop.state = jloop.state.replace(
        params=dict(fine=jax.tree_util.tree_map(jnp.asarray, tree), background=jnp.array([0.1, -0.2, 0.3]))
    )
    jloop.grid_state = jacc.OccupancyGridState(jnp.asarray(densities), jnp.asarray(3, jnp.int32))
    jloop._host_step = 5
    path = str(tmp_path / "jax.pkl")
    jloop.save(path)
    loop = port_loop(ema_decay=0.99)
    loop.load(path)
    assert_tree_close(loop.model.state_dict(), tree, atol=0)
    np.testing.assert_allclose(loop.background.detach().numpy(), [0.1, -0.2, 0.3], rtol=1e-7)
    np.testing.assert_array_equal(loop.grid_state.densities.numpy(), densities)
    assert loop._host_step == loop.step_count == 5
    assert loop.grid_state.step == loop.grid.warmup_updates
    # The average is reseeded from the loaded tree.
    assert_tree_close(loop.eval_params["fine"], tree, atol=0)


def test_step_auto_resume_is_deterministic(tmp_path):
    """6 steps equal 3 steps, save_full, load_full, 3 steps, bit for bit:
    the seeds are a function of the checkpointed counters, and the full
    state carries Adam's moments, the grid and the average."""
    def make():
        torch.manual_seed(0)
        return port_loop(update_interval=2, update_cells=500, grid_warmup_updates=1,
                         density_penalty=0.01, ema_decay=0.9)

    batches = [ray_batch(s) for s in range(6)]
    a = make()
    for batch in batches:
        a_values = a.step_auto(42, batch)
    c = make()
    for batch in batches[:3]:
        c.step_auto(42, batch)
    path = str(tmp_path / "state.pt")
    c.save_full(path)
    d = make()
    d.load_full(path)
    assert d._host_step == d.step_count == d._opt_count == 3 and d.grid_state.step == c.grid_state.step
    for batch in batches[3:]:
        d_values = d.step_auto(42, batch)
    for pa, pd in zip(a.model.parameters(), d.model.parameters()):
        assert torch.equal(pa, pd)
    assert torch.equal(a.background, d.background)
    assert torch.equal(a.grid_state.densities, d.grid_state.densities)
    for k, v in a.eval_params["fine"].items():
        assert torch.equal(v, d.eval_params["fine"][k])
    assert {k: float(v) for k, v in a_values.items()} == {k: float(v) for k, v in d_values.items()}
    # A different base seed draws differently.
    e = make()
    e.step_auto(43, batches[0])
    f = make()
    f.step_auto(42, batches[0])
    assert not torch.equal(next(e.model.parameters()), next(f.model.parameters()))


def test_fold_seed_is_a_pure_function_of_its_arguments():
    seeds = {train.fold_seed(b, tag, s) for b in (0, 1, 2**31) for tag in (0, 1) for s in range(50)}
    assert len(seeds) == 300 and all(0 <= s < 2**63 for s in seeds)
    assert train.fold_seed(7, 1, 9) == train.fold_seed(7, 1, 9)


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh=object()), "Queue 1: data parallelism"),
])
def test_unported_loop_options_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        port_loop(**kwargs)


def test_tree_norm_and_loss_weights():
    assert train.default_loss_weights() == jtrain.default_loss_weights()
    rng = np.random.RandomState(0)
    arrays = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    ref = float(jtrain.tree_norm([jnp.asarray(a) for a in arrays]))
    np.testing.assert_allclose(train.tree_norm([t(a) for a in arrays]).item(), ref, rtol=1e-6)
