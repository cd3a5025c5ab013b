"""Pooled training in the port against learn_nerf_tpu, on the CPU at a
small size (4 hash levels of 2^10 rows, 16-wide MLPs, batch 64, 16
candidates -> 4 samples, a 16^3 grid).

Held here:

* ``compute_losses_occupancy_pooled`` against the JAX package's, jitted,
  with JAX's own uniforms: the loss, ``fine_pool_dropped`` and every
  parameter's gradient, at an ample budget and at one that drops samples;
* the pooled loss equals the dense one when nothing drops, over randomized
  configurations (tests/test_occupancy.py::test_pooled_equals_dense_fuzz);
* the loop's rules against the JAX loop's own control flow, with both
  loops' device work stubbed out: the switchover at ``pool_start_step``,
  the split of a macro step that straddles it, the auto budget's demand
  measurements (after the increment in ``step_auto``, before it once a
  macro step in ``step_auto_many``), its re-measure cadence and its
  printed bucket changes;
* real steps: the drop counter, a pickle resume past the switchover, and
  misaligned macro steps equal to single steps bit for bit;
* ``RenderCompositePooled`` with its launchers faked on the CPU (a detached
  output fails), and the wrappers' refusals;
* ``train_nerf --occ_train_budget auto|4`` and ``eval_psnr`` on a tiny
  scene, ``eval_psnr``'s numbers against the JAX package's ``psnr`` and
  ``ssim`` on the same images.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu import train as jtrain
from learn_nerf_tpu.models import InstantNGPModel as FlaxNGP
from learn_nerf_tpu.utils import metrics as jmetrics
from learn_nerf_tpu_torch import acceleration, occ_render, train
from learn_nerf_tpu_torch.data.dataset import load_dataset
from learn_nerf_tpu_torch.kernels import composite as kc
from learn_nerf_tpu_torch.models import InstantNGPModel
from learn_nerf_tpu_torch.scripts import eval_psnr, render_nerf, train_nerf
from learn_nerf_tpu_torch.utils import metrics

from .synthetic_scene import write_dataset
from .test_torch_ngp import port_ngp
from .test_torch_train import (
    BBOX, CANDIDATES, LOOP, NGP_ADAM, RAYS, SAMPLES, SMALL, assert_tree_close, grid_densities, grid_states,
    grids, loss_draws, port_loop, ray_batch, tree,  # noqa: F401 (tree is a fixture)
)
from .test_torch_train_cli import SMALL_FLAGS
from .torch_helpers import t

torch.set_num_threads(1)

AMPLE, DROPPING = RAYS * SAMPLES, 60


@pytest.fixture(scope="module")
def jax_pooled_value_and_grad():
    renderer = jocc.OccupancyRenderer(
        model=FlaxNGP(**SMALL, **BBOX), grid=grids()[0], candidates=CANDIDATES, samples=SAMPLES, **BBOX
    )

    def loss(params, key, batch, grid_state, budget, density_penalty):
        return jtrain.compute_losses_occupancy_pooled(
            renderer, params, key, batch, grid_state, jtrain.default_loss_weights(), budget=budget,
            density_penalty=density_penalty, density_penalty_batch_size=32,
        )

    return jax.jit(jax.value_and_grad(loss, has_aux=True), static_argnums=(4, 5))


def port_renderer(model, k=SAMPLES, c=CANDIDATES, resolution=16):
    grid = acceleration.OccupancyGrid(resolution=resolution, **BBOX)
    return occ_render.OccupancyRenderer(model=model, grid=grid, candidates=c, samples=k, **BBOX)


@pytest.mark.parametrize("budget,density_penalty", [(AMPLE, None), (DROPPING, 0.1)])
def test_pooled_loss_and_gradients_match_jax(tree, jax_pooled_value_and_grad, budget, density_penalty):
    batch = ray_batch(1)
    background = np.array([-1.0, 0.2, 0.7], np.float32)
    jstate, pstate = grid_states(grid_densities(2), step=16)  # past warmup: culling is on
    key = jax.random.PRNGKey(3)
    (ref_total, ref_dict), ref_grads = jax_pooled_value_and_grad(
        dict(fine=tree, background=jnp.asarray(background)), key, jnp.asarray(batch), jstate, budget,
        density_penalty,
    )

    model = port_ngp(tree, SMALL["table_sizes"], SMALL["grid_sizes"], hidden_dim=16)
    bg = t(background).requires_grad_()
    u, density_draws = loss_draws(key)
    total, loss_dict = train.compute_losses_occupancy_pooled(
        port_renderer(model), bg, t(batch), pstate, train.default_loss_weights(), budget,
        density_penalty=density_penalty, density_penalty_batch_size=32, u=u, density_draws=density_draws,
    )
    total.backward()

    assert sorted(loss_dict) == sorted(ref_dict)
    dropped = int(loss_dict["fine_pool_dropped"])
    assert dropped == int(ref_dict["fine_pool_dropped"]) and (dropped > 0) == (budget == DROPPING)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5, atol=1e-6)
    for name, value in ref_dict.items():
        np.testing.assert_allclose(loss_dict[name].item(), float(value), rtol=1e-5, atol=1e-6)
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert all(g is not None and g.abs().max() > 0 for g in grads.values())
    assert_tree_close(grads, ref_grads["fine"], atol=1e-5, what="gradient of")
    assert np.abs(bg.grad.numpy() - np.asarray(ref_grads["background"])).max() <= 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pooled_loss_equals_dense_when_nothing_drops(seed):
    """At a budget of N * K the pooled loss and its gradients are the dense
    ones, over grid sizes, candidate and sample counts, occupancies and
    ray counts (odd ones included)."""
    rng = np.random.RandomState(100 + seed)
    res = int(rng.choice([4, 8, 16]))
    c = int(rng.choice([8, 16, 24]))
    k = min(int(rng.choice([4, 8, c])), c)
    n = int(rng.choice([33, 64, 127]))
    frac = float(rng.choice([0.05, 0.3, 0.9]))
    torch.manual_seed(seed)
    renderer = port_renderer(InstantNGPModel(**SMALL, **BBOX), k=k, c=c, resolution=res)
    state = acceleration.OccupancyGridState(
        densities=t((rng.rand(res**3) < frac).astype(np.float32)), step=renderer.grid.warmup_updates)
    batch = t(ray_batch(seed, n))
    u = t(rng.rand(n, c).astype(np.float32))
    results = []
    for pooled in (False, True):
        renderer.model.zero_grad(set_to_none=True)
        bg = t(np.array([0.1, -0.4, 0.7], np.float32)).requires_grad_()
        args = (renderer, bg, batch, state, train.default_loss_weights())
        if pooled:
            total, values = train.compute_losses_occupancy_pooled(*args, n * k, u=u)
            assert int(values["fine_pool_dropped"]) == 0
        else:
            total, values = train.compute_losses_occupancy(*args, u=u)
        total.backward()
        results.append((total.item(), [p.grad.clone() for p in renderer.model.parameters()] + [bg.grad]))
    (dense, dense_grads), (pooled, pooled_grads) = results
    np.testing.assert_allclose(pooled, dense, rtol=1e-6)
    for a, b in zip(pooled_grads, dense_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * max(1.0, b.abs().max().item()))


# -- the loop's rules, against the JAX loop's control flow --------------------


def demand_at(host_step):
    """A demand that moves with the host step: buckets 2, 3 and 4 of K = 4."""
    return 1.0 + (host_step // 7) % 3


def jax_rules(budget_cfg, start, interval, chunks):
    """The JAX loop's per-step budgets (None: dense), the host steps at
    which it measured demand, with every device call stubbed out."""
    loop = jtrain.OccupancyTrainLoop(
        FlaxNGP(**SMALL, **BBOX), init_rng=jax.random.PRNGKey(0), lr=1e-2, **LOOP,
        pool_budget_per_ray=budget_cfg, pool_start_step=start, update_interval=4,
    )
    loop._AUTO_REBUDGET_INTERVAL = interval
    budgets, measured = [], []

    def demand_fn(key, rays, grid_state):
        measured.append(loop._host_step)
        return demand_at(loop._host_step)

    def scan(state, grid_state, budget, key, batches):
        budgets.extend([budget] * batches.shape[0])
        return state, grid_state, {}

    loop._demand_fn = demand_fn
    loop._update_grid_auto_fn = lambda grid_state, *args: grid_state
    loop._auto_step_fn = lambda state, *args: (budgets.append(None), (state, {}))[1]
    loop._auto_pooled_step_fn = lambda state, key, b, gs, budget: (budgets.append(budget), (state, {}))[1]
    loop._scan_step_fn = scan
    run_chunks(loop, jax.random.PRNGKey(0), chunks)
    return budgets, measured


def port_rules(monkeypatch, budget_cfg, start, interval, chunks):
    loop = port_loop(pool_budget_per_ray=budget_cfg, pool_start_step=start, update_interval=4)
    loop._AUTO_REBUDGET_INTERVAL = interval
    budgets, measured = [], []

    def demand(renderer, rays, grid_state, transmittance_eps=0.0, generator=None):
        measured.append(loop._host_step)
        return torch.tensor(demand_at(loop._host_step))

    monkeypatch.setattr(occ_render.OccupancyRenderer, "mean_sample_demand", demand)
    loop._refresh_grid = lambda **kw: None
    loop._grad_step = lambda batch, budget=None, **kw: budgets.append(budget) or {}
    run_chunks(loop, 0, chunks)
    return budgets, measured


def run_chunks(loop, base, chunks):
    batch = ray_batch(0, 16)
    for k in chunks:
        if k == 1:
            loop.step_auto(base, batch)
        else:
            loop.step_auto_many(base, np.stack([batch] * k))


@pytest.mark.parametrize("budget_cfg,start,interval,chunks", [
    ("auto", 3, 5, [1] * 24),                 # step_auto: resolved after the increment
    ("auto", 8, 6, [4] * 8),                  # aligned macro steps: once a macro, before it
    ("auto", 5, 4, [3, 5, 1, 2, 4, 4, 3, 7]),  # macro steps straddling the start, mixed with single steps
    (3.0, 4, 256, [3, 5, 1, 1, 4]),           # a fixed budget
])
def test_pool_switchover_macro_split_and_auto_cadence_follow_the_jax_loop(
        monkeypatch, capsys, budget_cfg, start, interval, chunks):
    want = jax_rules(budget_cfg, start, interval, chunks)
    jax_printed = [line for line in capsys.readouterr().out.splitlines() if "auto pool budget" in line]
    got = port_rules(monkeypatch, budget_cfg, start, interval, chunks)
    printed = [line for line in capsys.readouterr().out.splitlines() if "auto pool budget" in line]
    assert got == want
    assert printed == jax_printed and (len(printed) > 1) == (budget_cfg == "auto")
    assert got[0][:start] == [None] * start and None not in got[0][start:]


# -- real steps -------------------------------------------------------------


def test_pooled_steps_log_their_drops_and_learn():
    """The switchover of tests/test_occupancy.py::test_pooled_training_step_switch:
    dense steps first, then pooled ones with the counter (0 at a budget of
    K), and the loss falls."""
    loop = port_loop(pool_budget_per_ray=float(SAMPLES), pool_start_step=3, update_interval=4,
                     grid_warmup_updates=1)
    batch = ray_batch(100)
    losses = []
    for i in range(8):
        values = loop.step_auto(5, batch)
        losses.append(float(values["fine"]))
        assert ("fine_pool_dropped" in values) == (i >= 3)
        if i >= 3:
            assert int(values["fine_pool_dropped"]) == 0
    assert loop._host_step == 8 and np.isfinite(losses).all() and losses[-1] < losses[0]
    # An undersized pool drops survivors, and says so.
    loop.pool_budget_per_ray = 0.25
    assert int(loop.step_auto(5, batch)["fine_pool_dropped"]) > 0


@pytest.mark.parametrize("budget_cfg", [4.0, "auto"])
def test_pickle_resume_past_the_switchover_steps_pooled_at_once(tmp_path, budget_cfg):
    def make():
        torch.manual_seed(0)
        return port_loop(pool_budget_per_ray=budget_cfg, pool_start_step=3, update_interval=4,
                         grid_warmup_updates=1)

    a = make()
    for s in range(5):
        a.step_auto(5, ray_batch(s))
    assert (a._auto_per_ray is not None) == (budget_cfg == "auto")
    path = str(tmp_path / "ckpt.pkl")
    a.save(path)
    b = make()
    b.load(path)
    assert b._host_step == b.step_count == 5 and b._auto_per_ray is None
    values = b.step_auto(5, ray_batch(5))  # the next step is pooled: the counter is logged
    assert "fine_pool_dropped" in values and b._host_step == 6
    assert (b._auto_per_ray is not None) == (budget_cfg == "auto")


def test_misaligned_macro_steps_equal_single_steps():
    """8 single steps, two macro steps of 4 and macro steps of 3 and 5
    around pool_start_step = 4 leave the same parameters and grid, bit for
    bit (tests/test_occupancy.py::test_step_auto_many_matches_per_step)."""
    def make():
        torch.manual_seed(0)
        return port_loop(pool_budget_per_ray=4.0, pool_start_step=4, update_interval=4,
                         update_cells=64, grid_warmup_updates=1)

    batches = np.stack([ray_batch(s, 16) for s in range(8)])
    loops, last = [], []
    for chunks in ([1] * 8, [4, 4], [3, 5]):
        loop = make()
        done = 0
        for k in chunks:
            values = loop.step_auto_many(7, batches[done:done + k])
            done += k
        loops.append(loop)
        last.append({k: float(v) for k, v in values.items()})
    for other, other_last in zip(loops[1:], last[1:]):
        assert other._host_step == other.step_count == 8
        assert other_last == last[0] and "fine_pool_dropped" in other_last
        for pa, pb in zip(loops[0].model.parameters(), other.model.parameters()):
            assert torch.equal(pa, pb)
        assert torch.equal(loops[0].grid_state.densities, other.grid_state.densities)


# -- the pooled composite's autograd function ---------------------------------


def pooled_inputs(seed, n=37, k=6, rows=140, extras=4):
    """A pool of ``rows`` with rays of 0 to k samples, a part-full tail, a
    few masked rays."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, k + 1, n)
    counts[0], counts[1] = 0, k
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    assert starts[-1] < rows
    values = [rng.uniform(0, 8, rows).astype(np.float32), starts,
              rng.uniform(0.05, 0.4, (n, 1)).astype(np.float32),
              rng.uniform(-1, 1, (rows, 3)).astype(np.float32), np.array([-1.0, 0.3, 1.0], np.float32),
              rng.rand(n) < 0.85, rng.uniform(-1, 1, (rows, extras)).astype(np.float32)]
    return [t(v) for v in values]


def test_pooled_autograd_function_with_plain_launchers(monkeypatch):
    """RenderCompositePooled's wiring, with the plain version behind both
    launchers: outputs carry a grad_fn, gradients reach densities, colours,
    background and extras (zeros on the pool's tail), a missing cotangent
    goes on as None, and widths that want a gradient are refused."""
    seen = {}

    def forward(densities, starts, deltas, rgbs, background, mask, extras, samples):
        outs = kc.render_composite_pooled_reference(densities, starts, deltas, rgbs, background, mask, extras,
                                                    samples)
        return tuple(None if o is None else o.detach() for o in outs)

    def backward(densities, starts, deltas, rgbs, background, mask, extras, samples, g_out, g_alpha, g_ex,
                 wanted):
        seen["none"], seen["wanted"] = [g is None for g in (g_out, g_alpha, g_ex)], wanted
        leaves = [v.detach().requires_grad_() for v in (densities, rgbs, background, extras)]
        with torch.enable_grad():
            outs = kc.render_composite_pooled_reference(leaves[0], starts, deltas, leaves[1], leaves[2], mask,
                                                        leaves[3], samples)
            pairs = [(o, g) for o, g in zip(outs, (g_out, g_alpha, g_ex)) if g is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])
        return (grads[0], *(g if want else None for g, want in zip(grads[1:], wanted)))

    monkeypatch.setattr(kc, "_pooled_forward_launcher", forward)
    monkeypatch.setattr(kc, "_pooled_backward_launcher", backward)
    densities, starts, deltas, rgbs, background, mask, extras = pooled_inputs(0)
    leaves = [v.requires_grad_() for v in (densities, rgbs, background, extras)]
    outs = kc.RenderCompositePooled.apply(leaves[0], starts, deltas, leaves[1], leaves[2], mask, leaves[3], 6)
    assert len(outs) == 3 and all(o.grad_fn is not None for o in outs)
    rng = np.random.RandomState(1)
    g_out, g_ex = t(rng.randn(37, 3).astype(np.float32)), t(rng.randn(37, 4).astype(np.float32))
    ((outs[0] * g_out).sum() + (outs[2] * g_ex).sum()).backward()
    assert seen["none"] == [False, True, False] and seen["wanted"] == (True, True, True)

    ref_leaves = [v.detach().requires_grad_() for v in leaves]
    ref = kc.render_composite_pooled_reference(ref_leaves[0], starts, deltas, ref_leaves[1], ref_leaves[2],
                                               mask, ref_leaves[3], 6)
    ((ref[0] * g_out).sum() + (ref[2] * g_ex).sum()).backward()
    tail = int(starts[-1])
    for got, want in zip(leaves, ref_leaves):
        torch.testing.assert_close(got.grad, want.grad)
        assert got.grad.abs().max() > 0
    assert all(v.grad[tail:].abs().max() == 0 for v in (leaves[0], leaves[1], leaves[3]))
    with pytest.raises(ValueError, match="no gradient"):
        kc.RenderCompositePooled.apply(densities, starts, deltas.clone().requires_grad_(), rgbs, background,
                                       mask, None, 6)


def test_pooled_plain_version_equals_the_dense_one_on_the_same_samples():
    """The pool gathered back to [N, K] slots is the dense composite of
    those slots: outputs, alphas and extras, masked rays included."""
    densities, starts, deltas, rgbs, background, mask, extras = pooled_inputs(2)
    n, k = starts.shape[0] - 1, 6
    dense = [torch.zeros(n, k), torch.zeros(n, k, 3), torch.zeros(n, k, 4)]
    for r in range(n):
        a, b = int(starts[r]), int(starts[r + 1])
        for dst, src in zip(dense, (densities, rgbs, extras)):
            dst[r, : b - a] = src[a:b]
    want = kc.render_composite_reference(dense[0], deltas, dense[1], background, mask, dense[2])
    got = kc.render_composite_pooled(densities, starts, deltas, rgbs, background, mask, extras, k)
    for g, w in zip(got, (want[0], want[2], want[3])):
        torch.testing.assert_close(g, w)


@pytest.mark.parametrize("case", ["on the cpu", "65 samples", "int64 starts", "rgbs", "9 extras", "cotangent",
                                  "3 rays a warp"])
def test_pooled_cuda_wrappers_refuse_what_the_kernels_do_not_take(case, monkeypatch):
    args = pooled_inputs(3)
    samples = 65 if case == "65 samples" else 6
    if case == "int64 starts":
        args[1] = args[1].long()
    elif case == "rgbs":
        args[3] = args[3][:-1]
    elif case == "9 extras":
        args[6] = torch.zeros(140, 9)
    elif case == "3 rays a warp":  # the kernels take 1, 2, 4, ..., 32
        monkeypatch.setattr(kc, "pooled_rays_per_warp", lambda n, rows: 3)
    message = {"on the cpu": "CUDA", "65 samples": "1 to 64 samples", "9 extras": "1 to 8 extras",
               "cotangent": "cotangent of outputs", "3 rays a warp": "rays a warp"}.get(case, "want [a-z]+ torch")
    with pytest.raises(ValueError, match=message):
        if case == "cotangent":
            kc.composite_pooled_backward_cuda(*args, samples, torch.zeros(37, 2), None)
        else:
            kc.composite_pooled_forward_cuda(*args, samples)
    assert kc.MAX_POOLED_SAMPLES == 64 and kc.POOLED_RAYS_PER_WARP == (1, 2, 4, 8, 16, 32)


# -- the CLIs -----------------------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("pooled_scene")), num_views=3, resolution=12)


@pytest.mark.parametrize("budget", ["auto", "4"])
def test_train_cli_pools_after_the_start_step(scene, tmp_path, capsys, budget):
    pkl = str(tmp_path / "pooled.pkl")
    train_nerf.main([*SMALL_FLAGS, "--occ_train_budget", budget, "--occ_train_budget_start", "2",
                     "--steps", "4", "--save_path", pkl, scene])
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("step ")]
    assert [("fine_pool_dropped=" in line) for line in lines] == [False, False, True, True]
    assert all(float(re.search(r"fine_pool_dropped=(\S+)", line).group(1)) == 0 for line in lines[2:])
    assert ("auto pool budget: " in out) == (budget == "auto")


def test_eval_psnr_reports_the_jax_packages_metrics(scene, tmp_path, capsys):
    pkl = str(tmp_path / "eval.pkl")
    train_nerf.main([*SMALL_FLAGS, "--occ_train_budget", "auto", "--occ_train_budget_start", "1",
                     "--steps", "3", "--save_path", pkl, scene])
    capsys.readouterr()
    flags = ["--seed", "0", "--batch_size", "64", "--instant_ngp", "--occupancy", "--occ_candidates", "16",
             "--occ_samples", "4", "--occ_budget_per_ray", "auto", "--device", "cpu", "--model_path", pkl]
    scores, ssims = eval_psnr.main([*flags, scene])
    out = capsys.readouterr().out
    assert re.findall(r"view (\d): psnr=", out) == ["0", "1", "2"]
    assert f"mean_psnr={np.mean(scores):.3f}" in out and f"mean_ssim={np.mean(ssims):.4f}" in out

    # The same images, rendered again in the same order, under the JAX
    # package's metrics.
    args = render_nerf.argparser().parse_args([*flags, f"{scene}/metadata.json"])
    session = render_nerf.RenderSession(args)
    for view, score, s in zip(load_dataset(scene).views, scores, ssims):
        gt = view.image()
        pred = session.render_view(view, width=gt.shape[1], height=gt.shape[0])
        assert score == jmetrics.psnr(pred, gt) and s == jmetrics.ssim(pred, gt)
        assert np.isfinite(score) and 0 < s < 1


def test_metrics_equal_the_jax_packages():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (23, 17, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-20, 21, a.shape), 0, 255).astype(np.uint8)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b) and metrics.psnr(a, a) == float("inf")
    assert metrics.ssim(a, b) == jmetrics.ssim(a, b) and metrics.ssim(a[..., 0], b[..., 0]) == jmetrics.ssim(
        a[..., 0], b[..., 0])
    with pytest.raises(ValueError, match="smaller than"):
        metrics.ssim(a[:10], b[:10])
