"""The hierarchy loop's hot route (``TrainLoop.step_auto`` /
``step_auto_many`` as a host prologue and a body that the card replays as
a CUDA graph, ``learn_nerf_tpu_torch.step_graph``) on the CPU, for the
five models the hierarchy trains: vanilla f32, vanilla bf16 (its
flax-rounded route), Instant-NGP, and Ref-NeRF on the vanilla trunk and on
the hash grid.  The small sizes of ``tests/test_torch_train_hierarchy.py``
and ``tests/test_torch_ref_nerf.py``: batch 64, 8 coarse + 8 fine samples.

* The prologue plus the eager body equals the step as it was before the
  split, bit for bit: ``step()`` with a generator seeded as ``step_auto``
  seeds it, over three steps with the density penalty on and off and the
  EMA on (the logged values, every parameter, Adam's state, the average).
* ``step_auto_many`` of K equals K ``step_auto`` calls.
* One hot-route step with JAX's own uniforms written into the static
  buffers matches the JAX loop's jitted step: every logged value within
  1e-5 (the Ref-NeRF aux terms within the bound that the eager parity
  test in ``tests/test_torch_ref_nerf.py`` sets from its measurements).
* A stand-in for the CUDA graph (``StepGraphs._capture`` swapped, as in
  ``tests/test_torch_train_graph.py``): one capture a batch size and a
  replay a step after the first, a second size captured once and a return
  to the first replayed; a load keeps the graphs; each capture follows one
  eager run of the body; no graph on the CPU or under a process group.
* Once the loop stands, the body builds no tensor from Python values (on
  the card a host copy, which a capture forbids), Ref-NeRF included.
"""

import functools
import os
import sys
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from learn_nerf_tpu import train as jtrain
from learn_nerf_tpu_torch import step_graph, train
from learn_nerf_tpu_torch.kernels import build
from learn_nerf_tpu_torch.parallel.mesh import Mesh

from . import test_torch_ref_nerf as ref_nerf
from . import test_torch_train_hierarchy as hierarchy
from .test_torch_train import ray_batch
from .test_torch_train_graph import FakeGraph

torch.set_num_threads(1)

FAMILIES = ("vanilla", "vanilla bf16", "ngp", "ref-nerf", "ref-nerf ngp")
PACKAGE = os.path.dirname(train.__file__)
SEED = 7


@functools.lru_cache(maxsize=None)
def family_trees(family):
    """``(kind, coarse tree, fine tree)`` of a family's small models, the
    parity tests' own."""
    if family in ("ref-nerf", "ref-nerf ngp"):
        kind = "vanilla" if family == "ref-nerf" else "hybrid"
        return (kind, *ref_nerf.hierarchy_trees(kind, 30))
    kind = "ngp" if family == "ngp" else "vanilla"
    return (kind, *hierarchy.trees(kind))


def make_loop(family, **kw):
    kind, coarse_tree, fine_tree = family_trees(family)
    if family in ("ref-nerf", "ref-nerf ngp"):
        coarse_cfg, fine_cfg = ref_nerf.hierarchy_configs(kind)
        coarse = ref_nerf.port_model(kind, coarse_tree, coarse_cfg)
        fine = ref_nerf.port_model(kind, fine_tree, fine_cfg)
    else:
        dtype = "bfloat16" if family == "vanilla bf16" else "float32"
        coarse, fine = hierarchy.port_models(kind, coarse_tree, fine_tree, dtype)
    adam = hierarchy.NGP_ADAM if kind in ("ngp", "hybrid") else {}
    return train.TrainLoop(coarse, fine, lr=1e-3, coarse_ts=hierarchy.COARSE_TS, fine_ts=hierarchy.FINE_TS,
                           **hierarchy.BBOX, **adam, **kw)


def loop_kw(penalty=0.05):
    return dict(ema_decay=0.9, density_penalty=penalty, density_penalty_batch_size=hierarchy.PENALTY_BATCH)


def reference_step(loop, batch, base=SEED):
    """The step as ``step_auto`` took it before the split: ``step()`` with a
    generator seeded from ``(base, 0, train step)``, drawing inside the
    loss."""
    generator = torch.Generator().manual_seed(train.fold_seed(base, train.TRAIN_TAG, loop.step_count))
    return loop.step(batch, generator=generator)


def floats(values):
    return {k: float(v) for k, v in values.items()}


def assert_same(a, b):
    """Parameters, Adam's state, the average and the counters, bit for bit."""
    for pa, pb in zip(a._leaves(), b._leaves()):
        assert torch.equal(pa, pb)
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    for name in ("coarse", "fine"):
        for pa, pb in zip(a._ema_models[name].parameters(), b._ema_models[name].parameters()):
            assert torch.equal(pa, pb)
    assert torch.equal(a._ema_background, b._ema_background)
    assert (a.step_count, a._opt_count) == (b.step_count, b._opt_count)


@pytest.mark.parametrize("penalty", [None, 0.05])
@pytest.mark.parametrize("family", FAMILIES)
def test_the_hot_route_equals_the_step_before_the_split(family, penalty):
    hot, ref = make_loop(family, **loop_kw(penalty)), make_loop(family, **loop_kw(penalty))
    for s in range(3):
        batch = ray_batch(s)
        got, want = hot.step_auto(SEED, batch), reference_step(ref, batch)
        assert floats(got) == floats(want)
        assert ("fine_density" in got) == (penalty is not None)
        assert_same(hot, ref)
    assert sorted(hot._inputs[64]) == sorted(["batch", "u_coarse", "u_fine"]
                                             + (["coords_u", "dirs_normal"] if penalty else []))
    assert hot.captures == hot.graph_replays == 0  # no graph on the CPU


@pytest.mark.parametrize("family", FAMILIES)
def test_macro_steps_equal_step_auto_calls(family):
    single, macro = make_loop(family, **loop_kw()), make_loop(family, **loop_kw())
    batches = np.stack([ray_batch(s) for s in range(5)])
    for batch in batches:
        want = single.step_auto(SEED, batch)
    macro.step_auto_many(SEED, batches[:2])
    got = macro.step_auto_many(SEED, batches[2:])
    assert floats(got) == floats(want)
    assert_same(macro, single)
    assert macro.step_count == 5


def jax_step_and_state(family, density_penalty):
    """The JAX loop's jitted step body and its initial state on the
    family's trees."""
    kind, coarse_tree, fine_tree = family_trees(family)
    if family in ("ref-nerf", "ref-nerf ngp"):
        step_fn = ref_nerf.jax_hierarchy_step(kind, density_penalty)
    else:
        step_fn = hierarchy.jax_step(kind, density_penalty)
    adam = hierarchy.NGP_ADAM if kind in ("ngp", "hybrid") else {}
    params = dict(coarse=jax.tree_util.tree_map(jnp.asarray, coarse_tree),
                  fine=jax.tree_util.tree_map(jnp.asarray, fine_tree), background=jnp.array([-1.0, -1.0, -1.0]))
    tx = optax.adam(1e-3, b1=adam.get("adam_b1", 0.9), b2=adam.get("adam_b2", 0.999), eps=adam.get("adam_eps", 1e-7))
    return step_fn, jtrain.EmaTrainState.create(apply_fn=None, params=params, tx=tx)


@pytest.mark.parametrize("family", ["vanilla", "ngp", "ref-nerf", "ref-nerf ngp"])
def test_a_hot_route_step_with_jax_uniforms_matches_the_jax_step(family, monkeypatch):
    """The prologue writes JAX's own draws of the step's key into the static
    buffers (in place of the generator's), and the body reads them.  The
    key and batch of the eager parity tests' first step, on whose inputs
    the Ref-NeRF aux bound was measured."""
    step_fn, state = jax_step_and_state(family, 0.05)
    key, batch = jax.random.PRNGKey(40), ray_batch(41)
    _, want = step_fn(state, key, jnp.asarray(batch))
    draws = hierarchy.jax_draws(key)

    def jax_draws_into(self, inputs, batch, names):
        assert list(names) == ["u_coarse", "u_fine"]
        for name in names:
            inputs[name].copy_(draws[name])
        inputs["coords_u"].copy_(draws["density_draws"][0])
        inputs["dirs_normal"].copy_(draws["density_draws"][1])
        inputs["batch"].copy_(batch)
        return inputs["coords_u"], inputs["dirs_normal"]

    monkeypatch.setattr(train.TrainLoop, "_draw_inputs", jax_draws_into)
    loop = make_loop(family, density_penalty=0.05, density_penalty_batch_size=hierarchy.PENALTY_BATCH)
    got = floats(loop.step_auto(0, batch))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        aux = family.startswith("ref-nerf") and name.endswith(("normal", "normal_mse"))
        np.testing.assert_allclose(got[name], float(value), rtol=ref_nerf.AUX_STEP_BOUNDS[0] if aux else 1e-5,
                                   err_msg=name)


# -- the graph route with a stand-in for the CUDA graph ------------------------


def fake_capture(loop, log):
    """``StepGraphs._capture`` for ``loop`` on the CPU: the body runs once
    (it computes gradients and values and moves no parameter), and the
    train step of each capture is logged."""

    def capture(self, body):
        outputs = body()
        log.append(loop.step_count)
        return FakeGraph(body, outputs), outputs

    return capture


def graphed(family, monkeypatch, log, **kw):
    loop = make_loop(family, **kw)
    loop._graphs = step_graph.StepGraphs(torch.device("cpu"))
    monkeypatch.setattr(step_graph.StepGraphs, "_capture", fake_capture(loop, log))
    return loop


@pytest.mark.parametrize("family", FAMILIES)
def test_one_capture_a_batch_size_and_a_replay_a_step(family, monkeypatch):
    captured = []
    graph, eager = graphed(family, monkeypatch, captured, **loop_kw()), make_loop(family, **loop_kw())
    sizes = [64, 64, 64, 32, 32, 64]

    def run(loop):
        counters = [(c.launches, c.plain_calls) for c in build.COUNTERS]
        dicts = [loop.step_auto(SEED, ray_batch(s, n)) for s, n in enumerate(sizes)]
        moved = [(c.launches - a, c.plain_calls - b) for c, (a, b) in zip(build.COUNTERS, counters)]
        return dicts, moved

    got, got_moved = run(graph)
    want, want_moved = run(eager)
    # The first step runs eagerly; 64 rays captured at the second, 32 at
    # the fourth; the return to 64 replays.
    assert captured == [1, 3] and sorted(graph._graphs._graphs) == [(32,), (64,)]
    assert graph.captures == 2 and graph.graph_replays == 5 and graph.step_count == graph._opt_count == 6
    # Every step's dict read after the run: each survived the replays after it.
    assert [floats(d) for d in got] == [floats(d) for d in want]
    assert got_moved == want_moved and any(plain for _, plain in got_moved)
    assert_same(graph, eager)


@pytest.mark.parametrize("load", ["load_full", "load"])
def test_a_load_keeps_the_graphs(load, monkeypatch, tmp_path):
    """A load copies into the parameters the graph reads, and Adam and the
    average are outside it: after the load the next steps replay, and equal
    an eager loop's bit for bit."""
    graph, eager = graphed("ngp", monkeypatch, [], **loop_kw()), make_loop("ngp", **loop_kw())
    path = str(tmp_path / ("state.pt" if load == "load_full" else "params.pkl"))
    for s in range(3):
        for loop in (graph, eager):
            loop.step_auto(SEED, ray_batch(s))
        if s == 0:  # the state both loops load after step 2: not their own then
            (eager.save_full if load == "load_full" else eager.save)(path)
    saved = [p.clone() for p in graph._leaves()]
    for loop in (graph, eager):
        getattr(loop, load)(path)
    assert graph.step_count == 1 and not all(torch.equal(a, b) for a, b in zip(saved, graph._leaves()))
    for s in range(3, 5):
        assert floats(graph.step_auto(SEED, ray_batch(s))) == floats(eager.step_auto(SEED, ray_batch(s)))
    assert graph.captures == 1 and graph.graph_replays == 4
    assert_same(graph, eager)


def test_each_capture_follows_an_eager_run_of_the_body(monkeypatch):
    log = []
    loop = make_loop("vanilla", **loop_kw())
    loop._graphs = step_graph.StepGraphs(torch.device("cpu"))
    body = train.grad_body
    monkeypatch.setattr(train, "grad_body", lambda *a: log.append("body") or body(*a))

    def capture(self, fn):
        log.append("capture")
        outputs = fn()
        return FakeGraph(fn, outputs), outputs

    monkeypatch.setattr(step_graph.StepGraphs, "_capture", capture)
    loop.step_auto(SEED, ray_batch(0))
    assert log == ["body"]  # the run's first step, eager
    loop.step_auto(SEED, ray_batch(1))
    assert log[1:] == ["body", "capture", "body", "body"]  # warm-up, capture, replay
    loop.step_auto(SEED, ray_batch(2))
    assert log[5:] == ["body"] and (loop.captures, loop.graph_replays) == (1, 2)


def test_no_graph_on_the_cpu_or_under_a_process_group(monkeypatch, tmp_path):
    loop = make_loop("vanilla", **loop_kw())
    assert loop._graphs is None
    loop.step_auto(SEED, ray_batch(0))
    assert loop.captures == loop.graph_replays == 0
    # Under a process group (one gloo rank) the step is the eager one and
    # never goes through the hot route's prologue.
    monkeypatch.setattr(train.TrainLoop, "_hot_step", lambda *a: pytest.fail("the hot route under a process group"))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = Mesh(devices=(torch.device("cpu"),), group=dist.group.WORLD)
        grouped, alone = make_loop("vanilla", mesh=mesh, **loop_kw()), make_loop("vanilla", **loop_kw())
        assert grouped._graphs is None and grouped._dp is mesh
        got = grouped.step_auto(SEED, ray_batch(0))
        assert floats(got) == floats(reference_step(alone, ray_batch(0)))
        assert grouped.captures == grouped.graph_replays == 0
    finally:
        dist.destroy_process_group()


# -- host copies ----------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_the_body_builds_no_tensor_from_python_values(family, monkeypatch):
    """After the first step, the body (the loss, its gradients, the norms)
    builds no tensor from Python values or host arrays in the port's code:
    on the card that is a host copy, which capture forbids.  The kernels'
    plain versions (``*_reference``), which run for CPU tensors alone, are
    not the card's route and are left aside."""
    loop = make_loop(family, **loop_kw())
    loop.step_auto(SEED, ray_batch(0))
    made, inside = [], []
    body = train.grad_body

    def traced_body(*args):
        inside.append(True)
        try:
            return body(*args)
        finally:
            inside.pop()

    def recording(make):
        def call(*args, **kwargs):
            if inside:
                stack = traceback.walk_stack(sys._getframe(1))
                port = [f for f, _ in stack if f.f_code.co_filename.startswith(PACKAGE)]
                if port and not any(f.f_code.co_name.endswith("_reference") for f in port):
                    made.append(f"{port[0].f_code.co_filename}:{port[0].f_code.co_name}")
            return make(*args, **kwargs)
        return call

    monkeypatch.setattr(train, "grad_body", traced_body)
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, recording(getattr(torch, name)))
    for s in range(1, 3):
        loop.step_auto(SEED, ray_batch(s))
    assert made == []
