"""The occupancy loop's hot route (``step_auto`` / ``step_auto_many`` as a
host prologue and a body that the card replays as a CUDA graph,
``learn_nerf_tpu_torch.step_graph``) on the CPU, at the small size of
``tests/test_torch_train.py``.

* The prologue plus the eager body equals the step as it was before the
  split, bit for bit: ``step()`` fed the draws that ``step_auto`` made from
  its seeds (the grid refresh's from ``(base, 1, host step)``, the candidate
  uniforms and the density penalty's from ``(base, 0, train step)``), dense,
  pooled at a fixed budget and at ``auto``, with the density penalty,
  across refreshes and the warmup exit.
* The static grid (``acceleration.StaticGridState``): densities copied into
  one storage and words rebuilt into one buffer equal ``update`` plus a
  fresh ``pack_occupancy_words``, and nothing is rebuilt while the state
  stands.
* A stand-in for the CUDA graph (``StepGraphs._capture`` swapped, as the
  kernel tests swap their launchers; its replay runs the body again with
  the launch counters untouched and writes the body's outputs, the logged
  values and the gradients, into the captured ones): one capture per
  ``(rays, budget, warmup)`` key, a new one at the warmup exit and at a
  change of budget, none on the CPU or under a process group; launch
  counters and the step counters advance once a replay and never at
  capture; the dict of step t survives step t+1; the optimizer steps on
  the replay's gradients; a load keeps the graphs; the route equals the
  eager one bit for bit; each capture follows one eager run of the body,
  which moves no counter; the cyclic garbage collector is off while a
  graph captures.
* The composite backward's scratch, which a graph captures: slots that a
  larger launch outgrows are kept alive, and none is made while a graph
  captures.
* The density penalty's bbox, ``cell_positions`` and the Ref-NeRF
  encoding's band indices make no tensor from Python values once the loop
  stands.
"""

import sys

import numpy as np
import pytest
import torch

from learn_nerf_tpu_torch import acceleration, step_graph, train
from learn_nerf_tpu_torch.kernels import build
from learn_nerf_tpu_torch.kernels import composite as kc
from learn_nerf_tpu_torch.ops import sh

from .test_torch_train import CANDIDATES, GRID, port_loop, ray_batch

torch.set_num_threads(1)

PENALTY_BATCH = 32


def make(**kw):
    torch.manual_seed(0)
    return port_loop(update_interval=3, update_cells=300, grid_warmup_updates=2, density_penalty=0.01,
                     density_penalty_batch_size=PENALTY_BATCH, ema_decay=0.9, **kw)


def reference_step(loop, base, batch):
    """The step as ``step_auto`` took it before the split: ``step()`` fed
    the draws of the step's seeds, in the order the eager loss draws them."""
    ids = jitter = None
    if loop._refresh_due():
        g = torch.Generator().manual_seed(train.fold_seed(base, train.GRID_TAG, loop._host_step))
        ids = torch.randint(0, GRID**3, (loop.update_cells,), generator=g)
        jitter = torch.rand((max(loop.grid_refresh_samples, 1), loop.update_cells, 3), generator=g)
    g = torch.Generator().manual_seed(train.fold_seed(base, train.TRAIN_TAG, loop.step_count))
    u = torch.rand((batch.shape[0], CANDIDATES), generator=g)
    draws = (torch.rand((PENALTY_BATCH, 3), generator=g), torch.randn((PENALTY_BATCH, 3), generator=g))
    return loop.step(batch, u=u, density_draws=draws, grid_ids=ids, grid_jitter=jitter)


def assert_same(a, b):
    for pa, pb in zip(a._leaves(), b._leaves()):
        assert torch.equal(pa, pb)
    for pa, pb in zip(a._ema_models["fine"].parameters(), b._ema_models["fine"].parameters()):
        assert torch.equal(pa, pb)
    assert torch.equal(a.grid_state.densities, b.grid_state.densities) and a.grid_state.step == b.grid_state.step
    assert (a._host_step, a.step_count, a._opt_count) == (b._host_step, b.step_count, b._opt_count)


@pytest.mark.parametrize("pooled", [None, 3.0, "auto"])
def test_the_hot_route_equals_the_step_before_the_split(pooled):
    kw = {} if pooled is None else dict(pool_budget_per_ray=pooled, pool_start_step=4)
    hot, ref = make(**kw), make(**kw)
    if pooled == "auto":
        hot._AUTO_REBUDGET_INTERVAL = ref._AUTO_REBUDGET_INTERVAL = 3
    steps = 10  # refreshes at host steps 0, 3, 6, 9; the warmup ends at the second
    warm = []
    for s in range(steps):
        batch = ray_batch(s)
        got, want = hot.step_auto(7, batch), reference_step(ref, 7, batch)
        assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
        assert ("fine_pool_dropped" in got) == (pooled is not None and s >= 4)
        assert_same(hot, ref)
        warm.append(hot.grid.in_warmup(hot.grid_state))
    assert warm[0] and not warm[-1]
    assert hot.captures == hot.graph_replays == 0  # no graph on the CPU


def test_macro_steps_on_the_hot_route_equal_the_step_before_the_split():
    hot, ref = make(pool_budget_per_ray=3.0, pool_start_step=4), make(pool_budget_per_ray=3.0, pool_start_step=4)
    batches = np.stack([ray_batch(s) for s in range(9)])
    done = 0
    for k in (3, 4, 2):  # the second straddles pool_start_step
        values = hot.step_auto_many(7, batches[done:done + k])
        for batch in batches[done:done + k]:
            want = reference_step(ref, 7, batch)
        done += k
        assert {k: float(v) for k, v in values.items()} == {k: float(v) for k, v in want.items()}
    assert_same(hot, ref)


def test_the_static_grid_follows_update_in_place():
    loop = make()
    grid, state = loop.grid, loop.grid_state
    static = acceleration.StaticGridState(grid)
    first = static.follow(state)
    densities, words = static.densities, static.words
    assert torch.equal(first.densities, state.densities) and first.step == state.step
    assert torch.equal(words, acceleration.pack_occupancy_words(state.densities, grid.resolution, grid.threshold))
    for step in range(4):  # each refresh returns new densities: the storage takes them in place
        g = torch.Generator().manual_seed(step)
        state = grid.update(state, loop.model, num_cells=300, generator=g)
        followed = static.follow(state)
        assert followed.densities is densities and static.words is words and followed.step == state.step
        assert torch.equal(densities, state.densities)
        assert torch.equal(words, acceleration.pack_occupancy_words(state.densities, grid.resolution,
                                                                    grid.threshold))
    # In place on the state's own tensor: its _version moves.
    state.densities.mul_(3.0)
    static.follow(state)
    assert torch.equal(densities, state.densities)
    assert torch.equal(words, acceleration.pack_occupancy_words(state.densities, grid.resolution, grid.threshold))


def test_the_static_grid_rebuilds_nothing_while_the_state_stands(monkeypatch):
    loop = make()
    static = acceleration.StaticGridState(loop.grid)
    packs = []
    pack = acceleration.pack_occupancy_words
    monkeypatch.setattr(acceleration, "pack_occupancy_words", lambda *a: packs.append(1) or pack(*a))
    for _ in range(3):
        static.follow(loop.grid_state)
    assert len(packs) == 1
    loop.grid_state = acceleration.OccupancyGridState(loop.grid_state.densities.clone(), loop.grid_state.step)
    static.follow(loop.grid_state)  # another state: built again
    assert len(packs) == 2


# -- the graph route with a stand-in for the CUDA graph ------------------------


class FakeGraph:
    """A captured body's stand-in: each replay runs the body, with every
    launch counter as it was (a replay runs no Python), and writes its
    outputs (the packed logged values, the gradients) into the captured
    ones, as a replay writes the graph's."""

    def __init__(self, body, outputs):
        self.body, self.outputs = body, outputs

    def replay(self):
        counts = [(c.launches, c.plain_calls) for c in build.COUNTERS]
        (_, fresh_groups), fresh_grads = self.body()
        for c, (launches, plain) in zip(build.COUNTERS, counts):
            c.launches, c.plain_calls = launches, plain
        (_, groups), grads = self.outputs
        for (stacked, _), (new, _) in zip(groups.values(), fresh_groups.values()):
            stacked.copy_(new)
        for grad, new in zip(grads, fresh_grads):
            grad.copy_(new)


def fake_capture(loop, log):
    """``StepGraphs._capture`` for ``loop`` on the CPU: the body runs once,
    so its host-side effects happen (it computes gradients and values, and
    moves no parameter: the optimizer is outside it), and ``(host step,
    train step)`` of each capture is logged."""

    def capture(self, body):
        outputs = body()
        log.append((loop._host_step, loop.step_count))
        return FakeGraph(body, outputs), outputs

    return capture


def test_one_capture_per_key_and_a_replay_a_step(monkeypatch):
    kw = dict(pool_budget_per_ray=3.0, pool_start_step=6)
    graphed, eager = make(**kw), make(**kw)
    captured = []
    graphed._graphs = step_graph.StepGraphs(torch.device("cpu"))
    monkeypatch.setattr(step_graph.StepGraphs, "_capture", fake_capture(graphed, captured))

    def run(loop):
        counters = [(c.launches, c.plain_calls) for c in build.COUNTERS]
        dicts = [loop.step_auto(7, ray_batch(s)) for s in range(8)]
        loop.pool_budget_per_ray = 2.0  # a change of bucket
        dicts += [loop.step_auto(7, ray_batch(s)) for s in range(8, 10)]
        loop.pool_budget_per_ray = 3.0  # back to a key captured already
        dicts += [loop.step_auto(7, ray_batch(s)) for s in range(10, 12)]
        moved = [(c.launches - a, c.plain_calls - b) for c, (a, b) in zip(build.COUNTERS, counters)]
        return dicts, moved

    got, got_moved = run(graphed)
    want, want_moved = run(eager)
    # (host step, train step) at each capture: the key (64, None, warmup)
    # at the second step (the first is eager), (64, None, past warmup) at
    # the warmup exit (the refresh before step index 3 is the grid's
    # second), (64, 192, False) at pool_start_step, (64, 128, False) at the
    # change; the return to 192 replays.
    assert captured == [(2, 1), (4, 3), (7, 6), (9, 8)]
    assert graphed.captures == 4 and graphed.graph_replays == 11
    assert graphed.step_count == graphed._opt_count == graphed._host_step == 12
    # Every step's dict read after the run: each survived the replays after it.
    assert [{k: float(v) for k, v in d.items()} for d in got] == [{k: float(v) for k, v in d.items()} for d in want]
    assert got_moved == want_moved and any(plain for _, plain in got_moved)
    assert_same(graphed, eager)


def test_a_load_keeps_the_graphs(monkeypatch, tmp_path):
    """A load copies into the parameters the graphs read, and Adam and the
    average are outside them: after ``load_full`` the next steps replay,
    and equal an eager loop's bit for bit."""
    graphed, eager = make(), make()
    graphed._graphs = step_graph.StepGraphs(torch.device("cpu"))
    monkeypatch.setattr(step_graph.StepGraphs, "_capture", fake_capture(graphed, []))
    for s in range(3):
        for loop in (graphed, eager):
            loop.step_auto(7, ray_batch(s))
    assert graphed.captures == 1 and graphed.graph_replays == 2
    path = str(tmp_path / "state.pt")
    eager.save_full(path)
    for loop in (graphed, eager):
        loop.load_full(path)
    for s in range(3, 5):
        got, want = graphed.step_auto(7, ray_batch(s)), eager.step_auto(7, ray_batch(s))
        assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    assert graphed.captures == 2 and graphed.graph_replays == 4  # the warmup's exit at host step 3
    assert_same(graphed, eager)


def test_each_capture_follows_an_eager_run_of_the_body(monkeypatch):
    """At a key's first use the body runs once eagerly, its results dropped
    and its launches uncounted, before the capture: what it makes on first
    use at a new size is then made outside the graphs' pool."""
    log = []
    counter = build.COUNTERS[0]
    monkeypatch.setattr(counter, "launches", counter.launches)

    def body():
        log.append("body")
        counter.launches += 1
        return dict(fine=torch.tensor(1.0))

    def capture(self, fn):
        log.append("capture")
        outputs = fn()
        return FakeGraph(fn, outputs), outputs

    monkeypatch.setattr(step_graph.StepGraphs, "_capture", capture)
    graphs = step_graph.StepGraphs(torch.device("cpu"))
    start = counter.launches
    graphs.run("a", body, [])
    assert log == ["body"]  # the run's first step, eager
    graphs.run("b", body, [])
    assert log == ["body", "body", "capture", "body", "body"]  # warm-up, capture, replay
    graphs.run("b", body, [])
    assert log[5:] == ["body"] and (graphs.captures, graphs.replays) == (1, 2)
    assert counter.launches - start == 3  # once a step


def test_a_capture_runs_with_the_cyclic_collector_off(monkeypatch):
    """A collection inside a capture that frees a dead graph (one in a
    reference cycle) destroys it mid-capture, which invalidates the
    capture: the collector is off while the body is captured, and back on
    after it, when the body raises too; left off if it was off."""
    import contextlib
    import gc

    seen = []
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "stream")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, pool, stream: contextlib.nullcontext())
    graphs = step_graph.StepGraphs(torch.device("cpu"))

    def body():
        seen.append(gc.isenabled())
        return "outputs"

    assert gc.isenabled()
    assert graphs._capture(body) == ("graph", "outputs") and seen == [False] and gc.isenabled()
    with pytest.raises(ZeroDivisionError):
        graphs._capture(lambda: 1 / 0)
    assert gc.isenabled()
    gc.disable()
    try:
        graphs._capture(body)
        assert seen == [False, False] and not gc.isenabled()
    finally:
        gc.enable()


def test_the_composite_scratch_a_graph_captured_is_never_freed(monkeypatch):
    """A launch that needs more per-block slots than the last one gets new
    ones, and the old ones are kept (a graph that captured them writes them
    at every replay); while a graph captures, making them raises."""
    monkeypatch.setattr(kc, "_scratch", {})
    monkeypatch.setattr(kc, "_retired", [])
    cpu = torch.device("cpu")
    ticket, small = kc._background_scratch(cpu, 4)
    assert ticket.tolist() == [0] and small.numel() == 12
    assert kc._background_scratch(cpu, 3) == (ticket, small)
    again, large = kc._background_scratch(cpu, 8)
    assert again is ticket and large.numel() == 24 and kc._retired == [small]
    assert kc._background_scratch(cpu, 8) == (ticket, large)
    card = torch.device("cuda", 0)
    kc._scratch[card] = (ticket, large)  # as a card's scratch: the capture test runs before any allocation
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert kc._background_scratch(card, 8) == (ticket, large)  # fits: nothing is made
    with pytest.raises(RuntimeError, match="while a CUDA graph captures"):
        kc._background_scratch(card, 9)
    assert kc._scratch[card] == (ticket, large) and kc._retired == [small]


def test_no_graph_on_the_cpu_or_under_a_process_group():
    assert step_graph.step_graphs(torch.device("cpu"), None) is None
    assert step_graph.step_graphs(torch.device("cuda"), object()) is None
    assert isinstance(step_graph.step_graphs(torch.device("cuda"), None), step_graph.StepGraphs)
    loop = make()
    assert loop._graphs is None
    loop.step_auto(7, ray_batch(0))
    assert loop.captures == loop.graph_replays == 0


def test_the_packed_outputs_keep_each_value_and_its_type():
    values = dict(fine=torch.tensor(0.5), fine_pool_dropped=torch.tensor(3), grad_norm=torch.tensor(2.0))
    packed = step_graph._packed(values)
    got = step_graph._unpacked(packed)
    assert list(got) == list(values)
    assert all(torch.equal(got[k], v) and got[k].dtype == v.dtype for k, v in values.items())
    packed[1][torch.float32][0].zero_()  # the next replay writes the outputs: the dict keeps its values
    assert float(got["fine"]) == 0.5


# -- host copies ----------------------------------------------------------------


def test_no_tensor_from_python_values_once_the_loop_stands(monkeypatch):
    """After the first step, the loop's own code (train.py, acceleration.py)
    and the Ref-NeRF band indices build no tensor from Python values: on the
    card that is a host copy, which capture forbids."""
    loop = make()
    loop.step_auto(7, ray_batch(0))
    made = []
    tensor = torch.tensor

    def recording(*args, **kwargs):
        made.append(sys._getframe(1).f_code.co_filename)
        return tensor(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", recording)
    for s in range(1, 5):  # refreshes at host steps 3 (cell_positions) and every step's penalty
        loop.step_auto(7, ray_batch(s))
    ids = torch.arange(8)
    loop.grid.cell_positions(ids, torch.rand(8, 3))
    sh.integrated_dir_enc(4, torch.nn.functional.normalize(torch.randn(5, 3), dim=-1), torch.rand(5, 1))
    mine = [f for f in made if f.endswith(("train.py", "acceleration.py", "sh.py"))]
    assert mine == []


def test_band_indices_equal_the_listed_bands():
    for degree in range(1, 9):
        want = [l for l in range(degree) for _ in range(2 * l + 1)]
        got = sh.sh_band_indices(degree)
        assert got.dtype == torch.float32 and got.tolist() == want
