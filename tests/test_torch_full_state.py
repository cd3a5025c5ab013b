"""The port's full train state (``save_full`` / ``load_full``,
``checkpoint.save_train_state``) on the CPU, for both loops at small sizes.

* Six steps equal three steps, a save, a load and three more, bit for bit:
  the hierarchy (vanilla, and NGP with EMA), the occupancy loop, dense and
  pooled; Adam's moments, both step counters, the average and the grid
  all cross the file.
* ``_reconcile_ema``'s four cases, directly and through a loop.
* The file is plain (``torch.load(..., weights_only=True)``); a JAX msgpack
  full state and the other loop's state refuse; ``peek_train_state_step``.
* ``train_nerf --full_state_path``: a run stopped and resumed from its full
  state logs what the uninterrupted run logs, and with ``--lr_schedule
  cosine`` takes the uninterrupted run's lr at every step, as the JAX CLI's
  two resume rules (restored count, or the pickle's step as an offset) do.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from learn_nerf_tpu import checkpoint as jcheckpoint
from learn_nerf_tpu import train as jtrain
from learn_nerf_tpu_torch import checkpoint, train
from learn_nerf_tpu_torch.models import InstantNGPModel
from learn_nerf_tpu_torch.scripts import train_nerf

from .synthetic_scene import write_dataset
from .test_torch_train import BBOX, SMALL, ray_batch
from .test_torch_train import port_loop as occupancy_loop
from .test_torch_train_hierarchy import port_loop as hierarchy_loop

torch.set_num_threads(1)


def make(kind, **kw):
    torch.manual_seed(0)
    if kind == "hierarchy":
        return hierarchy_loop(density_penalty=0.01, **kw)
    if kind == "hierarchy ngp":
        return hierarchy_loop("ngp", ema_decay=0.9, **kw)
    if kind == "occupancy":
        return occupancy_loop(update_interval=2, update_cells=500, grid_warmup_updates=1, ema_decay=0.9, **kw)
    return occupancy_loop(update_interval=2, update_cells=500, grid_warmup_updates=1,
                          pool_budget_per_ray=3.0, pool_start_step=2, **kw)


@pytest.mark.parametrize("kind", ["hierarchy", "hierarchy ngp", "occupancy", "occupancy pooled"])
def test_resume_from_the_full_state_is_bit_for_bit(kind, tmp_path):
    batches = [ray_batch(s) for s in range(6)]
    a = make(kind)
    for batch in batches:
        a_values = a.step_auto(42, batch)
    c = make(kind)
    for batch in batches[:3]:
        c.step_auto(42, batch)
    path = str(tmp_path / "state.pt")
    c.save_full(path)
    d = make(kind)
    d.load_full(path)
    assert d.step_count == d._opt_count == 3
    for batch in batches[3:]:
        d_values = d.step_auto(42, batch)
    for pa, pd in zip(a._leaves(), d._leaves()):
        assert torch.equal(pa, pd)
    for name, state in a.eval_params.items():
        if name != "background":
            for k, v in state.items():
                assert torch.equal(v, d.eval_params[name][k]), (name, k)
    if kind.startswith("occupancy"):
        assert torch.equal(a.grid_state.densities, d.grid_state.densities)
        assert a.grid_state.step == d.grid_state.step and a._host_step == d._host_step == 6
    assert {k: float(v) for k, v in a_values.items()} == {k: float(v) for k, v in d_values.items()}


def test_restored_count_drives_the_schedule(tmp_path):
    schedule = train.cosine_decay_schedule(1e-2, 6, 0.1)
    c = make("hierarchy", lr=schedule)
    for s in range(3):
        c.step_auto(1, ray_batch(s))
    path = str(tmp_path / "state.pt")
    c.save_full(path)
    d = make("hierarchy", lr=schedule)
    d.load_full(path)
    d.step_auto(1, ray_batch(3))
    assert d.optimizer.param_groups[0]["lr"] == schedule(3)
    assert checkpoint.peek_train_state_step(path) == 3


@pytest.mark.parametrize("saved,enabled", [("absent", False), ("absent", True), ("tree", False), ("none", True)])
def test_reconcile_ema_cases(saved, enabled):
    params = dict(fine={"w": torch.ones(2)}, background=torch.zeros(3))
    raw = dict(params=params)
    if saved == "tree":
        raw["ema"] = dict(fine={"w": torch.full((2,), 5.0)}, background=torch.ones(3))
    elif saved == "none":
        raw["ema"] = None
    out = checkpoint._reconcile_ema(raw, enabled)
    if not enabled:
        assert out["ema"] is None  # nothing to seed, or a stale average dropped
    else:
        # Seeded from copies of the saved parameters, not aliases.
        assert torch.equal(out["ema"]["fine"]["w"], params["fine"]["w"])
        assert out["ema"]["fine"]["w"] is not params["fine"]["w"]


def test_load_full_reconciles_the_average_with_the_loop(tmp_path):
    path = str(tmp_path / "state.pt")
    plain = make("hierarchy")
    plain.step_auto(0, ray_batch(0))
    plain.save_full(path)
    averaged = make("hierarchy", ema_decay=0.5)
    averaged.load_full(path)  # saved EMA-off, loaded EMA-on: seeded from the parameters
    for k, v in averaged.eval_params["fine"].items():
        assert torch.equal(v, plain.fine.state_dict()[k])
    averaged.step_auto(0, ray_batch(1))
    averaged.save_full(path)
    back = make("hierarchy")
    back.load_full(path)  # saved EMA-on, loaded EMA-off: the raw parameters, no stale average
    assert back._ema_models is None
    for k, v in back.eval_params["fine"].items():
        assert torch.equal(v, averaged.fine.state_dict()[k])


def test_full_state_is_plain_and_names_its_loop(tmp_path):
    loop = make("occupancy")
    loop.step_auto(0, ray_batch(0))
    path = str(tmp_path / "state.pt")
    loop.save_full(path)
    state = torch.load(path, weights_only=True)
    assert state["format"] == checkpoint.FULL_STATE_FORMAT and state["loop"] == "occupancy"
    assert {"params", "optimizer", "opt_count", "step", "host_step", "ema", "grid", "auto_budget"} <= set(state)
    assert state["grid"]["densities"].device.type == "cpu" and state["optimizer"]["state"]
    with pytest.raises(ValueError, match="occupancy loop's state"):
        make("hierarchy").load_full(path)


def test_jax_full_state_refuses(tmp_path):
    """learn_nerf_tpu's full state is a flax msgpack: refused with a clear
    message (the params pickle is the format both packages read)."""
    params = dict(fine={"w": jnp.ones(2)}, background=jnp.zeros(3))
    state = jtrain.EmaTrainState.create(apply_fn=None, params=params, tx=optax.adam(1e-3))
    path = str(tmp_path / "jax_state.msgpack")
    jcheckpoint.save_train_state(path, state)
    assert jcheckpoint.peek_train_state_step(path) == 0
    for read in (lambda: make("occupancy").load_full(path), lambda: checkpoint.peek_train_state_step(path)):
        with pytest.raises(ValueError, match="msgpack.*params pickle"):
            read()


def test_occupancy_load_full_restores_the_grid_and_resets_the_auto_budget(tmp_path):
    loop = occupancy_loop(update_interval=2, grid_warmup_updates=1, pool_budget_per_ray="auto", pool_start_step=1)
    for s in range(3):
        loop.step_auto(0, ray_batch(s))
    assert loop._auto_per_ray is not None
    path = str(tmp_path / "state.pt")
    loop.save_full(path)
    assert torch.load(path, weights_only=True)["auto_budget"]["per_ray"] == loop._auto_per_ray
    other = occupancy_loop(update_interval=2, grid_warmup_updates=1, pool_budget_per_ray="auto", pool_start_step=1)
    other.load_full(path)
    assert torch.equal(other.grid_state.densities, loop.grid_state.densities)
    assert other.grid_state.step == loop.grid_state.step and other._host_step == 3
    assert other._auto_per_ray is None  # measured again on the loaded grid, as load does
    with pytest.raises(ValueError, match="grid"):
        train.OccupancyTrainLoop(InstantNGPModel(**SMALL, **BBOX), lr=1e-2, grid_resolution=8, **BBOX).load_full(path)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("scene")), num_views=3, resolution=12)


HIERARCHY_FLAGS = ["--batch_size", "64", "--coarse_samples", "8", "--fine_samples", "8", "--lr", "1e-3",
                   "--seed", "0", "--device", "cpu"]
OCCUPANCY_FLAGS = ["--instant_ngp", "--occupancy", "--occ_candidates", "16", "--occ_samples", "4", "--occ_grid",
                   "16", "--batch_size", "64", "--lr", "1e-2", "--seed", "0", "--device", "cpu"]


def step_lines(out):
    return [line.split(": ", 1)[1].split(" rays_per_sec")[0] for line in out.splitlines() if line.startswith("step ")]


class Stop(Exception):
    pass


def stop_after(n):
    def on_step(done, loop):
        if done == n:
            raise Stop

    return on_step


@pytest.mark.parametrize("flags", [HIERARCHY_FLAGS, OCCUPANCY_FLAGS], ids=["hierarchy", "occupancy"])
def test_cli_resumes_from_the_full_state(scene, tmp_path, capsys, flags):
    """5 steps uninterrupted against 3 steps whose full state is saved and
    a run resumed from it: the resumed run skips the 3 batches the first
    consumed and logs the uninterrupted run's last 2 lines."""
    train_nerf.main([*flags, "--steps", "5", "--save_path", str(tmp_path / "whole.pkl"), scene])
    whole = step_lines(capsys.readouterr().out)
    part = [*flags, "--save_path", str(tmp_path / "part.pkl"), "--full_state_path", str(tmp_path / "part.pt")]
    train_nerf.main([*part, "--steps", "3", scene])
    first = step_lines(capsys.readouterr().out)
    loop = train_nerf.main([*part, "--steps", "2", scene])
    out = capsys.readouterr().out
    assert "loading full train state" in out and "skipping the 3 batches" in out
    assert first + step_lines(out) == whole and loop.step_count == 5


def test_cli_cosine_resume_takes_the_uninterrupted_lr(scene, tmp_path, capsys):
    """--lr_schedule cosine --steps 6, stopped after 4 steps with its state
    saved at 3 (--save_interval 2), then resumed from the full state (the
    restored optimizer count carries the decay) and, apart, from the params
    pickle (the pickle's step offsets a fresh count): every resumed step
    takes the lr optax's schedule gives the uninterrupted run at that step,
    which is what the JAX CLI's two rules give."""
    ref = optax.cosine_decay_schedule(init_value=1e-3, decay_steps=6, alpha=0.1)
    lrs = []

    def record(done, loop):
        lrs.append(loop.optimizer.param_groups[0]["lr"])

    flags = [*HIERARCHY_FLAGS, "--lr_schedule", "cosine", "--steps", "6", "--save_interval", "2"]
    full = [*flags, "--save_path", str(tmp_path / "c.pkl"), "--full_state_path", str(tmp_path / "c.pt")]
    with pytest.raises(Stop):
        train_nerf.main([*full, scene], on_step=lambda done, loop: (record(done, loop), stop_after(4)(done, loop)))
    np.testing.assert_allclose(lrs, [float(ref(c)) for c in range(4)], rtol=1e-6)
    assert checkpoint.peek_train_state_step(str(tmp_path / "c.pt")) == 3
    shutil.copy(tmp_path / "c.pkl", tmp_path / "p.pkl")
    for argv in (full, [*flags, "--save_path", str(tmp_path / "p.pkl")]):  # the full state; the pickle alone
        del lrs[:]
        train_nerf.main([*argv, scene], on_step=record)
        assert "3 of 6 total steps remain" in capsys.readouterr().out
        np.testing.assert_allclose(lrs, [float(ref(c)) for c in range(3, 6)], rtol=1e-6)
    assert train_nerf.resume_step_of(str(tmp_path / "c.pkl"), str(tmp_path / "c.pt")) == 6
