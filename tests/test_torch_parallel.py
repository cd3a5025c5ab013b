"""The port's data parallelism against learn_nerf_tpu's, on the CPU.

* **Data-parallel steps.** Two gloo worker processes run only the port
  (``tests/torch_parallel_worker.py``), joined by the JAX CLI's flags; each
  trains on its rows of the global batches the test writes into an
  ``.npz``.  The test holds them against the JAX loops on a 2-device
  ``default_mesh(jax.devices()[:2])`` fed the concatenated batch and the
  same uniforms (JAX's draws on the global batch, each rank given its
  rows): the occupancy loop's dense steps and its pooled steps at a budget
  that drops nothing, the vanilla and the NGP hierarchy's steps, losses
  within 1e-5 relative, parameters bit-equal across the ranks.  At a
  budget that drops, the logged loss is the mean of the ranks' own losses
  and ``fine_pool_dropped`` the sum of their drops (each rank pools its own
  rows).  The auto pool budget picks one bucket on ranks whose rows differ
  in demand, and two ranks through ``step_auto`` equal one process on the
  concatenated batch.
* **Frames over two CPU devices.**  The hierarchy frame, fixed-K and pooled
  occupancy frames over ``Mesh((cpu, cpu))`` against the JAX package's
  ``render_frame_sharded`` / ``render_frame_occupancy(mesh=...)`` on a
  2-device mesh within 1e-5, and against the port's one-device frame.
* ``init_distributed``: its no-op, flag and environment cases.
* ``train_nerf`` in two processes (``--num_processes 2`` on the CPU): one
  checkpoint, equal log lines, a profiler trace from each rank.
"""

import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu import render as jrender
from learn_nerf_tpu import train as jtrain
from learn_nerf_tpu.models import InstantNGPModel as FlaxNGP
from learn_nerf_tpu.models import NeRFModel as FlaxNeRFModel
from learn_nerf_tpu.parallel.mesh import default_mesh as jax_default_mesh
from learn_nerf_tpu_torch import checkpoint, occ_render, render, train
from learn_nerf_tpu_torch.acceleration import OccupancyGridState, auto_budget_from_demand
from learn_nerf_tpu_torch.checkpoint import load_params_pickle
from learn_nerf_tpu_torch.models import InstantNGPModel
from learn_nerf_tpu_torch.parallel import mesh as pmesh

from .synthetic_scene import write_dataset
from .test_torch_render import _frame_uniforms, occupancy_setup  # noqa: F401  (a fixture)
from .test_torch_train import LOOP, SMALL, grid_densities, loss_draws, ray_batch, update_draws
from .test_torch_train_hierarchy import (BBOX, COARSE_TS, FINE_TS, NGP_ADAM, NGP_COARSE, NGP_FINE, PENALTY_BATCH,
                                         VANILLA, VANILLA_WIDTHS, flax_models, jax_draws, state_of)
from .torch_helpers import port_model, t

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, RAYS = 2, 32  # ranks, rays a rank
GLOBAL = WORLD * RAYS
REL = 1e-5
# The occupancy run: dense steps 0-1, pooled 2-3 at K samples a ray (the
# pool holds every survivor), step 4 at one a ray (it drops).
OCC_BUDGETS = [None, None, 4.0, 4.0, 1.0]
OCC_LOOP = dict(LOOP, update_interval=3, update_cells=1000, grid_warmup_updates=1, density_penalty=0.1,
                density_penalty_batch_size=32, pool_start_step=2)
HIERARCHY_LOOP = dict(lr=1e-3, coarse_ts=COARSE_TS, fine_ts=FINE_TS, density_penalty=0.05,
                      density_penalty_batch_size=PENALTY_BATCH, **BBOX)
AUTO_LOOP = dict(LOOP, lr=1e-2, pool_budget_per_ray="auto", pool_start_step=0, grid_freeze_after=0)
AUTO_SEED = 5
LOSSES = ("fine", "coarse", "fine_density", "coarse_density")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for var in pmesh.LAUNCHER_ENV + ("LOCAL_RANK", "MASTER_PORT"):
        env.pop(var, None)
    return env


def jax_mesh():
    return jax_default_mesh(jax.devices()[:WORLD])


def auto_batches():
    """Two global batches whose rank-0 rows demand less than rank 1's: half
    of rank 0's rays point away from the bbox."""
    out = []
    for step in range(2):
        rank0, rank1 = ray_batch(40 + step, RAYS), ray_batch(50 + step, RAYS)
        away = rank0[: RAYS // 2, 0]
        rank0[: RAYS // 2, 1] = away / np.linalg.norm(away, axis=-1, keepdims=True)
        out.append(np.concatenate([rank0, rank1]))
    return np.stack(out)


def worker_config():
    """The worker's widths and loop options (JSON: bbox tuples as lists)."""
    bbox = {k: list(v) for k, v in BBOX.items()}
    return dict(
        world=WORLD, bbox=bbox, occ_ngp=SMALL, occ_budgets=OCC_BUDGETS, occ_loop=dict(OCC_LOOP, lr=1e-2, **bbox),
        hierarchy=["vanilla", "ngp"], hierarchy_loop=dict(HIERARCHY_LOOP, **bbox),
        vanilla=[dict(**VANILLA, **VANILLA_WIDTHS)] * 2, vanilla_adam={},
        ngp=[dict(**NGP_COARSE, **bbox), dict(**NGP_FINE, **bbox)], ngp_adam=NGP_ADAM,
        auto_loop=dict(AUTO_LOOP, **bbox), auto_seed=AUTO_SEED,
    )


def stack_into(inputs, prefix, rows):
    """``rows``: one dict a step -> ``inputs[prefix.name]`` stacked over steps."""
    for name in rows[0]:
        inputs[f"{prefix}.{name}"] = np.stack([np.asarray(r[name]) for r in rows])


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Write the inputs, start both ranks, run the JAX loops meanwhile, and
    return (the ranks' outputs, the JAX runs' logged values, the inputs)."""
    tmp = tmp_path_factory.mktemp("dp")
    mesh = jax_mesh()
    inputs = dict(config=np.array(json.dumps(worker_config())))
    # The occupancy loop on the mesh; the port starts from its parameters.
    jocc_loop = jtrain.OccupancyTrainLoop(FlaxNGP(**SMALL, **BBOX), init_rng=jax.random.PRNGKey(0), lr=1e-2,
                                          mesh=mesh, **OCC_LOOP)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jocc_loop.state.params))
    for name, v in checkpoint.train_state_from_flax(params)["fine"].items():
        inputs[f"occ.fine.{name}"] = v.numpy()
    keys = [jax.random.PRNGKey(20 + i) for i in range(len(OCC_BUDGETS))]
    rows = []
    for i, key in enumerate(keys):
        step_key, grid_key = jax.random.split(key)
        u, (du, dn) = loss_draws(step_key, n=GLOBAL)
        ids, jitter = update_draws(grid_key, OCC_LOOP["update_cells"], 1)
        rows.append(dict(batch=ray_batch(60 + i, GLOBAL), u=u, density_u=du, density_n=dn, grid_ids=ids,
                         grid_jitter=jitter))
    stack_into(inputs, "occ", rows)
    # The hierarchy's loops, vanilla and NGP.
    hierarchy = {}
    for kind in ("vanilla", "ngp"):
        coarse, fine = flax_models(kind)
        jloop = jtrain.TrainLoop(coarse, fine, init_rng=jax.random.PRNGKey(1), mesh=mesh, **HIERARCHY_LOOP,
                                 **(NGP_ADAM if kind == "ngp" else {}))
        params = jax.tree_util.tree_map(np.asarray, jax.device_get(jloop.state.params))
        for name in ("coarse", "fine"):
            for k, v in state_of(kind, params[name]).items():
                inputs[f"{kind}.{name}.{k}"] = v.numpy()
        hkeys = [jax.random.PRNGKey(30 + i) for i in range(2)]
        rows = []
        for i, key in enumerate(hkeys):
            draws = jax_draws(key, n=GLOBAL)
            rows.append(dict(batch=ray_batch(70 + i, GLOBAL), u_coarse=draws["u_coarse"], u_fine=draws["u_fine"],
                             density_u=draws["density_draws"][0], density_n=draws["density_draws"][1]))
        stack_into(inputs, kind, rows)
        hierarchy[kind] = (jloop, hkeys)
    inputs["auto.batch"] = auto_batches()
    inputs["auto.grid"] = grid_densities(2, occupied=0.3)
    np.savez(tmp / "inputs.npz", **inputs)

    port = free_port()
    worker = os.path.join(REPO, "tests", "torch_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(port), str(tmp / "inputs.npz"),
                               str(tmp / f"out{r}.npz")], env=worker_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        ref = {"occ": []}
        for key, batch, per_ray in zip(keys, inputs["occ.batch"], OCC_BUDGETS[:-1]):  # JAX drops globally
            jocc_loop.pool_budget_per_ray = per_ray
            ref["occ"].append(jocc_loop.step(key, batch))
        for kind, (jloop, hkeys) in hierarchy.items():
            ref[kind] = [jloop.step(key, batch) for key, batch in zip(hkeys, inputs[f"{kind}.batch"])]
        ref = {run: [{k: float(v) for k, v in values.items()} for values in steps] for run, steps in ref.items()}
    finally:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)], ref, inputs


@pytest.mark.parametrize("run", ["occ", "vanilla", "ngp"])
def test_data_parallel_steps_match_the_jax_mesh(dp, run):
    outs, ref, _ = dp
    for step, want in enumerate(ref[run]):
        for name in LOSSES:
            if name in want:
                got = [out[f"{run}.values.{name}"][step] for out in outs]
                assert got[0] == got[1], f"{run} step {step} {name}: the ranks logged {got}"
                np.testing.assert_allclose(got[0], want[name], rtol=REL, err_msg=f"{run} step {step} {name}")
        if "fine_pool_dropped" in want:
            assert want["fine_pool_dropped"] == outs[0][f"{run}.values.fine_pool_dropped"][step] == 0


@pytest.mark.parametrize("run", ["occ", "vanilla", "ngp", "auto"])
def test_parameters_stay_bit_equal_across_ranks(dp, run):
    outs, _, _ = dp
    names = [k for k in outs[0] if k.startswith(f"{run}.param.")]
    assert names
    for name in names:
        np.testing.assert_array_equal(outs[0][name], outs[1][name], err_msg=name)
    if run == "occ":
        np.testing.assert_array_equal(outs[0]["occ.grid"], outs[1]["occ.grid"])


def test_a_dropping_pool_logs_the_mean_loss_and_the_summed_drops(dp):
    """At one sample a ray each rank pools its own rows and drops its own
    trailing rays (the JAX package drops the global batch's)."""
    outs, _, _ = dp
    local_fine = [float(out["occ.local_fine"]) for out in outs]
    local_dropped = [int(out["occ.local_dropped"]) for out in outs]
    assert min(local_dropped) > 0
    logged = [out["occ.values.fine_pool_dropped"][-1] for out in outs]
    assert logged[0] == logged[1] == sum(local_dropped)
    np.testing.assert_allclose(outs[0]["occ.values.fine"][-1], np.mean(local_fine), rtol=REL)


def test_auto_budget_is_one_bucket_and_equals_one_process(dp):
    """Two ranks through ``step_auto`` with the auto budget: one bucket,
    which the ranks' rows alone would not agree on, and the steps of one
    process on the concatenated batch."""
    outs, _, inputs = dp
    assert outs[0]["auto.bucket"] == outs[1]["auto.bucket"]
    model = InstantNGPModel(**SMALL, **BBOX)
    model.load_state_dict({k[len("occ.fine."):]: torch.from_numpy(v) for k, v in inputs.items()
                           if k.startswith("occ.fine.")})
    loop = train.OccupancyTrainLoop(model, **AUTO_LOOP)
    loop.grid_state = OccupancyGridState(densities=t(inputs["auto.grid"]), step=loop.grid.warmup_updates)
    alone = [auto_budget_from_demand(float(loop.renderer.mean_sample_demand(
        t(half)[:, :2], loop.grid_state, generator=torch.Generator().manual_seed(0))), loop.renderer.samples)
        for half in np.split(inputs["auto.batch"][0], WORLD)]
    assert alone[0] != alone[1], f"the ranks' rows alone pick the same bucket {alone}"
    values = [loop.step_auto(AUTO_SEED, batch) for batch in inputs["auto.batch"]]
    assert loop._auto_per_ray == outs[0]["auto.bucket"]
    for step, want in enumerate(values):
        assert float(want["fine_pool_dropped"]) == outs[0]["auto.values.fine_pool_dropped"][step] == 0
        for name in ("fine", "fine_density"):
            if name in want:
                np.testing.assert_allclose(outs[0][f"auto.values.{name}"][step], float(want[name]), rtol=REL)


# -- frames over two CPU devices ---------------------------------------------

CPU2 = pmesh.Mesh(devices=(torch.device("cpu"), torch.device("cpu")))


def test_hierarchy_frame_over_two_devices_matches_jax_sharded_frame():
    """The golden vanilla weights and rays towards the scene (the frame of
    tests/test_torch_span_block.py), 70 rays in tiles of 16: 6 tiles over
    the mesh, padded."""
    params = load_params_pickle(os.path.join(REPO, "tests", "golden", "vanilla_params.pkl"))
    hierarchy = dict(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3, coarse_ts=6, fine_ts=5)
    jr = jrender.Renderer(coarse=FlaxNeRFModel(hidden_dim=32, color_layer_dim=16),
                          fine=FlaxNeRFModel(hidden_dim=48, color_layer_dim=16), **hierarchy)
    renderer = render.Renderer(coarse=port_model(params["coarse"]), fine=port_model(params["fine"]), **hierarchy)
    rng = np.random.RandomState(0)
    origins = rng.randn(70, 3).astype(np.float32) * 2
    dirs = -origins + rng.randn(70, 3).astype(np.float32) * 0.3
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = np.stack([origins, dirs], axis=1)
    bg = np.array([0.2, -0.3, 0.5], np.float32)
    key = jax.random.PRNGKey(9)
    ref = jrender.render_frame_sharded(jr, key, jnp.asarray(rays), params["coarse"], params["fine"],
                                       jnp.asarray(bg), mesh=jax_mesh(), tile_size=16)
    uniforms = []
    for k in jax.random.split(key, 6):
        coarse_key, fine_key = jax.random.split(k)
        uniforms.append((t(jax.random.uniform(coarse_key, (16, 6))), t(jax.random.uniform(fine_key, (16, 5)))))
    with torch.no_grad():
        out = render.render_frame(renderer, t(rays), t(bg), tile_size=16, mesh=CPU2, uniforms=uniforms)
        one_tiles = render.render_frame(renderer, t(rays), t(bg), tile_size=16, uniforms=uniforms[:5])
        sharded = render.render_frame_sharded(renderer, t(rays), t(bg), CPU2, tile_size=16,
                                              generator=torch.Generator().manual_seed(3))
        one = render.render_frame(renderer, t(rays), t(bg), tile_size=16, generator=torch.Generator().manual_seed(3))
    # The bound of the one-device frame's parity (test_torch_span_block):
    # the fine samples follow the coarse weights, which carry the two
    # packages' rounding (1.5e-5 on one of these 210 values, with or
    # without the mesh); the mesh itself moves nothing.
    np.testing.assert_allclose(out["outputs"].numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out["outputs"], one_tiles["outputs"], rtol=0, atol=0)
    # The tiles draw in order either way: the mesh's extra pad tile draws last.
    torch.testing.assert_close(sharded, one["outputs"], rtol=0, atol=0)


@pytest.mark.parametrize("budget", [None, 8.0])
def test_occupancy_frame_over_two_devices_matches_jax_mesh_frame(occupancy_setup, budget):  # noqa: F811
    s = occupancy_setup
    renderer = s["renderers"]["float32"]
    rays = s["rays"][:64]  # 4 tiles of 16, two a device: the one-device frame tiles alike
    key = jax.random.PRNGKey(13)
    ref = jocc.render_frame_occupancy(s["j_renderer"], key, jnp.asarray(rays), s["params"], jnp.asarray(s["bg"]),
                                      s["j_state"], tile_size=16, budget_per_ray=budget, mesh=jax_mesh())
    with torch.no_grad():
        out = occ_render.render_frame_occupancy(renderer, t(rays), t(s["bg"]), s["state"], tile_size=16,
                                                budget_per_ray=budget, mesh=CPU2,
                                                uniforms=_frame_uniforms(key, 4, 16, 24))
        frames = [occ_render.OccupancyFrameSession(renderer, t(s["bg"]), s["state"], tile_size=16, budget_cfg=budget,
                                                   mesh=mesh).render(t(rays), torch.Generator().manual_seed(4))
                  for mesh in (CPU2, None)]
    np.testing.assert_allclose(out["outputs"].numpy(), np.asarray(ref["outputs"]), rtol=1e-5, atol=1e-5)
    if budget is not None:
        assert int(out["selected"]) == int(ref["selected"]) and int(out["dropped"]) == int(ref["dropped"]) == 0
    assert set(frames[0]) == set(frames[1])
    for k in frames[0]:
        torch.testing.assert_close(frames[0][k], frames[1][k], rtol=0, atol=0)


def test_pad_rays_to_tiles_pads_to_the_mesh_like_jax():
    rays = np.random.RandomState(2).randn(70, 2, 3).astype(np.float32)
    padded, tiles = render.pad_rays_to_tiles(t(rays), 16, BBOX["bbox_max"], n_dev=2)
    j_padded, j_tiles = jrender.pad_rays_to_tiles(jnp.asarray(rays), 16, jax_mesh(), BBOX["bbox_max"])
    assert tiles == j_tiles == 6
    np.testing.assert_array_equal(padded.numpy(), np.asarray(j_padded))
    assert render.tile_devices(6, CPU2) == [0, 0, 0, 1, 1, 1] and render.tile_devices(3, None) == [0, 0, 0]


def test_replicate_shares_what_already_lies_on_a_device():
    model = InstantNGPModel(**SMALL, **BBOX)
    state = OccupancyGridState(densities=torch.zeros(8), step=3)
    (m0, s0), (m1, s1) = pmesh.replicate((model, state), CPU2.devices)
    assert m0 is m1 is model and s0.step == s1.step == 3 and s0.densities.data_ptr() == state.densities.data_ptr()


# -- init_distributed ------------------------------------------------------------


def test_init_distributed_is_a_no_op_for_one_process(monkeypatch):
    for var in pmesh.LAUNCHER_ENV:
        monkeypatch.delenv(var, raising=False)
    assert not pmesh.init_distributed(device_type="cpu")
    assert not pmesh.init_distributed(num_processes=1, device_type="cpu")
    assert not dist.is_initialized()
    mesh = pmesh.default_mesh([torch.device("cpu")])
    assert mesh.group is None and (mesh.process_index, mesh.process_count) == (0, 1)
    with pytest.raises(ValueError, match="--coordinator_address"):
        pmesh.init_distributed(num_processes=2, device_type="cpu")


def test_init_distributed_reads_a_launchers_environment(monkeypatch):
    """torchrun's coordinates initialize a group with no flags; an explicit
    ``--num_processes 1`` keeps the run in one process (the JAX rule)."""
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE="1", RANK="0")
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert not pmesh.init_distributed(num_processes=1, device_type="cpu")
    assert not dist.is_initialized()
    try:
        assert pmesh.init_distributed(device_type="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = pmesh.default_mesh()
        assert mesh.group is not None and mesh.devices == (torch.device("cpu"),)
        grads = [torch.ones(3), torch.full((2, 2), 4.0)]
        pmesh.all_reduce_mean_(grads, mesh)
        assert grads[1].tolist() == [[4.0, 4.0], [4.0, 4.0]]
        values = pmesh.reduce_values(dict(fine=torch.tensor(0.5), fine_pool_dropped=torch.tensor(3)), mesh,
                                     summed=("fine_pool_dropped",))
        assert list(values) == ["fine", "fine_pool_dropped"] and values["fine_pool_dropped"].dtype == torch.int64
    finally:
        dist.destroy_process_group()


def test_init_distributed_joins_two_processes_by_the_jax_flags():
    """``--coordinator_address/--num_processes/--process_id`` initialize
    exactly as asked: rank, world size, gloo on the CPU."""
    port = free_port()
    code = ("import sys, torch.distributed as dist\n"
            "from learn_nerf_tpu_torch.parallel.mesh import init_distributed, default_mesh\n"
            f"assert init_distributed('localhost:{port}', 2, int(sys.argv[1]), device_type='cpu')\n"
            "m = default_mesh()\n"
            "print(dist.get_backend(), m.process_index, m.process_count, len(m.devices))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=worker_env(), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip().splitlines()[-1] for o in outs] == ["gloo 0 2 1", "gloo 1 2 1"]


# -- train_nerf in two processes ------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("scene")), num_views=3, resolution=12)


def test_train_nerf_in_two_processes_writes_one_checkpoint_and_logs_equal_lines(scene, tmp_path):
    port = free_port()
    flags = ["--instant_ngp", "--occupancy", "--device", "cpu", "--occ_candidates", "16", "--occ_samples", "4",
             "--occ_grid", "16", "--batch_size", "32", "--lr", "1e-2", "--seed", "0", "--steps", "4",
             "--occ_train_budget", "auto", "--occ_train_budget_start", "2", "--steps_per_dispatch", "2",
             "--save_path", str(tmp_path / "dp.pkl"), "--profile_dir", str(tmp_path / "trace"),
             "--coordinator_address", f"localhost:{port}", "--num_processes", "2"]
    procs = [subprocess.Popen([sys.executable, "-m", "learn_nerf_tpu_torch.scripts.train_nerf", *flags,
                               "--process_id", str(r), scene], env=worker_env(), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[-3000:] for o in outs]
    for r, out in enumerate(outs):
        assert f"process group: gloo, rank {r} of 2, on cpu" in out
    lines = [[re.sub(r" rays_per_sec=\S+", "", line) for line in out.splitlines() if line.startswith("step ")]
             for out in outs]
    assert len(lines[0]) == 2 and lines[0] == lines[1]
    assert "fine_pool_dropped=0" in lines[0][-1]
    payload = checkpoint.load_params_pickle(str(tmp_path / "dp.pkl"))
    assert int(payload["occupancy_host_step"]) == 4
    assert sorted(os.listdir(tmp_path)) == ["dp.pkl", "trace"]  # one checkpoint, no stray temporaries
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 2 and all(name.endswith(".pt.trace.json") for name in traces)
    with open(tmp_path / "trace" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("addmm" in e.get("name", "") for e in events)
