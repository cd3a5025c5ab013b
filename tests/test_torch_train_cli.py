"""The port's ``train_nerf`` CLI on the CPU (``--device cpu``), at a small
size on tests/synthetic_scene: a handful of steps write a checkpoint that the
port's ``render_nerf`` and the JAX package's ``load_params_pickle`` both
read; auto-resume continues the step counter; the parser equals the JAX
CLI's; checkpoints are written at the JAX CLI's steps and a trailing partial
dispatch is dropped as it drops it; both Ref-NeRF models train, score and
render, and their checkpoints give the JAX models the port's outputs; every
unported flag combination exits naming ROADMAP.md.  Beside it,
the copies the CLI stands on: the dataset reader, the two-stage shuffle and
the prefetch against the JAX package's on the same scene, batch for batch at
the same seed, and the metric logger's line.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from learn_nerf_tpu.checkpoint import load_params_pickle as jax_load_params_pickle
from learn_nerf_tpu.data import dataset as jdataset
from learn_nerf_tpu.data import shuffle as jshuffle
from learn_nerf_tpu.scripts import train_nerf as jax_train_nerf
from learn_nerf_tpu.utils.logging import MetricLogger as JaxMetricLogger
from learn_nerf_tpu_torch.data import dataset, prefetch, shuffle
from learn_nerf_tpu_torch.data.camera import CameraView
from learn_nerf_tpu_torch.scripts import common, render_nerf, train_nerf
from learn_nerf_tpu_torch.utils.logging import MetricLogger

from .synthetic_scene import write_dataset

torch.set_num_threads(1)

# The CLI's model is full width (16 levels of 2^18 rows); the occupancy
# flags keep the step small.
SMALL_FLAGS = ["--instant_ngp", "--occupancy", "--occ_candidates", "16", "--occ_samples", "4",
               "--occ_grid", "16", "--batch_size", "64", "--lr", "1e-2", "--seed", "0",
               "--device", "cpu"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("scene")), num_views=3, resolution=12)


def test_train_cli_writes_a_checkpoint_both_packages_read(scene, tmp_path, capsys):
    pkl = str(tmp_path / "ngp.pkl")
    train_nerf.main([*SMALL_FLAGS, "--steps", "5", "--save_path", pkl, scene])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("step ")]
    assert [line.split(":")[0] for line in lines] == [f"step {i}" for i in range(5)]
    assert all("fine=" in line and "grad_norm=" in line and "param_norm=" in line for line in lines)
    assert "rays_per_sec=" in lines[-1]

    payload = jax_load_params_pickle(pkl)
    assert set(payload) == {"fine", "background", "occupancy_densities", "occupancy_resolution",
                            "occupancy_host_step"}
    assert int(payload["occupancy_host_step"]) == 5 and int(payload["occupancy_resolution"]) == 16
    assert payload["fine"]["HashGridEncoding_0"]["table_15"].shape == (2**18, 2)
    assert payload["fine"]["Dense_0"]["kernel"].shape == (32, 64)
    # The tables trained: they left the +-1e-4 init.
    assert np.abs(payload["fine"]["HashGridEncoding_0"]["table_0"]).max() > 1e-3

    # The train loop saves no coarse model, as in the JAX package; the
    # occupancy path renders without one.
    argv = ["--seed", "0", "--batch_size", "64", "--width", "8", "--height", "8", "--instant_ngp",
            "--occupancy", "--occ_candidates", "16", "--occ_samples", "4", "--device", "cpu",
            "--model_path", pkl, f"{scene}/metadata.json"]
    session = render_nerf.RenderSession(render_nerf.argparser().parse_args(argv))
    assert session.renderer.grid.resolution == 16 and session.grid_state.step == 16
    image = session.render_view(CameraView.from_json(f"{scene}/0000.json"))
    assert image.shape == (8, 8, 3)


def test_auto_resume_continues_the_step_counter(scene, tmp_path, capsys):
    pkl = str(tmp_path / "resume.pkl")
    flags = [*SMALL_FLAGS, "--save_path", pkl, "--steps_per_dispatch", "2"]
    train_nerf.main([*flags, "--steps", "3", scene])
    assert int(jax_load_params_pickle(pkl)["occupancy_host_step"]) == 3
    first = capsys.readouterr().out
    assert "loading from checkpoint" not in first
    # Two steps per line: the lines carry the last step of each chunk.
    assert [l.split(":")[0] for l in first.splitlines() if l.startswith("step ")] == ["step 1", "step 2"]
    train_nerf.main([*flags, "--steps", "4", "--ema", "0.9", "--density_penalty", "0.01", scene])
    out = capsys.readouterr().out
    assert f"loading from checkpoint: {pkl}" in out and "fine_density=" in out
    assert int(jax_load_params_pickle(pkl)["occupancy_host_step"]) == 7


def test_cosine_resume_trains_only_the_remaining_steps(scene, tmp_path, capsys):
    pkl = str(tmp_path / "cosine.pkl")
    flags = [*SMALL_FLAGS, "--save_path", pkl, "--lr_schedule", "cosine", "--steps", "4"]
    train_nerf.main([*flags, "--save_interval", "2", scene])
    assert int(jax_load_params_pickle(pkl)["occupancy_host_step"]) == 4
    train_nerf.main([*flags, scene])
    assert "nothing to do" in capsys.readouterr().out
    train_nerf.main([*SMALL_FLAGS, "--save_path", pkl, "--lr_schedule", "cosine", "--steps", "6", scene])
    assert "2 of 6 total steps remain" in capsys.readouterr().out
    assert int(jax_load_params_pickle(pkl)["occupancy_host_step"]) == 6
    with pytest.raises(SystemExit, match="needs --steps"):
        train_nerf.main([*SMALL_FLAGS, "--lr_schedule", "cosine", "--save_path", str(tmp_path / "x.pkl"), scene])


def test_test_data_dir_logs_test_losses(scene, tmp_path, capsys):
    pkl = str(tmp_path / "test.pkl")
    train_nerf.main([*SMALL_FLAGS, "--steps", "2", "--save_path", pkl, "--test_data_dir", scene,
                     "--test_batch_size", "32", "--one_view", scene])
    out = capsys.readouterr().out
    assert out.count("test_fine=") == 2


def test_parser_equals_the_jax_cli():
    def options(parser):
        return {a.dest: (a.default, a.nargs, a.const) for a in parser._actions if a.dest != "help"}

    ours, theirs = options(train_nerf.build_parser()), options(jax_train_nerf.build_parser())
    assert ours.pop("device") == ("cuda", None, None)  # the port's own flag
    assert ours == theirs
    args = train_nerf.build_parser().parse_args(["--occ_train_budget", "auto", "d"])
    assert args.occ_train_budget == "auto" and args.data_dir == "d"


def test_create_model_returns_the_ngp_adam_settings(scene):
    parser = train_nerf.build_parser()
    metadata = dataset.ModelMetadata.from_json(f"{scene}/metadata.json")
    _, fine, kwargs = common.create_model(parser.parse_args(["--instant_ngp", scene]), metadata)
    assert kwargs == dict(adam_eps=1e-15, adam_b1=0.9, adam_b2=0.99)
    assert len(fine.encoding.grid_sizes) == 16
    # flax's Dense init: zero biases, lecun-normal kernels.
    assert all(layer.bias.abs().max() == 0 for layer in fine.dense_layers())
    weight = fine.color_layers[1].weight
    assert abs(weight.std().item() - (1 / 64) ** 0.5) < 0.02 and weight.abs().max() <= 2 / 0.8796 / 8 + 1e-6
    assert common.create_model(parser.parse_args([scene]), metadata)[2] == {}


@pytest.mark.parametrize("case", ["profile_dir", "one process", "no coordinator"])
def test_distributed_flags_and_profile_dir(scene, tmp_path, monkeypatch, case):
    """``--profile_dir`` writes a trace of the hot loop; ``--num_processes 1``
    trains in one process (no process group, whatever the environment
    says); ``--num_processes 2`` needs ``--coordinator_address``.  Two
    processes: tests/test_torch_parallel.py."""
    import torch.distributed as dist

    flags = ["--instant_ngp", "--occupancy", "--device", "cpu", "--occ_candidates", "16", "--occ_samples", "4",
             "--occ_grid", "16", "--batch_size", "32", "--lr", "1e-2", "--seed", "0", "--steps", "2",
             "--save_path", str(tmp_path / "run.pkl"), scene]
    if case == "no coordinator":
        with pytest.raises(ValueError, match="--coordinator_address"):
            train_nerf.main(["--num_processes", "2", "--process_id", "0", *flags])
        return
    if case == "one process":
        for var, value in dict(MASTER_ADDR="localhost", WORLD_SIZE="2", RANK="0").items():
            monkeypatch.setenv(var, value)
        loop = train_nerf.main(["--num_processes", "1", *flags])
        assert loop._dp is None and not dist.is_initialized() and loop.step_count == 2
        return
    train_nerf.main(["--profile_dir", str(tmp_path / "trace"), *flags])
    (trace,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / trace) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("addmm" in n for n in names)  # the step's products are in the trace


@pytest.mark.parametrize("flags,match", [
    (["--instant_ngp", "--occupancy", "--ref_nerf", "--occ_span_candidates", "64"], "--occ_span_candidates"),
    (["--instant_ngp", "--occupancy", "--occ_span_pool_factor", "4"], "--occ_span_pool_factor"),
    (["--occupancy", "--occ_block_gather", "2"], "--occ_block_gather"),
    (["--occupancy", "--occ_span_candidates", "64", "--occ_span_block_gather", "4"],
     "--occ_span_candidates, --occ_span_block_gather"),
])
def test_inference_levers_exit_as_inference_only(scene, tmp_path, flags, match):
    """The JAX CLI parses the selection levers and its train loop ignores
    them; the port's exits naming them as the render CLIs' levers, before
    it reads the dataset or writes a checkpoint."""
    save = tmp_path / "never.pkl"
    with pytest.raises(SystemExit) as info:
        train_nerf.main([*flags, "--device", "cpu", "--save_path", str(save), scene])
    message = str(info.value)
    assert message.startswith(match + ":") and "inference levers of render_nerf, serve_nerf, eval_psnr" in message
    assert "render_new_dataset" in message and not save.exists()


REF_NERF_RUNS = {
    "hybrid occupancy": ["--instant_ngp", "--ref_nerf", "--occupancy", "--occ_candidates", "16",
                         "--occ_samples", "4", "--occ_grid", "16", "--lr", "1e-2"],
    "vanilla hierarchy": ["--ref_nerf", "--coarse_samples", "8", "--fine_samples", "8", "--lr", "1e-3"],
}


@pytest.mark.parametrize("run", list(REF_NERF_RUNS))
def test_ref_nerf_trains_scores_renders_and_loads_in_jax(scene, tmp_path, capsys, run):
    """Formerly refused: ``train_nerf --ref_nerf`` (the vanilla trunk, the
    hierarchy) and ``--instant_ngp --ref_nerf --occupancy`` (the hybrid) at
    the JAX widths for a few steps, logging both aux terms; ``eval_psnr``
    and ``render_nerf`` on the checkpoint; and the checkpoint, read by the
    JAX package's ``load_params_pickle``, gives the JAX CLI's model the
    port's outputs: density, rgb and ``neg_normal`` within 1e-5.  The
    trained hybrid's normal at the 2048 lattice is ill-conditioned (the
    density gradient is a small sum of large terms): its ``normal_mse``
    differed from JAX's by up to 7.2e-4, while the port's agreed with its
    own f64 evaluation within 7.3e-7 (JAX's f32 was 7.2e-4 from that too),
    so ``normal_mse`` is held to JAX within 2e-3 and to the f64 port within
    3e-6."""
    import jax
    import jax.numpy as jnp

    from learn_nerf_tpu.scripts.common import create_model as jax_create_model
    from learn_nerf_tpu_torch.checkpoint import checkpoint_from_flax, load_params_pickle
    from learn_nerf_tpu_torch.scripts import eval_psnr

    flags = [*REF_NERF_RUNS[run], "--batch_size", "64", "--seed", "0", "--device", "cpu"]
    pkl = str(tmp_path / "refnerf.pkl")
    train_nerf.main([*flags, "--steps", "3", "--save_path", pkl, scene])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("step ")]
    assert len(lines) == 3 and all("fine_normal_mse=" in line and "fine_neg_normal=" in line for line in lines)
    assert ("coarse_normal_mse=" in lines[0]) == ("--occupancy" not in flags)

    render_flags = [f for f in flags if f not in ("--lr", "1e-2", "1e-3")]
    scores, ssims = eval_psnr.main([*render_flags, "--model_path", pkl, scene])
    assert len(scores) == 3 and np.isfinite(scores).all() and np.isfinite(ssims).all()
    out = str(tmp_path / "view.png")
    render_nerf.main([*render_flags, "--width", "8", "--height", "8", "--model_path", pkl,
                      f"{scene}/metadata.json", f"{scene}/0000.json", out])
    assert os.path.getsize(out) > 0

    args = train_nerf.build_parser().parse_args([*flags, scene])
    metadata = dataset.ModelMetadata.from_json(f"{scene}/metadata.json")
    _, fine, _ = common.create_model(args, metadata)
    fine.load_state_dict(checkpoint_from_flax(load_params_pickle(pkl), **fine.flax_layout())["fine"])
    _, jax_fine, _ = jax_create_model(args, metadata)
    payload = jax_load_params_pickle(pkl)
    rng = np.random.RandomState(1)
    x = rng.uniform(-0.7, 0.7, (64, 3)).astype(np.float32)
    d = rng.randn(64, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jax.jit(jax_fine.apply)(dict(params=payload["fine"]), jnp.asarray(x), jnp.asarray(d))
    got = fine(torch.from_numpy(x), torch.from_numpy(d))
    for a, b in zip((*got[:2], got[2]["neg_normal"]), (*want[:2], want[2]["neg_normal"])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    normal_mse = got[2]["normal_mse"].detach().numpy()
    assert np.abs(normal_mse - np.asarray(want[2]["normal_mse"])).max() <= 2e-3
    exact = fine.double()(torch.from_numpy(x).double(), torch.from_numpy(d).double())[2]["normal_mse"]
    assert np.abs(normal_mse - exact.detach().numpy()).max() <= 3e-6


def _jax_cli_saves(save_interval, k, steps, batches):
    """Steps done at each in-loop save of the JAX CLI (its two rules, from
    learn_nerf_tpu/scripts/train_nerf.py:362 and :333, as arithmetic)."""
    if k == 1:
        return [i + 1 for i in range(min(steps, batches)) if i and i % save_interval == 0]
    saves = []
    for i in range(batches // k):  # a trailing chunk shorter than k is dropped
        if steps - i * k <= 0:
            break
        step = i * k + min(k, steps - i * k) - 1
        if step and (step + 1) % save_interval < k:
            saves.append(step + 1)
    return saves


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("save_interval", [1, 2, 3, 4, 7, 10])
def test_save_cadence_equals_the_jax_cli(save_interval, k):
    for steps in range(1, 25):
        done, saves = 0, []
        for chunk in train_nerf.dispatch_chunks(iter(range(1000)), k, steps):
            done += len(chunk)
            if train_nerf.save_due(done - 1, save_interval, k):
                saves.append(done)
        assert done == steps
        assert saves == _jax_cli_saves(save_interval, k, steps, 1000), (save_interval, k, steps)


@pytest.mark.parametrize("k,batches,steps,want", [
    (3, 7, None, [[0, 1, 2], [3, 4, 5]]),  # the trailing chunk of one batch is dropped
    (3, 6, None, [[0, 1, 2], [3, 4, 5]]),
    (3, 100, 7, [[0, 1, 2], [3, 4, 5], [6]]),  # --steps cuts the last chunk to the remainder
    (3, 7, 8, [[0, 1, 2], [3, 4, 5]]),  # ... but an iterator that runs out still drops it
    (1, 4, None, [[0], [1], [2], [3]]),
    (1, 4, 2, [[0], [1]]),
    (2, 1, None, []),
])
def test_dispatch_chunks_drop_a_trailing_partial_chunk(k, batches, steps, want):
    assert list(train_nerf.dispatch_chunks(iter(range(batches)), k, steps)) == want


def test_cli_saves_at_the_jax_steps_and_drops_a_partial_dispatch(scene, tmp_path, monkeypatch):
    import itertools

    from learn_nerf_tpu_torch.train import OccupancyTrainLoop

    saved = []
    save = OccupancyTrainLoop.save
    monkeypatch.setattr(OccupancyTrainLoop, "save",
                        lambda self, path: (saved.append(self._host_step), save(self, path))[1])
    flags = [*SMALL_FLAGS, "--save_interval", "2"]
    # One step per dispatch: after step indices 2 and 4 (3 and 5 steps done), then the final save.
    train_nerf.main([*flags, "--steps", "5", "--save_path", str(tmp_path / "a.pkl"), scene])
    assert saved == [3, 5, 5]
    # Five batches, two per dispatch, no --steps: the fifth batch is dropped.
    saved.clear()
    finite = train_nerf.prefetch_to_device
    monkeypatch.setattr(train_nerf, "prefetch_to_device",
                        lambda batches, device: finite(itertools.islice(batches, 5), device))
    loop = train_nerf.main([*flags, "--steps_per_dispatch", "2", "--save_path", str(tmp_path / "b.pkl"), scene])
    assert loop._host_step == 4 and saved == [2, 4, 4]


def test_steps_per_dispatch_refuses_test_data(scene):
    with pytest.raises(SystemExit, match="incompatible"):
        train_nerf.main([*SMALL_FLAGS, "--steps_per_dispatch", "2", "--test_data_dir", scene, scene])


def test_dataset_reader_equals_the_jax_reader(scene):
    ours, theirs = dataset.load_dataset(scene), jdataset.load_dataset(scene)
    assert ours.metadata.bbox_min == theirs.metadata.bbox_min
    assert [v.image_path for v in ours.views] == [v.image_path for v in theirs.views]
    for a, b in zip(ours.views, theirs.views):
        np.testing.assert_array_equal(a.image(), b.image())
        np.testing.assert_array_equal(a.rays(), b.rays())
        assert a.to_json() == b.to_json()


def test_dataset_reader_skips_and_refuses_as_the_jax_reader(tmp_path, scene, capsys):
    import shutil

    broken = tmp_path / "broken"
    shutil.copytree(scene, broken)
    shutil.copy(broken / "0000.png", broken / "preview.png")
    shutil.copy(broken / "0000.png", broken / "0000_depth.png")
    assert len(dataset.load_dataset(str(broken)).views) == 3
    assert "skipping 1 camera-less png(s)" in capsys.readouterr().out
    for name in ("0000.json", "0001.json", "0002.json"):
        os.remove(broken / name)
    with pytest.raises(FileNotFoundError, match="no usable views"):
        dataset.load_dataset(str(broken))


@pytest.mark.parametrize("process", [(0, 1), (1, 2)])
def test_shuffle_equals_the_jax_shuffle_batch_for_batch(scene, tmp_path, process):
    pid, count = process
    data = dataset.load_dataset(scene)
    jdata = jdataset.load_dataset(scene)
    with shuffle.ShuffledDataset(str(tmp_path / "a"), data, seed=7, num_shards=4,
                                 process_id=pid, process_count=count) as ours, \
            jshuffle.ShuffledDataset(str(tmp_path / "b"), jdata, seed=7, num_shards=4,
                                     process_id=pid, process_count=count) as theirs:
        a = list(ours.iterate_batches(50))
        b = list(theirs.iterate_batches(50))
    assert len(a) == len(b) and sum(len(x) for x in a) == (3 * 144 + (count - 1 - pid)) // count
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    # The same signature: a cache written by one package is the other's.
    assert shuffle._cache_signature(data.views, 4, count) == jshuffle._cache_signature(jdata.views, 4, count)


def test_iterate_batches_equals_the_jax_reader_and_reuses_its_cache(scene, tmp_path):
    cache = str(tmp_path / "shuffled")
    ours = dataset.load_dataset(scene).iterate_batches(cache, 3, 64)
    first = [next(ours) for _ in range(9)]  # past one epoch of 432 rays
    ours.close()
    theirs = jdataset.load_dataset(scene).iterate_batches(cache, 3, 64)
    for x in first:
        np.testing.assert_array_equal(x, next(theirs))
    theirs.close()
    assert first[0].shape == (64, 3, 3) and first[0].dtype == np.float32


def test_prefetch_yields_every_batch_in_order_on_the_device():
    batches = [np.full((4, 3, 3), i, np.float32) for i in range(5)]
    out = list(prefetch.prefetch_to_device(iter(batches), "cpu", depth=2))
    assert [int(b[0, 0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b, torch.Tensor) and b.dtype == torch.float32 for b in out)
    with pytest.raises(ValueError, match="depth"):
        list(prefetch.prefetch_to_device(iter(batches), "cpu", depth=0))


def test_metric_logger_prints_the_jax_line_one_step_late():
    ours, theirs = io.StringIO(), io.StringIO()
    a, b = MetricLogger(out=ours), JaxMetricLogger(out=theirs)
    values = [dict(fine=0.123456789, grad_norm=12.5), dict(fine=1e-5, grad_norm=3.0)]
    a.log_step(0, {k: torch.tensor(v) for k, v in values[0].items()})
    b.log_step(0, values[0])
    assert ours.getvalue() == ""  # the line waits for the next step
    a.log_step(1, {k: torch.tensor(v) for k, v in values[1].items()})
    b.log_step(1, values[1])
    assert ours.getvalue() == theirs.getvalue() == "step 0: fine=0.12346 grad_norm=12.5\n"
    a.flush()
    b.flush()
    assert ours.getvalue() == theirs.getvalue()
    rated = io.StringIO()
    logger = MetricLogger(rays_per_step=100, out=rated)
    for step in range(3):
        logger.log_step(step, dict(fine=torch.tensor(1.0)))
    logger.flush()
    assert "rays_per_sec=" in rated.getvalue().splitlines()[-1]
