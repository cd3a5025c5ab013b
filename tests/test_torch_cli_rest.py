"""The port's last CLIs and utilities against learn_nerf_tpu's, on the CPU.

* ``cv_nerf``: the parser (the JAX one's flags plus ``--device``),
  ``chunk_indices`` equal to JAX's, two folds of a few steps end to end;
* ``check_bbox``: its output equal to the JAX script's on a synthetic scene
  whose bbox misses some of the content;
* ``plot_log``: the parser, ``read_log`` equal to JAX's, ``--output``
  writes a PNG;
* ``utils.flops``: ``traced_flops`` of one dense NGP occupancy step and one
  step of each hierarchy (vanilla, NGP) equal to ``jaxpr_matmul_flops`` of
  the JAX step at the same widths; the fused kernels' analytic FLOPs;
  ``roofline`` keys and peaks;
* ``utils.profiling``: ``profile_trace`` writes a trace of what it wraps.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu import train as jtrain
from learn_nerf_tpu.models import InstantNGPModel as FlaxNGP
from learn_nerf_tpu.scripts import check_bbox as jax_check_bbox
from learn_nerf_tpu.scripts import cv_nerf as jax_cv_nerf
from learn_nerf_tpu.scripts import plot_log as jax_plot_log
from learn_nerf_tpu.utils import flops as jflops
from learn_nerf_tpu_torch import checkpoint, train
from learn_nerf_tpu_torch.kernels import fused_mlp as fm
from learn_nerf_tpu_torch.models import InstantNGPModel, NeRFModel
from learn_nerf_tpu_torch.scripts import check_bbox, cv_nerf, plot_log
from learn_nerf_tpu_torch.utils import flops
from learn_nerf_tpu_torch.utils.profiling import profile_trace

from . import test_torch_train_hierarchy as hierarchy
from .synthetic_scene import write_dataset
from .test_torch_train import BBOX, LOOP, NGP_ADAM, SMALL, loss_draws, ray_batch

torch.set_num_threads(1)


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def jax_parser(main, monkeypatch):
    """The parser a JAX script builds inside its ``main``."""
    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as info:
        main([])
    monkeypatch.undo()
    return info.value.parser


def options(parser):
    return {a.dest: (a.default, a.nargs, a.const, a.type) for a in parser._actions if a.dest != "help"}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("scene")), num_views=4, resolution=10)


# -- cv_nerf -----------------------------------------------------------------


def test_cv_nerf_parser_equals_the_jax_cli(monkeypatch):
    ours, theirs = options(cv_nerf.argparser()), options(jax_parser(jax_cv_nerf.main, monkeypatch))
    assert ours.pop("device") == ("cuda", None, None, None)  # the port's own flag
    assert ours == theirs


@pytest.mark.parametrize("chunks,n", [(10, 3), (3, 10), (2, 7), (4, 4), (1, 5)])
def test_cv_nerf_chunk_indices_equal_jax(chunks, n):
    indices = list(np.random.RandomState(n).permutation(n))
    assert list(cv_nerf.chunk_indices(chunks, indices)) == list(jax_cv_nerf.chunk_indices(chunks, indices))


def test_cv_nerf_two_folds_end_to_end(scene, capsys):
    results = cv_nerf.main(["--device", "cpu", "--folds", "2", "--train_iters", "3", "--batch_size", "64",
                            "--coarse_samples", "4", "--fine_samples", "4", "--lr", "1e-3", scene])
    out = capsys.readouterr().out
    assert out.count("performing cross validation for fold") == 2
    names = sorted(os.path.basename(name) for _, name in results)
    assert names == ["0000.png", "0001.png", "0002.png", "0003.png"]  # every view held out once
    assert all(np.isfinite(loss) and loss > 0 for loss, _ in results)
    for loss, name in results:
        assert f"{loss} {name}" in out


# -- check_bbox ----------------------------------------------------------------


def test_check_bbox_output_equals_the_jax_script(tmp_path, capsys):
    """A bbox smaller than the scene's cube: the rays that miss it see the
    cube's colours, and both scripts report the same."""
    scene = write_dataset(str(tmp_path / "s"), num_views=2, resolution=12)
    with open(os.path.join(scene, "metadata.json")) as f:
        metadata = json.load(f)
    metadata["min"], metadata["max"] = [-0.3] * 3, [0.3] * 3
    with open(os.path.join(scene, "metadata.json"), "w") as f:
        json.dump(metadata, f)
    jax_check_bbox.main([scene])
    want = capsys.readouterr().out
    check_bbox.main(["--device", "cpu", scene])
    got = capsys.readouterr().out
    lines = [line for line in got.splitlines() if line.endswith("]")]
    assert [line.split(" [")[0] for line in lines] == ["min color", "max color", "mean color"]
    for ours, theirs in zip(lines, [line for line in want.splitlines() if line.endswith("]")]):
        name, values = ours.split(" [")
        np.testing.assert_allclose(json.loads("[" + values), json.loads("[" + theirs.split(" [")[1]), atol=1e-6)


def test_check_bbox_parser(monkeypatch):
    ours, theirs = options(check_bbox.argparser()), options(jax_parser(jax_check_bbox.main, monkeypatch))
    assert ours.pop("device") == ("cuda", None, None, None)
    assert ours == theirs


# -- plot_log ------------------------------------------------------------------


LOG = """loading dataset...
step 0: fine=0.5 grad_norm=1.25 param_norm=3.0
step 1: fine=0.25 grad_norm=1.0 param_norm=3.5 rays_per_sec=100.0
note: constant lr
step 2: fine=0.125 grad_norm=0.75 param_norm=4.0 rays_per_sec=110.5
"""


def test_plot_log_reads_like_jax_and_writes_a_png(tmp_path, monkeypatch):
    path = tmp_path / "run_a.txt"
    path.write_text(LOG)
    ours, theirs = plot_log.read_log(str(path)), jax_plot_log.read_log(str(path))
    assert ours.keys() == theirs.keys() == {"fine", "grad_norm", "param_norm", "rays_per_sec"}
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert plot_log.label_for_path(str(path)) == jax_plot_log.label_for_path(str(path)) == "run a"
    assert options(plot_log.argparser()) == options(jax_parser(jax_plot_log.main, monkeypatch))
    out = tmp_path / "plot.png"
    plot_log.main(["--output", str(out), "--smoothing", "2", "--log_scale", str(path)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# -- utils.flops -------------------------------------------------------------


def jax_occupancy_loop():
    return jtrain.OccupancyTrainLoop(FlaxNGP(**SMALL, **BBOX), init_rng=jax.random.PRNGKey(0), lr=1e-2, **LOOP,
                                     **NGP_ADAM, density_penalty=0.1, density_penalty_batch_size=32)


def test_traced_flops_of_a_dense_ngp_step_equal_the_jaxpr_count():
    jloop = jax_occupancy_loop()
    batch, key = ray_batch(3), jax.random.PRNGKey(4)
    want = jflops.traced_flops(jloop._step_fn, jloop.state, key, jnp.asarray(batch), jloop.grid_state)
    model = InstantNGPModel(**SMALL, **BBOX)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jloop.state.params))
    model.load_state_dict(checkpoint.train_state_from_flax(params)["fine"])
    loop = train.OccupancyTrainLoop(model, lr=1e-2, **LOOP, **NGP_ADAM, density_penalty=0.1,
                                    density_penalty_batch_size=32, grid_freeze_after=0)  # no refresh in the step
    u, density_draws = loss_draws(key)
    got = flops.traced_flops(lambda: loop.step(batch, u=u, density_draws=density_draws))
    assert got["flops"] == want["flops"] > 0
    assert set(got["by_op"]) <= set(flops.MATMUL_OPS) and got["source"] == "aten-matmul"


@pytest.mark.parametrize("kind", ["vanilla", "ngp"])
def test_traced_flops_of_a_hierarchy_step_equal_the_jaxpr_count(kind):
    coarse, fine = hierarchy.flax_models(kind)
    jloop = jtrain.TrainLoop(coarse, fine, init_rng=jax.random.PRNGKey(1), lr=1e-3, coarse_ts=hierarchy.COARSE_TS,
                             fine_ts=hierarchy.FINE_TS, density_penalty=0.05,
                             density_penalty_batch_size=hierarchy.PENALTY_BATCH, **BBOX)
    batch, key = ray_batch(5), jax.random.PRNGKey(6)
    want = jflops.traced_flops(jloop._step_fn, jloop.state, key, jnp.asarray(batch))
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jloop.state.params))
    loop = hierarchy.port_loop(kind, params["coarse"], params["fine"], density_penalty=0.05,
                               density_penalty_batch_size=hierarchy.PENALTY_BATCH)
    got = flops.traced_flops(lambda: loop.step(batch, **hierarchy.jax_draws(key)))
    assert got["flops"] == want["flops"] > 0


def test_fused_kernels_add_their_layers_analytically(monkeypatch):
    """ctypes launches are invisible to the counter: a fused_mlp launch adds
    2 * MACs a point (591,488 MACs at the JAX widths, as chip_smoke counts
    them); nothing counted is None, never an MFU of 0."""
    model = NeRFModel(compute_dtype="bfloat16")
    packed = model.packed()
    assert flops.layer_macs(packed) == sum(layer.weight.numel() for layer in model.dense_layers()) == 591_488
    monkeypatch.setattr(fm, "fused_mlp_cuda", lambda packed, x, d: torch.zeros(x.shape[0], 4))
    cost = flops.traced_flops(lambda: fm.fused_mlp_cuda(packed, torch.zeros(10, 3), torch.zeros(10, 3)))
    assert cost["flops"] == 2.0 * 591_488 * 10 and cost["source"] == "aten-matmul+fused-kernels"
    assert flops.traced_flops(lambda: torch.ones(3) + 1) is None
    assert flops.roofline(None, 1.0) == {}


def test_roofline_keys_and_peaks(monkeypatch):
    cost = dict(flops=66.9e12, bytes=None, source="aten-matmul")
    assert flops.roofline(cost, 2.0) == dict(tflops=33.45, mfu=0.5, flops_source="aten-matmul")
    assert flops.roofline(cost, 1.0, dtype="bfloat16")["mfu"] == pytest.approx(66.9 / 989.4)
    with_bytes = flops.roofline(dict(flops=1e12, bytes=3.35e12), 2.0)
    assert set(with_bytes) == {"tflops", "mfu", "gbps", "bw_util", "bound", "speed_of_light_frac"}
    assert with_bytes["bound"] == "memory" and with_bytes["speed_of_light_frac"] == pytest.approx(0.5)
    monkeypatch.setenv("NERF_TPU_PEAK_FLOPS", "1e12")
    assert flops.roofline(cost, 1.0)["mfu"] == pytest.approx(66.9)


def test_profile_trace_writes_a_trace(tmp_path):
    a = torch.randn(8, 8)
    with profile_trace(str(tmp_path / "trace")):
        (a @ a).sum()
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        assert any("mm" in e.get("name", "") for e in json.load(f)["traceEvents"])
