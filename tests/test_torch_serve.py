"""The port's HTTP render service and render CLI (learn_nerf_tpu_torch.
scripts), following tests/test_serve.py: endpoints against a live server
on a loopback port, determinism against a direct RenderSession with the
same seed, request validation, the occupancy bf16 route, the flags that
must refuse, flag parity with the JAX CLI, an import without jax, and the
render profiler."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from learn_nerf_tpu.scripts.render_nerf import base_argparser as jax_base_argparser
from learn_nerf_tpu_torch.checkpoint import save_params_pickle
from learn_nerf_tpu_torch.data.camera import CameraView
from learn_nerf_tpu_torch.kernels import fused_mlp as fm
from learn_nerf_tpu_torch.kernels import fused_render as fr
from learn_nerf_tpu_torch.scripts import profile_render, render_nerf, serve_nerf

from .synthetic_scene import write_dataset
from .torch_helpers import random_flax_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(scene_dir, checkpoint) with full-width random weights and an 8^3
    occupancy grid, half of it empty."""
    scene = str(tmp_path_factory.mktemp("scene"))
    write_dataset(scene, num_views=2, resolution=16)
    rng = np.random.RandomState(0)
    params = dict(
        coarse=random_flax_tree(1),
        fine=random_flax_tree(2),
        background=np.array([0.3, -0.2, 0.9], np.float32),
        occupancy_densities=(rng.rand(8**3) < 0.5).astype(np.float32),
        occupancy_resolution=8,
    )
    pkl = str(tmp_path_factory.mktemp("ckpt") / "nerf.pkl")
    save_params_pickle(pkl, params)
    return scene, pkl


def _argv(scene, pkl, *extra):
    return [
        "--seed", "0", "--batch_size", "64",
        "--coarse_samples", "4", "--fine_samples", "4",
        "--width", "16", "--height", "16",
        "--occ_candidates", "16", "--occ_samples", "8",
        "--model_path", pkl, *extra, f"{scene}/metadata.json",
    ]


@pytest.fixture(scope="module")
def served(scene):
    scene_dir, pkl = scene
    argv = _argv(scene_dir, pkl, "--port", "0")
    server = serve_nerf.make_server(serve_nerf.argparser().parse_args(argv))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}", scene_dir, argv
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_health_and_metadata(served):
    base, _, _ = served
    status, body = _get(f"{base}/health")
    assert status == 200 and json.loads(body) == {"ok": True}
    status, body = _get(f"{base}/metadata")
    md = json.loads(body)
    assert status == 200
    assert md["bbox_min"] == [-0.7] * 3 and md["default_width"] == 16


def test_render_matches_direct_session(served):
    base, scene, argv = served
    with open(f"{scene}/0000.json", "rb") as f:
        cam = f.read()
    status, ctype, png = _post(f"{base}/render", cam)
    assert status == 200 and ctype == "image/png"
    img = np.asarray(Image.open(io.BytesIO(png)))
    assert img.shape == (16, 16, 3)
    # Same seed, fresh session, first render -> identical image.
    direct = render_nerf.RenderSession(serve_nerf.argparser().parse_args(argv))
    expected = direct.render_view(CameraView.from_json(f"{scene}/0000.json"))
    np.testing.assert_array_equal(img, expected)


def test_render_custom_resolution_and_validation(served):
    base, scene, _ = served
    with open(f"{scene}/0000.json") as f:
        info = json.load(f)
    info["width"], info["height"] = 24, 12
    status, _, png = _post(f"{base}/render", json.dumps(info).encode())
    assert status == 200
    assert np.asarray(Image.open(io.BytesIO(png))).shape == (12, 24, 3)
    for bad in (
        b"not json at all",
        json.dumps({"z": [0, 0, 1]}).encode(),  # missing fields
        json.dumps([1, 2, 3]).encode(),
        json.dumps(dict(info, width=0)).encode(),
        json.dumps(dict(info, width=10**6)).encode(),
    ):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{base}/render", bad)
        assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"{base}/nope", b"{}")
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(f"{base}/nope")
    assert err.value.code == 404


def test_render_failure_answers_500_not_dropped_connection(served):
    base, scene, _ = served
    with open(f"{scene}/0000.json") as f:
        info = json.load(f)
    info["x"] = [1.0, 0.0]  # wrong arity: raises inside ray generation
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"{base}/render", json.dumps(info).encode())
    assert err.value.code == 500
    assert "render failed" in json.loads(err.value.read())["error"]
    status, _ = _get(f"{base}/health")
    assert status == 200


@pytest.mark.parametrize("mode", [[], ["--occupancy"]])
def test_bf16_session_takes_the_fused_route_and_matches_f32(scene, mode):
    scene_dir, pkl = scene
    view = CameraView.from_json(f"{scene_dir}/0001.json")
    images = {}
    for dtype in ("f32", "bf16"):
        argv = _argv(scene_dir, pkl, *mode, *(["--bf16"] if dtype == "bf16" else []))
        session = render_nerf.RenderSession(render_nerf.argparser().parse_args(argv))
        fm.counter.reset()
        fr.counter.reset()
        images[dtype] = session.render_view(view).astype(np.int32)
        calls = (fm.counter.plain_calls, fr.counter.plain_calls)
        if dtype == "f32":
            assert calls == (0, 0)
        elif mode:
            assert calls == (0, 4)  # one fused render per 64-ray tile
        else:
            assert calls == (8, 0)  # coarse + fine MLP per tile
    assert images["bf16"].shape == (16, 16, 3)
    # bf16 products against the f32 model; the hierarchy's fine samples
    # follow the coarse weights, so small differences move them too.
    assert np.abs(images["bf16"] - images["f32"]).max() <= 8


def test_render_cli_writes_views_side_by_side(scene, tmp_path):
    scene_dir, pkl = scene
    out = str(tmp_path / "out.png")
    render_nerf.main(
        _argv(scene_dir, pkl, "--occupancy")[:-1]
        + [f"{scene_dir}/metadata.json", f"{scene_dir}/0000.json", f"{scene_dir}/0001.json", out]
    )
    assert np.asarray(Image.open(out)).shape == (16, 32, 3)


@pytest.mark.parametrize(
    "flags",
    [
        ["--instant_ngp"],
        ["--ref_nerf"],
        ["--baked", "64"],
        ["--occupancy", "--occ_budget_per_ray", "4"],
        ["--occupancy", "--occ_budget_per_ray", "auto"],
        ["--occupancy", "--occ_span_candidates", "64"],
        ["--occupancy", "--occ_block_gather", "2"],
        ["--occupancy", "--occ_span_block_gather", "1"],
    ],
)
def test_unported_flags_refuse_with_system_exit(scene, flags):
    scene_dir, pkl = scene
    args = serve_nerf.argparser().parse_args(_argv(scene_dir, pkl, *flags))
    with pytest.raises(SystemExit, match="not ported"):
        serve_nerf.make_server(args)


def test_visible_multi_gpu_mesh_refuses(scene, monkeypatch):
    scene_dir, pkl = scene
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match="multi-GPU"):
        render_nerf.RenderSession(render_nerf.argparser().parse_args(_argv(scene_dir, pkl)))


def test_flags_and_defaults_match_the_jax_cli():
    def options(parser):
        return {a.dest: a.default for a in parser._actions if a.option_strings and a.dest != "help"}

    assert options(render_nerf.base_argparser()) == options(jax_base_argparser())


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import learn_nerf_tpu_torch.scripts.serve_nerf\n"
        "import learn_nerf_tpu_torch.kernels.build\n"
        "bad = [m for m in sys.modules if m == 'learn_nerf_tpu' or m.startswith('learn_nerf_tpu.')]\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=repo
    )
    assert proc.returncode == 0, proc.stderr


def test_profile_view_times_renders_on_cpu(scene):
    scene_dir, pkl = scene
    session = render_nerf.RenderSession(render_nerf.argparser().parse_args(_argv(scene_dir, pkl)))
    view = CameraView.from_json(f"{scene_dir}/0000.json")
    result = profile_render.profile_view(session, view, repeats=3)
    assert len(result["latencies_ms"]) == 3 and result["median_ms"] > 0
    assert result["profiled_ms"] > 0 and not session.images
    # No card: the device fields are not measured.
    assert result["device_ms"] is None and result["idle_share"] is None


def test_device_summary_merges_overlapping_device_spans():
    events = [
        dict(ph="X", cat="kernel", name="a", ts=0.0, dur=1000.0),
        dict(ph="X", cat="kernel", name="b", ts=500.0, dur=1000.0),  # overlaps a
        dict(ph="X", cat="gpu_memcpy", name="copy", ts=3000.0, dur=500.0),
        dict(ph="X", cat="kernel", name="a", ts=4000.0, dur=250.0),
        dict(ph="X", cat="cpu_op", name="aten::mm", ts=0.0, dur=9000.0),  # host, not counted
    ]
    busy, top = profile_render.device_summary(events)
    assert busy == pytest.approx(2.25)
    assert top == [("a", pytest.approx(1.25)), ("b", pytest.approx(1.0))]
