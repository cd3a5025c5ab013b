"""The port's HTTP render service and render CLI (learn_nerf_tpu_torch.
scripts), following tests/test_serve.py: endpoints against a live server
on a loopback port, determinism against a direct RenderSession with the
same seed, request validation, the occupancy bf16 route, both Ref-NeRF
models served at the JAX widths, the span and block-word levers served,
the flags that must still refuse (baking without ``--occupancy``), flag
parity with the JAX CLI, an import without jax, and the render profiler."""

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
        "--device", "cpu", "--seed", "0", "--batch_size", "64",
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
        ["--instant_ngp", "--ref_nerf", "--baked", "64"],
        ["--baked", "64"],
        ["--instant_ngp", "--baked", "64"],
    ],
)
def test_unported_flags_refuse_with_system_exit(scene, flags):
    scene_dir, pkl = scene
    args = serve_nerf.argparser().parse_args(_argv(scene_dir, pkl, *flags))
    # Baking is ported, but only under --occupancy (as in the JAX CLI).
    with pytest.raises(SystemExit, match="--baked requires --occupancy"):
        serve_nerf.make_server(args)


LEVER_FLAGS = {
    "ref-nerf span": ["--ref_nerf", "--occupancy", "--occ_span_candidates", "64"],
    "pooled span": ["--occupancy", "--occ_budget_per_ray", "auto", "--occ_span_candidates", "64"],
    "span": ["--occupancy", "--occ_span_candidates", "64"],
    "block words": ["--occupancy", "--occ_block_gather", "2"],
    "span block words": ["--occupancy", "--occ_span_candidates", "8", "--occ_span_block_gather", "1"],
}


@pytest.mark.parametrize("lever", list(LEVER_FLAGS))
def test_inference_levers_serve(scene, tmp_path, lever):
    """The span and block-word levers (refused until they were ported) reach
    the server's renderer and serve a PNG equal to a direct session's
    render of the same view and seed (the Ref-NeRF case from a Ref-NeRF
    checkpoint at the JAX widths)."""
    scene_dir, pkl = scene
    flags = LEVER_FLAGS[lever]
    if "--ref_nerf" in flags:
        from learn_nerf_tpu_torch.checkpoint import checkpoint_to_flax
        from learn_nerf_tpu_torch.data.dataset import ModelMetadata
        from learn_nerf_tpu_torch.scripts.common import create_model

        args = serve_nerf.argparser().parse_args(_argv(scene_dir, "unused", *flags))
        torch.manual_seed(1)
        coarse, fine, _ = create_model(args, ModelMetadata.from_json(f"{scene_dir}/metadata.json"))
        ckpt = dict(coarse=coarse.state_dict(), fine=fine.state_dict(), background=np.zeros(3, np.float32),
                    occupancy_densities=(np.random.RandomState(1).rand(8**3) < 0.5).astype(np.float32),
                    occupancy_resolution=8)
        pkl = str(tmp_path / "refnerf.pkl")
        save_params_pickle(pkl, checkpoint_to_flax(ckpt, **fine.flax_layout()))
    argv = _argv(scene_dir, pkl, *flags)
    server = serve_nerf.make_server(serve_nerf.argparser().parse_args([*argv[:-1], "--port", "0", argv[-1]]))
    renderer = server.session.renderer
    args = serve_nerf.argparser().parse_args(argv)
    assert (renderer.span_candidates, renderer.span_pool_factor, renderer.block_gather_stride,
            renderer.span_block_gather) == (args.occ_span_candidates, args.occ_span_pool_factor,
                                            args.occ_block_gather, args.occ_span_block_gather)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    try:
        status, ctype, png = _post(f"http://{host}:{port}/render", open(f"{scene_dir}/0000.json", "rb").read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive() and status == 200 and ctype == "image/png"
    served = np.asarray(Image.open(io.BytesIO(png)))
    direct = render_nerf.RenderSession(args).render_view(CameraView.from_json(f"{scene_dir}/0000.json"))
    assert served.shape == (16, 16, 3)
    np.testing.assert_array_equal(served, direct)


@pytest.mark.parametrize("flags", [["--instant_ngp", "--ref_nerf", "--occupancy"], ["--ref_nerf"]],
                         ids=["hybrid occupancy", "vanilla hierarchy"])
def test_ref_nerf_serves_at_the_jax_widths(scene, tmp_path, flags):
    """Formerly refused: both Ref-NeRF models now parse, build at the JAX
    CLI's widths (the hybrid's 6 + 16 smooth levels of 2^18 rows, the
    vanilla 5 + 4 layers of 256) from a checkpoint in the pickle contract,
    and serve a PNG on the CPU, equal to a direct session's render of the
    same view and seed."""
    from learn_nerf_tpu_torch.checkpoint import checkpoint_to_flax
    from learn_nerf_tpu_torch.data.dataset import ModelMetadata
    from learn_nerf_tpu_torch.models import InstantNGPRefNeRFModel, RefNeRFModel
    from learn_nerf_tpu_torch.scripts.common import create_model

    scene_dir, _ = scene
    args = serve_nerf.argparser().parse_args(_argv(scene_dir, "unused", *flags))
    torch.manual_seed(0)
    coarse, fine, _ = create_model(args, ModelMetadata.from_json(f"{scene_dir}/metadata.json"))
    ckpt = dict(coarse=coarse.state_dict(), fine=fine.state_dict(), background=np.array([0.3, -0.2, 0.9], np.float32))
    if "--occupancy" in flags:
        ckpt.update(occupancy_densities=np.ones(8**3, np.float32), occupancy_resolution=8)
    pkl = str(tmp_path / "refnerf.pkl")
    save_params_pickle(pkl, checkpoint_to_flax(ckpt, **fine.flax_layout()))

    server = serve_nerf.make_server(serve_nerf.argparser().parse_args(_argv(scene_dir, pkl, "--port", "0", *flags)))
    model = server.session.fine
    if "--instant_ngp" in flags:
        assert isinstance(model, InstantNGPRefNeRFModel) and model.encoding.smooth
        assert len(model.encoding.grid_sizes) == 16 and model.encoding.table_0.shape[1] == 2
    else:
        assert isinstance(model, RefNeRFModel) and model.mid_layers[0].weight.shape == (256, 316)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    try:
        body = open(f"{scene_dir}/0000.json", "rb").read()
        req = urllib.request.Request(f"http://{host}:{port}/render", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200 and resp.headers.get("Content-Type") == "image/png"
            served = np.asarray(Image.open(io.BytesIO(resp.read())))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    session = render_nerf.RenderSession(render_nerf.argparser().parse_args(_argv(scene_dir, pkl, *flags)))
    view = CameraView.from_json(f"{scene_dir}/0000.json")
    direct = session.render_view(view, width=16, height=16)
    assert served.shape == (16, 16, 3)
    np.testing.assert_array_equal(served, direct)


@pytest.mark.parametrize("mode", [[], ["--occupancy", "--occ_budget_per_ray", "auto"]])
def test_session_over_a_mesh_renders_the_one_device_image(scene, mode):
    """A session over two devices (the render CLIs take every visible card)
    replicates its models once and renders what one device renders; the
    view's 256 rays in tiles of 64 spread 2 + 2."""
    from learn_nerf_tpu_torch.parallel.mesh import default_mesh

    scene_dir, pkl = scene
    view = CameraView.from_json(f"{scene_dir}/0000.json")
    args = render_nerf.argparser().parse_args(_argv(scene_dir, pkl, *mode))
    sessions = [render_nerf.RenderSession(args, mesh=default_mesh([torch.device("cpu")] * 2)),
                render_nerf.RenderSession(args)]
    assert sessions[0].mesh is not None and sessions[1].mesh is None
    np.testing.assert_array_equal(*(s.render_view(view) for s in sessions))


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
        "import learn_nerf_tpu_torch.scripts.profile_render\n"
        "import learn_nerf_tpu_torch.kernels.build\n"
        "import learn_nerf_tpu_torch.kernels.hashgrid\n"
        "import learn_nerf_tpu_torch.kernels.table_gather\n"
        "import learn_nerf_tpu_torch.kernels.selection\n"
        "import learn_nerf_tpu_torch.models.instant_ngp\n"
        "import learn_nerf_tpu_torch.ops.hashgrid\n"
        "import learn_nerf_tpu_torch.scripts.train_nerf\n"
        "import learn_nerf_tpu_torch.scripts.profile_train\n"
        "import learn_nerf_tpu_torch.train\n"
        "import learn_nerf_tpu_torch.step_graph\n"
        "import learn_nerf_tpu_torch.frame_graph\n"
        "import learn_nerf_tpu_torch.scripts.adam_ablations\n"
        "import learn_nerf_tpu_torch.data.shuffle\n"
        "import learn_nerf_tpu_torch.data.prefetch\n"
        "import learn_nerf_tpu_torch.utils.logging\n"
        "import learn_nerf_tpu_torch.kernels.hashgrid_backward\n"
        "import learn_nerf_tpu_torch.kernels.composite\n"
        "import learn_nerf_tpu_torch.scripts.composite_ablations\n"
        "import learn_nerf_tpu_torch.scripts.profile_trees\n"
        "import learn_nerf_tpu_torch.scripts.eval_psnr\n"
        "import learn_nerf_tpu_torch.utils.metrics\n"
        "import learn_nerf_tpu_torch.utils.progress\n"
        "import learn_nerf_tpu_torch.baked\n"
        "import learn_nerf_tpu_torch.kernels.baked\n"
        "import learn_nerf_tpu_torch.scripts.baked_ablations\n"
        "import learn_nerf_tpu_torch.scripts.exp_gather\n"
        "import learn_nerf_tpu_torch.scripts.hashgrid_ablations\n"
        "import learn_nerf_tpu_torch.checkpoint\n"
        "import learn_nerf_tpu_torch.convert.blender\n"
        "import learn_nerf_tpu_torch.convert.llff\n"
        "import learn_nerf_tpu_torch.ops.sh\n"
        "import learn_nerf_tpu_torch.models.ref_nerf\n"
        "import learn_nerf_tpu_torch.kernels.hashgrid_dx\n"
        "import learn_nerf_tpu_torch.acceleration\n"
        "import learn_nerf_tpu_torch.occ_render\n"
        "import learn_nerf_tpu_torch.render\n"
        "import learn_nerf_tpu_torch.mesh\n"
        "import learn_nerf_tpu_torch.parallel.mesh\n"
        "import learn_nerf_tpu_torch.utils.profiling\n"
        "import learn_nerf_tpu_torch.utils.flops\n"
        "import learn_nerf_tpu_torch.scripts.cv_nerf\n"
        "import learn_nerf_tpu_torch.scripts.check_bbox\n"
        "import learn_nerf_tpu_torch.scripts.plot_log\n"
        "import learn_nerf_tpu_torch.scripts.render_nerf_spin\n"
        "import learn_nerf_tpu_torch.scripts.render_nerf_pan\n"
        "import learn_nerf_tpu_torch.scripts.render_nerf_interactive\n"
        "import learn_nerf_tpu_torch.scripts.render_new_dataset\n"
        "import learn_nerf_tpu_torch.scripts.marching_cubes\n"
        "import learn_nerf_tpu_torch.scripts.frame_matrix\n"
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
    # No card: the device fields are not measured; the host ops are.
    assert result["device_ms"] is None and result["idle_share"] is None
    assert result["kernels_launched"] is None and result["port_kernels"] is None and result["port_calls"] is None
    assert result["port_graph_calls"] is None and result["graph_launch_kernels"] is None
    assert result["memsets"] is None and result["gemm_ms"] is None
    assert 0 < len(result["host_top"]) <= 5 and result["host_top"][0]["calls"] > 0


def test_launch_records_tie_kernels_to_their_launches():
    """A trace's kernels by the launch call whose correlation id they
    carry: two graph launches (the second lost a kernel record), an eager
    launch with its kernel and one without."""
    def call(name, ts, corr):
        return dict(ph="X", cat="cuda_runtime", name=name, ts=ts, args=dict(correlation=corr))

    def kernel(name, corr):
        return dict(ph="X", cat="kernel", name=name, ts=0.0, dur=1.0, args=dict(correlation=corr))

    events = [call("cudaGraphLaunch", 3.0, 7), call("cudaGraphLaunch", 1.0, 5), call("cudaLaunchKernel", 2.0, 6),
              call("cuLaunchKernel", 4.0, 8), call("cudaMemcpyAsync", 5.0, 9),
              kernel("select_strided_kernel", 5), kernel("hashgrid_encode_kernel<16>", 5),
              kernel("select_strided_kernel", 6), kernel("hashgrid_encode_kernel<16>", 7)]
    records = profile_render.launch_records(events)
    assert records == dict(graph=[5, 7], graph_kernels=[2, 1], without_kernel=1,
                           graph_port_calls=[dict(select_strided=1, hashgrid_encode=1), dict(hashgrid_encode=1)])
    assert profile_render.port_kernel_calls(events) == dict(select_strided=2, hashgrid_encode=2)
    assert profile_render.port_kernel_calls(events, set(records["graph"])) == dict(select_strided=1,
                                                                                   hashgrid_encode=2)


def test_timed_launchers_add_up_host_time_and_restore():
    """profile_train's host timer of the composite wrappers: every call is
    counted and timed, its result passed on, and the functions come back."""
    import types

    from learn_nerf_tpu_torch.kernels import composite as kc
    from learn_nerf_tpu_torch.scripts.profile_train import timed_launchers

    module = types.SimpleNamespace(f=lambda x: x + 1, g=lambda: None)
    original = module.f
    with timed_launchers(module, ("f", "g")) as totals:
        assert module.f(1) == 2 and module.f(2) == 3
    assert module.f is original
    assert totals["f"][1] == 2 and totals["f"][0] > 0 and totals["g"] == [0.0, 0]
    with timed_launchers(kc, ("_forward_launcher", "_backward_launcher")):
        pass
    assert (kc._forward_launcher, kc._backward_launcher) == (kc._launch_forward, kc._launch_backward)


def test_device_summary_merges_overlapping_device_spans():
    events = [
        dict(ph="X", cat="kernel", name="a", ts=0.0, dur=1000.0),
        dict(ph="X", cat="kernel", name="b", ts=500.0, dur=1000.0),  # overlaps a
        dict(ph="X", cat="gpu_memcpy", name="copy", ts=3000.0, dur=500.0),
        dict(ph="X", cat="kernel", name="a", ts=4000.0, dur=250.0),
        dict(ph="X", cat="cpu_op", name="aten::mm", ts=0.0, dur=9000.0),  # host, not counted
    ]
    busy, top, ours = profile_render.device_summary(events)
    assert busy == pytest.approx(2.25)
    assert top == [("a", pytest.approx(1.25)), ("b", pytest.approx(1.0))]
    assert ours == {}
    events.append(dict(ph="X", cat="kernel", name="void nerf::table_gather_kernel<2>(float const*)",
                       ts=5000.0, dur=750.0))
    assert profile_render.device_summary(events)[2] == {"table_gather": pytest.approx(0.75)}


def test_port_kernel_calls_count_each_run_of_a_port_kernel():
    """One count a kernel event, by the port kernel its name holds; host
    events, copies and other kernels count nothing."""
    kernel = lambda name: dict(ph="X", cat="kernel", name=name, ts=0.0, dur=1.0)  # noqa: E731
    events = [kernel("void nerf::select_strided_kernel<4>(nerf::SelectArgs)"), kernel("sm90_xmma_gemm"),
              kernel("void nerf::composite_backward_kernel<false, 0, false>(nerf::In, nerf::Grads)"),
              kernel("void nerf::select_strided_kernel<4>(nerf::SelectArgs)"),
              dict(ph="X", cat="gpu_memcpy", name="select_strided_kernel", ts=0.0, dur=1.0),
              dict(ph="X", cat="cuda_runtime", name="cudaGraphLaunch", ts=0.0, dur=1.0)]
    assert profile_render.port_kernel_calls(events) == {"select_strided": 2, "composite_backward": 1}
    assert profile_render.port_kernel_calls([]) == {}
