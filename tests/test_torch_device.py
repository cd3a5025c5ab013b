"""The port's entry points run on the CUDA card and do not fall back to the
CPU: without a card (``torch.cuda.is_available`` patched to False) the
device helper, a render session, the HTTP service and the profiler raise,
unless they are given ``--device cpu``, and then they render."""

import numpy as np
import pytest
import torch

from learn_nerf_tpu_torch.checkpoint import save_params_pickle
from learn_nerf_tpu_torch.data.camera import CameraView
from learn_nerf_tpu_torch.scripts import common, profile_render, render_nerf, serve_nerf, train_nerf

from .synthetic_scene import write_dataset
from .torch_helpers import random_flax_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(scene_dir, checkpoint) of a full-width vanilla model (the CLI's
    architecture) on an 8x8 view."""
    scene = str(tmp_path_factory.mktemp("scene"))
    write_dataset(scene, num_views=1, resolution=8)
    pkl = str(tmp_path_factory.mktemp("ckpt") / "nerf.pkl")
    save_params_pickle(pkl, dict(
        coarse=random_flax_tree(1), fine=random_flax_tree(2),
        background=np.array([0.3, -0.2, 0.9], np.float32),
    ))
    return scene, pkl


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _flags(pkl, *extra):
    return ["--seed", "0", "--batch_size", "32", "--coarse_samples", "4", "--fine_samples", "4",
            "--width", "8", "--height", "8", "--model_path", pkl, *extra]


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        common.default_device()
    assert common.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="--device cpu"):
        common.resolve_device("cuda")


@pytest.mark.parametrize("parser", [render_nerf.argparser, serve_nerf.argparser,
                                    profile_render.argparser, train_nerf.build_parser])
def test_device_flag_defaults_to_the_card(parser):
    options = {a.dest: a for a in parser()._actions}
    assert options["device"].default == "cuda" and options["device"].choices == ("cuda", "cpu")
    # The flag is the port's own: the base group stays equal to the JAX CLI's.
    assert "device" not in {a.dest for a in render_nerf.base_argparser()._actions}


@pytest.mark.parametrize("mode", [[], ["--occupancy"]])
def test_session_without_device_flag_raises_without_a_card(scene, no_card, mode):
    scene_dir, pkl = scene
    args = render_nerf.argparser().parse_args(_flags(pkl, *mode, f"{scene_dir}/metadata.json"))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_nerf.RenderSession(args)


def test_server_without_device_flag_raises_without_a_card(scene, no_card):
    scene_dir, pkl = scene
    args = serve_nerf.argparser().parse_args(_flags(pkl, "--port", "0", f"{scene_dir}/metadata.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_nerf.make_server(args)


def test_cpu_device_flag_renders_without_a_card(scene, no_card):
    scene_dir, pkl = scene
    argv = _flags(pkl, "--device", "cpu", f"{scene_dir}/metadata.json")
    session = render_nerf.RenderSession(render_nerf.argparser().parse_args(argv))
    assert session.device == torch.device("cpu") and session.background.device.type == "cpu"
    image = session.render_view(CameraView.from_json(f"{scene_dir}/0000.json"))
    assert image.shape == (8, 8, 3) and image.dtype == np.uint8
    server = serve_nerf.make_server(serve_nerf.argparser().parse_args(
        _flags(pkl, "--device", "cpu", "--port", "0", f"{scene_dir}/metadata.json")))
    try:
        assert server.session.device == torch.device("cpu")
    finally:
        server.server_close()


TRAIN_FLAGS = ["--instant_ngp", "--occupancy", "--occ_candidates", "16", "--occ_samples", "4",
               "--occ_grid", "8", "--batch_size", "32", "--steps", "1", "--seed", "0"]


def test_train_without_device_flag_raises_without_a_card(scene, no_card, tmp_path):
    scene_dir, _ = scene
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_nerf.main([*TRAIN_FLAGS, "--save_path", str(tmp_path / "t.pkl"), scene_dir])
    assert not (tmp_path / "t.pkl").exists()


def test_train_with_cpu_device_flag_trains_without_a_card(scene, no_card, tmp_path):
    scene_dir, _ = scene
    train_nerf.main([*TRAIN_FLAGS, "--device", "cpu", "--save_path", str(tmp_path / "t.pkl"), scene_dir])
    assert (tmp_path / "t.pkl").exists()
