"""The port's dataset converters (``learn_nerf_tpu_torch.convert``) against
the JAX package's, file for file, on the stand-in captures of
``tools/make_blender_standin.py`` and ``tools/make_llff_standin.py`` (as
``tests/test_convert.py`` holds the JAX converters), and chip_smoke.py's own
Blender writer against the tool's capture, byte for byte.
"""

import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from learn_nerf_tpu.convert import blender as jax_blender
from learn_nerf_tpu.convert import llff as jax_llff
from learn_nerf_tpu_torch.convert import blender, llff
from learn_nerf_tpu_torch.data.dataset import load_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(monkeypatch, name, *argv):
    monkeypatch.setattr(sys, "argv", [name, *map(str, argv)])
    runpy.run_path(os.path.join(REPO, "tools", name), run_name="__main__")


def same_tree(a, b):
    """Every file under ``a`` equals its namesake under ``b``, and no file
    is missing on either side."""
    files = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b) for f in fs)
    for name in files:
        with open(os.path.join(a, name), "rb") as x, open(os.path.join(b, name), "rb") as y:
            assert x.read() == y.read(), name
    return files


@pytest.fixture(scope="module")
def blender_capture(tmp_path_factory):
    out = tmp_path_factory.mktemp("blender") / "capture"
    monkeypatch = pytest.MonkeyPatch()
    try:
        run_tool(monkeypatch, "make_blender_standin.py", out, 16, 6)
    finally:
        monkeypatch.undo()
    return out


@pytest.mark.parametrize("split", ["train", "test"])
def test_blender_converter_equals_the_jax_converter(blender_capture, tmp_path, split):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    blender.main(["--split", split, str(blender_capture), str(ours)])
    jax_blender.main(["--split", split, str(blender_capture), str(theirs)])
    files = same_tree(ours, theirs)
    assert len(files) == 2 * (6 if split == "train" else 7) + 1 and "metadata.json" in files
    data = load_dataset(str(ours))
    assert len(data.views) == len(files) // 2 and data.metadata.bbox_min == (-1.0, -1.0, -1.0)
    with pytest.raises(FileExistsError, match="output path exists"):
        blender.main(["--split", split, str(blender_capture), str(ours)])


def test_chip_smoke_blender_writer_equals_the_tool(blender_capture, tmp_path):
    """chip_smoke.py writes the stand-in without tests/ or tools/: the same
    transforms and PNGs, byte for byte, at the tool's fov and test views."""
    chip_smoke.write_blender_capture(tmp_path / "capture", res=16, n_views=6)
    files = same_tree(tmp_path / "capture", blender_capture)
    assert "transforms_train.json" in files and "test/r_6.png" in files


@pytest.fixture(scope="module")
def llff_capture(tmp_path_factory):
    out = tmp_path_factory.mktemp("llff") / "capture"
    monkeypatch = pytest.MonkeyPatch()
    try:
        run_tool(monkeypatch, "make_llff_standin.py", out, 16)
    finally:
        monkeypatch.undo()
    return out


@pytest.mark.parametrize("factor", ["1.0", "0.5"])
def test_llff_converter_equals_the_jax_converter(llff_capture, tmp_path, factor):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    llff.main(["--factor", factor, str(llff_capture), str(ours)])
    jax_llff.main(["--factor", factor, str(llff_capture), str(theirs)])
    files = same_tree(ours, theirs)
    assert len(files) == 2 * 12 + 1
    side = 16 if factor == "1.0" else 8
    assert Image.open(ours / "00000.png").size == (side, side)
    assert len(load_dataset(str(ours)).views) == 12


def test_blender_decode_of_known_poses(tmp_path):
    """tests/test_convert.py's poses: OpenGL axes to this repo's, y_fov from
    the aspect ratio, the fixed bbox."""
    src = tmp_path / "src"
    os.makedirs(src / "train")
    frames = []
    for i, angle in enumerate([0.0, np.pi / 2]):
        c, s = np.cos(angle), np.sin(angle)
        mat = np.eye(4)
        mat[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        mat[:3, 3] = [i, 0.0, 4.0]
        frames.append(dict(file_path=f"./train/r_{i}", transform_matrix=mat.tolist()))
        Image.fromarray(np.full((20, 30, 3), 50 * (i + 1), np.uint8)).save(src / "train" / f"r_{i}.png")
    (src / "transforms_train.json").write_text(json.dumps(dict(camera_angle_x=0.7, frames=frames)))
    blender.main(["--split", "train", str(src), str(tmp_path / "out")])
    info = json.loads((tmp_path / "out" / "0000.json").read_text())
    assert info["origin"] == [0.0, 0.0, 4.0]
    np.testing.assert_allclose([info["x"], info["y"], info["z"]], [[1, 0, 0], [0, -1, 0], [0, 0, -1]], atol=1e-9)
    assert abs(info["y_fov"] - 2 * np.arctan(np.tan(0.35) * 20 / 30)) < 1e-9
    assert json.loads((tmp_path / "out" / "metadata.json").read_text()) == dict(min=[-1.0] * 3, max=[1.0] * 3)


def test_llff_decode_of_a_known_pose():
    cols = np.stack([[0, 1, 0], [-1, 0, 0], [0, 0, 1], [1.0, 0.0, 2.0], [40, 60, 50.0]], axis=1)
    camera, lo, hi = llff.decode_pose(np.concatenate([cols.reshape(-1), [0.5, 3.0]]))
    np.testing.assert_allclose([camera["x"], camera["y"], camera["z"]], [[-1, 0, 0], [0, 1, 0], [0, 0, -1]])
    assert abs(camera["x_fov"] - 2 * np.arctan(60 / 100)) < 1e-9
    np.testing.assert_allclose(lo, [-2.0, -3.0, -1.0])
    np.testing.assert_allclose(hi, [4.0, 3.0, 5.0])


def test_converter_module_runs_without_jax(blender_capture, tmp_path):
    """``python -m learn_nerf_tpu_torch.convert.blender`` with jax made
    unimportable."""
    code = ("import sys, runpy\nsys.modules['jax'] = None\nsys.argv = sys.argv[1:]\n"
            "runpy.run_module('learn_nerf_tpu_torch.convert.blender', run_name='__main__')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "blender", "--split", "test", str(blender_capture), str(tmp_path / "out")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert len(load_dataset(str(tmp_path / "out")).views) == 7
