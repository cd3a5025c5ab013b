"""The port's render-family CLIs against learn_nerf_tpu's: render_nerf_spin,
render_nerf_pan, render_nerf_interactive, render_new_dataset and
marching_cubes (with the port's own ``mesh.py``), driven end to end on a
tiny scene on the CPU as tests/test_cli_e2e.py drives the JAX ones; their
parsers equal to the JAX parsers but ``--device``; the camera paths, the
distilled views and the depth images equal to the JAX CLIs'; and the
selection levers through render_nerf and eval_psnr."""

import argparse
import io
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from learn_nerf_tpu import mesh as jmesh
from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu.acceleration import OccupancyGrid as JaxGrid
from learn_nerf_tpu.data.camera import CameraView as JaxCameraView
from learn_nerf_tpu.models import NeRFModel as FlaxNeRFModel
from learn_nerf_tpu.scripts import marching_cubes as jax_marching_cubes
from learn_nerf_tpu.scripts import render_nerf_interactive as jax_interactive
from learn_nerf_tpu.scripts import render_nerf_pan as jax_pan
from learn_nerf_tpu.scripts import render_nerf_spin as jax_spin
from learn_nerf_tpu.scripts import render_new_dataset as jax_new_dataset
from learn_nerf_tpu_torch import mesh, occ_render
from learn_nerf_tpu_torch.acceleration import OccupancyGrid, OccupancyGridState
from learn_nerf_tpu_torch.checkpoint import save_params_pickle
from learn_nerf_tpu_torch.data.camera import CameraView
from learn_nerf_tpu_torch.scripts import (
    eval_psnr,
    marching_cubes,
    render_nerf,
    render_nerf_interactive,
    render_nerf_pan,
    render_nerf_spin,
    render_new_dataset,
)
from learn_nerf_tpu_torch.scripts.common import add_baked_args, add_model_args, add_occupancy_args

from .synthetic_scene import write_dataset
from .torch_helpers import port_model, random_flax_tree, t

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--seed", "0", "--batch_size", "64", "--coarse_samples", "4", "--fine_samples", "4"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(scene_dir, checkpoint): two 8x8 views of the synthetic scene and
    full-width random weights with an 8^3 grid, half of it empty."""
    scene = str(tmp_path_factory.mktemp("scene"))
    write_dataset(scene, num_views=2, resolution=8)
    params = dict(
        coarse=random_flax_tree(1), fine=random_flax_tree(2), background=np.array([0.3, -0.2, 0.9], np.float32),
        occupancy_densities=(np.random.RandomState(0).rand(8**3) < 0.5).astype(np.float32), occupancy_resolution=8,
    )
    pkl = str(tmp_path_factory.mktemp("ckpt") / "nerf.pkl")
    save_params_pickle(pkl, params)
    return scene, pkl


class _Parsed(Exception):
    pass


def jax_parser(main):
    """The parser a JAX CLI's ``main`` builds (its scripts build it inline)."""
    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["parser"] = self
        raise _Parsed

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(_Parsed):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = original
    return grabbed["parser"]


def options(parser):
    return {a.dest: (a.option_strings, a.default, a.nargs, a.const, a.type, a.help)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("port,jax_cli", [
    (render_nerf_spin, jax_spin), (render_nerf_pan, jax_pan), (render_nerf_interactive, jax_interactive),
    (render_new_dataset, jax_new_dataset), (marching_cubes, jax_marching_cubes),
], ids=["spin", "pan", "interactive", "render_new_dataset", "marching_cubes"])
def test_parser_equals_the_jax_cli(port, jax_cli):
    ours, theirs = options(port.argparser()), options(jax_parser(jax_cli.main))
    device = ours.pop("device")
    assert device[:2] == (["--device"], "cuda")  # the port's own flag
    assert {k: v[:4] for k, v in ours.items()} == {k: v[:4] for k, v in theirs.items()}
    # The shared flag groups carry the port's own help on the hardware
    # (tests/test_torch_serve.py holds their names and defaults).
    shared = argparse.ArgumentParser()
    for group in (add_model_args, add_occupancy_args, add_baked_args):
        group(shared)
    own = set(ours) - set(options(shared))
    for k in ours:  # the same types by name; the CLI's own flags' help
        assert getattr(ours[k][4], "__name__", None) == getattr(theirs[k][4], "__name__", None), k
        if k in own:
            assert ours[k][5] == theirs[k][5], k
    positionals = [a.dest for a in port.argparser()._actions if not a.option_strings]
    assert positionals == [a.dest for a in jax_parser(jax_cli.main)._actions if not a.option_strings]


def _fields(view):
    return [np.asarray(getattr(view, k), np.float64) for k in
            ("camera_direction", "camera_origin", "x_axis", "y_axis", "x_fov", "y_fov")]


def test_camera_paths_equal_the_jax_clis():
    start = dict(camera_direction=(0.0, 0.6, 0.8), camera_origin=(1.0, 2.0, -3.0), x_axis=(1.0, 0.0, 0.0),
                 y_axis=(0.0, 0.8, -0.6), x_fov=0.7, y_fov=0.6)
    pairs = [(render_nerf_spin.spin_views(CameraView(**start), 5), jax_spin.spin_views(JaxCameraView(**start), 5))]
    box = ((-0.7, -0.5, -0.3), (0.9, 0.5, 0.4))
    for random_axis in (False, True):
        pairs.append((render_nerf_pan.orbit_views(4, *box, 1.5, random_axis, rng=np.random.RandomState(3)),
                      jax_pan.orbit_views(4, *box, 1.5, random_axis, rng=np.random.RandomState(3))))
    for ours, theirs in pairs:
        ours, theirs = list(ours), list(theirs)
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            for x, y in zip(_fields(a), _fields(b)):
                np.testing.assert_array_equal(x, y)
    view, jview = CameraView(**start), JaxCameraView(**start)
    for cmd in "rludfbo":
        assert render_nerf_interactive.apply_command(view, cmd, 0.1, 0.2)
        assert jax_interactive.apply_command(jview, cmd, 0.1, 0.2)
        for x, y in zip(_fields(view), _fields(jview)):
            np.testing.assert_array_equal(x, y)
    assert not render_nerf_interactive.apply_command(view, "x", 0.1, 0.2)


def test_spin_and_pan_write_their_reels(scene, tmp_path):
    scene_dir, pkl = scene
    common = [*SMALL, "--width", "8", "--height", "8", "--model_path", pkl, "--frames", "3"]
    spin_png, pan_png = str(tmp_path / "spin.png"), str(tmp_path / "pan.png")
    render_nerf_spin.main([*common, f"{scene_dir}/metadata.json", f"{scene_dir}/0000.json", spin_png])
    render_nerf_pan.main([*common, "--occupancy", "--occ_candidates", "16", "--occ_samples", "8",
                          "--occ_span_candidates", "8", "--occ_block_gather", "2", "--random_axis",
                          f"{scene_dir}/metadata.json", pan_png])
    spin, pan = np.asarray(Image.open(spin_png)), np.asarray(Image.open(pan_png))
    assert spin.shape == pan.shape == (8, 24, 3)
    assert spin.std() > 0 and pan.std() > 0
    # Frame 0 of the spin is the start view itself.
    session = render_nerf.RenderSession(render_nerf.argparser().parse_args(
        [*SMALL, "--width", "8", "--height", "8", "--model_path", pkl, f"{scene_dir}/metadata.json"]))
    first = session.render_view(CameraView.from_json(f"{scene_dir}/0000.json"))
    np.testing.assert_array_equal(spin[:, :8], first)


def test_interactive_session_renders_a_frame_a_command(scene, tmp_path):
    scene_dir, pkl = scene
    out_dir = str(tmp_path / "frames")
    render_nerf_interactive.main(
        [*SMALL, "--width", "8", "--height", "8", "--model_path", pkl, "--occupancy", "--occ_candidates", "16",
         "--occ_samples", "8", "--occ_budget_per_ray", "auto", f"{scene_dir}/metadata.json",
         f"{scene_dir}/0000.json", out_dir],
        input_stream=io.StringIO("f\n2r\nx\n\no\nq\nf\n"),
    )
    # The first frame, then one per known command before q (f, 2r, o).
    frames = sorted(os.listdir(out_dir))
    assert frames == [f"frame_{i:05d}.png" for i in range(4)]
    assert np.asarray(Image.open(os.path.join(out_dir, frames[-1]))).shape == (8, 8, 3)


@pytest.mark.parametrize("mode", [[], ["--occupancy", "--occ_candidates", "16", "--occ_samples", "8",
                                       "--occ_budget_per_ray", "auto", "--occ_span_candidates", "8"]],
                         ids=["hierarchy", "pooled span"])
def test_render_new_dataset_writes_the_jax_clis_views(scene, tmp_path, monkeypatch, mode):
    """The port's distilled dataset: the JAX CLI's view JSONs for the same
    ``--seed`` (the JAX CLI run with its frame function stubbed: only its
    poses are compared), RGB and 16-bit depth PNGs of the right shape, the
    depth the formula of :func:`render_new_dataset.depth_image` on the
    port's frame, and a copy of metadata.json."""
    scene_dir, pkl = scene
    argv = ["--seed", "5", "--batch_size", "64", "--coarse_samples", "4", "--fine_samples", "4",
            "--num_images", "2", "--size", "8", "--model_path", pkl, *mode, f"{scene_dir}/metadata.json"]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    render_new_dataset.main(["--device", "cpu", *argv, ours])

    def stub(renderer, key, rays, *args, **kwargs):
        m = rays.shape[0]
        return dict(outputs=jnp.zeros((m, 3)), alphas=jnp.ones((m, 1)), coords=jnp.zeros((m, 3)),
                    selected=jnp.zeros((), jnp.int32), dropped=jnp.zeros((), jnp.int32))

    monkeypatch.setattr(jax_new_dataset, "render_frame", stub)
    monkeypatch.setattr(jocc, "render_frame_occupancy", stub)
    jax_new_dataset.main(argv + [theirs])
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "00000.json", "00000.png", "00000_depth.png", "00001.json", "00001.png", "00001_depth.png", "metadata.json"]
    for i in range(2):
        assert json.load(open(f"{ours}/{i:05}.json")) == json.load(open(f"{theirs}/{i:05}.json"))
        rgb, depth = np.asarray(Image.open(f"{ours}/{i:05}.png")), np.asarray(Image.open(f"{ours}/{i:05}_depth.png"))
        assert rgb.shape == (8, 8, 3) and depth.shape == (8, 8) and depth.dtype == np.uint16
    assert open(f"{ours}/metadata.json").read() == open(f"{scene_dir}/metadata.json").read()
    # The depth PNG is the frame's depth: rerender view 1 with the CLI's
    # session (a seeded generator replays the CLI's draws).
    args = render_new_dataset.argparser().parse_args(["--device", "cpu", *argv, str(tmp_path / "unused")])
    session = render_nerf.RenderSession(args, include_depth_outputs=True)
    views = [CameraView.from_json(f"{ours}/{i:05}.json") for i in range(2)]
    results = [session.render_arrays(v, 8, 8) for v in views]
    depth = render_new_dataset.depth_image(views[1], results[1]["alphas"], results[1]["coords"], 10.0)
    np.testing.assert_array_equal(np.asarray(Image.open(f"{ours}/00001_depth.png")),
                                  (depth.reshape(8, 8) * 0xFFFF).astype(np.uint16))
    with pytest.raises(FileExistsError):
        render_new_dataset.main(["--device", "cpu", *argv, ours])


@pytest.mark.parametrize("budget", [None, 8.0])
def test_depth_from_the_port_frame_equals_the_jax_formula_on_the_jax_frame(budget):
    """render_new_dataset's depth: the JAX CLI's formula on the JAX
    package's frame (``include_depth_outputs``) against the port's
    :func:`depth_image` on the port's frame, each tile fed JAX's uniforms,
    with the span lever on."""
    flax_model = FlaxNeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)
    zeros = jnp.zeros((1, 3))
    params = jax.device_get(flax_model.init(dict(params=jax.random.PRNGKey(0)), zeros, zeros)["params"])
    bbox = dict(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3)
    r = 32
    c = (np.arange(r) + 0.5) / r * 2.0 - 1.0
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    densities = ((x**2 + y**2 + z**2 < 0.5**2) * 40.0).astype(np.float32).reshape(-1)  # an opaque ball
    j_grid = JaxGrid(resolution=r, **bbox)
    j_state = j_grid.init().replace(densities=jnp.asarray(densities), step=jnp.asarray(j_grid.warmup_updates))
    levers = dict(candidates=64, samples=16, span_candidates=32, span_pool_factor=4)
    j = jocc.OccupancyRenderer(model=_Opaque(flax_model), grid=j_grid, **levers, **bbox)
    grid = OccupancyGrid(resolution=r, **bbox)
    port = occ_render.OccupancyRenderer(model=_PortOpaque(port_model(params, input_layers=1, mid_layers=1)),
                                        grid=grid, **levers, **bbox)
    state = OccupancyGridState(t(densities), grid.warmup_updates)
    view = CameraView(camera_direction=(0.0, 0.0, 1.0), camera_origin=(0.1, -0.1, -3.0), x_axis=(1.0, 0.0, 0.0),
                      y_axis=(0.0, 1.0, 0.0), x_fov=0.5, y_fov=0.5)
    rays = view.bare_rays(10, 10)
    key = jax.random.PRNGKey(2)
    ref = jocc.render_frame_occupancy(j, key, jnp.asarray(rays), params, jnp.zeros(3), j_state, tile_size=32,
                                      budget_per_ray=budget, include_depth_outputs=True)
    uniforms = t(np.stack([np.asarray(jax.random.uniform(k, (32, 64))) for k in jax.random.split(key, 4)]))
    with torch.no_grad():
        out = occ_render.render_frame_occupancy(port, t(rays), torch.zeros(3), state, tile_size=32,
                                                budget_per_ray=budget, uniforms=uniforms, include_depth_outputs=True)
    # The JAX CLI's formula, verbatim (scripts/render_new_dataset.py).
    results = {k: np.asarray(v) for k, v in ref.items()}
    z_dir = np.asarray(view.camera_direction, np.float32)
    origin = np.asarray(view.camera_origin, np.float32)
    raw_depth = ((results["coords"] - origin) @ z_dir)[:, None] / (results["alphas"] + 1e-8)
    want = np.clip(np.where(results["alphas"] > 0.9, raw_depth, 10.0), 0.0, 10.0) / 10.0
    got = render_new_dataset.depth_image(view, out["alphas"].numpy(), out["coords"].numpy(), 10.0)
    assert (want < 1.0).mean() > 0.2 and (want == 1.0).any()  # opaque and empty pixels both
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(render_new_dataset.depth_image(view, results["alphas"], results["coords"], 10.0),
                                  want)


class _Opaque:
    """A flax model's ``apply`` with its density raised 50-fold, so rays
    through the ball turn opaque (alpha > 0.9)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, x, d):
        density, rgb, aux = self.model.apply(variables, x, d)
        return density * 50.0, rgb, aux


class _PortOpaque(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x, d):
        density, rgb, aux = self.model(x, d)
        return density * 50.0, rgb, aux


@pytest.mark.parametrize("threshold", [0.3, 0.7])
def test_marching_tetrahedra_equals_jax(threshold):
    rng = np.random.RandomState(int(threshold * 10))
    c = np.linspace(-1, 1, 14)
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    volume = np.exp(-(x**2 + 2 * y**2 + z**2)) + 0.05 * rng.randn(14, 14, 14)
    ours, theirs = mesh.marching_tetrahedra(volume, threshold), jmesh.marching_tetrahedra(volume, threshold)
    assert len(ours[1]) > 0
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_marching_cubes_writes_the_jax_clis_mesh(scene, tmp_path):
    """The port's CLI and the JAX one on the same checkpoint (OBJ, and STL
    through the port): the same faces, vertices within the densities'
    f32 agreement."""
    scene_dir, pkl = scene
    meta = f"{scene_dir}/metadata.json"
    args = marching_cubes.argparser().parse_args(["--device", "cpu", "--model_path", pkl, meta, "x.obj"])
    from learn_nerf_tpu_torch.data.dataset import ModelMetadata

    metadata = ModelMetadata.from_json(meta)
    fine = marching_cubes.load_fine(args, metadata, torch.device("cpu"))
    coords = marching_cubes.grid_coordinates(metadata.bbox_min, metadata.bbox_max, 10).reshape(-1, 3)
    volume = marching_cubes.occupancy_volume(fine, coords, 128, torch.device("cpu"))
    threshold = float(np.round(np.median(volume), 3))  # a surface through the middle of the values
    flags = ["--resolution", "10", "--batch_size", "128", "--threshold", str(threshold), "--model_path", pkl, meta]
    paths = {name: str(tmp_path / name) for name in ("ours.obj", "theirs.obj", "ours.stl")}
    marching_cubes.main(["--device", "cpu", *flags, paths["ours.obj"]])
    jax_marching_cubes.main([*flags, paths["theirs.obj"]])
    marching_cubes.main(["--device", "cpu", *flags, paths["ours.stl"]])

    def read_obj(path):
        lines = open(path).read().splitlines()
        v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
        f = np.array([[int(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("f ")])
        return v, f

    (v, f), (jv, jf) = read_obj(paths["ours.obj"]), read_obj(paths["theirs.obj"])
    assert len(f) > 0
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-4)
    with open(paths["ours.stl"], "rb") as fh:
        fh.seek(80)
        assert struct.unpack("<I", fh.read(4))[0] == len(f)


def test_render_nerf_and_eval_psnr_take_the_levers(scene, tmp_path):
    """render_nerf and eval_psnr run with the four levers; an undersized
    span probe count exits with the JAX package's message."""
    scene_dir, pkl = scene
    levers = ["--occupancy", "--occ_candidates", "16", "--occ_samples", "8", "--occ_span_candidates", "8",
              "--occ_span_pool_factor", "4", "--occ_block_gather", "2", "--occ_span_block_gather", "1"]
    out = str(tmp_path / "out.png")
    render_nerf.main([*SMALL, "--width", "8", "--height", "8", "--model_path", pkl, *levers,
                      f"{scene_dir}/metadata.json", f"{scene_dir}/0000.json", out])
    assert np.asarray(Image.open(out)).shape == (8, 8, 3)
    scores, _ = eval_psnr.main([*SMALL, "--model_path", pkl, *levers, "--occ_budget_per_ray", "auto", scene_dir])
    assert len(scores) == 2 and np.isfinite(scores).all()
    # grid 8 / factor 4: a 2^3 supergrid needs ceil(2 * sqrt(3) * 2) = 7 probes.
    with pytest.raises(ValueError, match=r"occ_span_candidates=6 is too few probes .* need >= 7"):
        render_nerf.main([*SMALL, "--width", "8", "--height", "8", "--model_path", pkl, *levers[:5],
                          "--occ_span_candidates", "6", "--occ_span_pool_factor", "4", f"{scene_dir}/metadata.json",
                          f"{scene_dir}/0000.json", out])


def test_frame_matrix_holds_the_jax_workload_and_runs_on_the_cpu():
    """scripts/frame_matrix.py: bench.py's frame workload (its grid, camera,
    north-star BASE and tools/frame_matrix.py's seven rows), and a smoke
    run on the CPU at a small size (every row drop-free)."""
    import bench
    from learn_nerf_tpu_torch.scripts import frame_matrix
    from tools import frame_matrix as jax_frame_matrix

    j_grid = JaxGrid(resolution=128, bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3)
    grid = OccupancyGrid(resolution=128, bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3)
    ours, theirs = frame_matrix.shell_grid_state(grid, torch.device("cpu")), bench.shell_grid_state(j_grid)
    np.testing.assert_array_equal(ours.densities.numpy(), np.asarray(theirs.densities))
    assert ours.step == int(theirs.step)
    for x, y in zip(_fields(frame_matrix.frame_view()), _fields(bench.frame_view())):
        np.testing.assert_array_equal(x, y)
    assert frame_matrix.BASE == jax_frame_matrix.BASE
    assert all(frame_matrix.CONFIGS[k] == v for k, v in jax_frame_matrix.CONFIGS.items())
    assert list(frame_matrix.CONFIGS)[0] == "live_no_levers"

    result = frame_matrix.main(["--device", "cpu", "--size", "16", "--reps", "1", "--turns", "1", "--tile", "64",
                                "--bake_override", "9", "--configs", "live_no_levers,baked384_p4_bg4_sb4"])
    assert set(result["rows"]) == {"live_no_levers", "baked384_p4_bg4_sb4"}
    for row in result["rows"].values():
        assert row["dropped"] == 0 and row["median_s"] > 0 and row["device_ms"] is None
    assert result["rows"]["baked384_p4_bg4_sb4"]["config"]["bake"] == 9 and result["selection_ms"] is None
