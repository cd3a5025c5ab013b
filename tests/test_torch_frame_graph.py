"""Frames as tile replays (``learn_nerf_tpu_torch.frame_graph``) on the CPU,
at small sizes.

* The static-buffer route (each tile's rays copied into a fixed buffer, its
  uniforms drawn into fixed buffers, its outputs copied into the frame's)
  equals the frame as the tile loop rendered it before, bit for bit, for
  every mode: fixed-K, fused (the kernel's plain version), pooled live and
  baked, fixed-K baked, span and block words, the NGP Ref-NeRF hybrid's
  fixed-K, the hierarchy's vanilla (f32 and ``--bf16``), NGP and both
  Ref-NeRF models, and depth outputs.
* One parity case each against the JAX package's
  ``render_frame_occupancy`` and ``render_frame``, each tile fed JAX's
  uniforms, through the graph route.
* A stand-in for the CUDA graph (``StepGraphs._capture`` swapped, as
  ``tests/test_torch_train_graph.py`` does; its replay runs the captured
  body again with the launch counters untouched and writes its outputs
  into the captured ones): one capture a key and a replay a tile, a new
  key at another budget, the frames equal to the eager route's and the
  counters moved alike; a changed grid (its words table) or a changed
  ``packed()`` drops the graphs before any replay, and a graph kept past
  a changed grid renders the old grid; no tensor from Python values once a
  session stands; no graph on the CPU or over a mesh.
* The port's interactive notebook runs its code cells on a tiny
  checkpoint with the display stubbed.
* ``chip_smoke``'s rule for a profiled replayed frame: its trace may differ
  from the launch counters only by kernel records the trace shows lost.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu import occ_render as jocc
from learn_nerf_tpu import render as jrender
from learn_nerf_tpu.models import NeRFModel as FlaxNeRFModel
from learn_nerf_tpu_torch import acceleration, frame_graph, occ_render, render, step_graph
from learn_nerf_tpu_torch.baked import bake_instant_ngp
from learn_nerf_tpu_torch.checkpoint import load_params_pickle, save_params_pickle
from learn_nerf_tpu_torch.kernels import build
from learn_nerf_tpu_torch.models import InstantNGPModel, InstantNGPRefNeRFModel, RefNeRFModel
from learn_nerf_tpu_torch.parallel.mesh import Mesh
from learn_nerf_tpu_torch.scripts import render_nerf

from .synthetic_scene import write_dataset
from .test_torch_span_block import _frame_uniforms, grids, renderers, rays_into_bbox, word_grid
from .torch_helpers import port_model, random_flax_tree, t

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CUBE = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
F32 = dict(rtol=1e-5, atol=1e-5)
TILE = 32
RAYS = 70  # three tiles, the last one padded
NOTEBOOK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "learn_nerf_tpu_torch",
                        "scripts", "render_nerf_interactive.ipynb")


@pytest.fixture(scope="module")
def fields():
    """The small field models of every mode: vanilla f32 and bf16 (the
    same weights), a 4-level NGP, its 9^3 bake at packs 1 and 4, and the
    two Ref-NeRF models (vanilla and the NGP hybrid)."""
    tree = random_flax_tree(0, input_layers=1, mid_layers=1, hidden=16, color=8)
    torch.manual_seed(0)
    ngp = InstantNGPModel(table_sizes=[2**10] * 4, grid_sizes=[4, 8, 16, 32], hidden_dim=16, **CUBE).eval()
    ref_nerf = RefNeRFModel(sh_degree=4, input_layers=1, mid_layers=1, hidden_dim=16, color_layer_dim=16).eval()
    ref_ngp = InstantNGPRefNeRFModel(sh_degree=4, table_sizes=[2**10] * 3, grid_sizes=[4, 8, 32], hidden_dim=16,
                                     **CUBE).eval()
    with torch.no_grad():
        for table in (*ngp.encoding.tables(), *ref_ngp.encoding.tables()):
            table.uniform_(-1.0, 1.0)
    return dict(
        ref_nerf=ref_nerf,
        ref_ngp=ref_ngp,
        vanilla=port_model(tree, input_layers=1, mid_layers=1),
        bf16=port_model(tree, "bfloat16", input_layers=1, mid_layers=1),
        ngp=ngp,
        baked1=bake_instant_ngp(ngp, 9, dtype=torch.bfloat16, pack=1, verbose=False),
        baked4=bake_instant_ngp(ngp, 9, dtype=torch.bfloat16, pack=4, verbose=False),
    )


def grid_and_state():
    grid = acceleration.OccupancyGrid(resolution=32, **CUBE)
    densities = torch.from_numpy(word_grid(32, "random", seed=13) * 2.0)
    return grid, acceleration.OccupancyGridState(densities=densities, step=grid.warmup_updates)


# mode -> (field, pool budget a ray or None, levers)
OCCUPANCY_MODES = {
    "fixed-K": ("vanilla", None, {}),
    "fused": ("bf16", None, {}),
    "pooled": ("ngp", 6.0, {}),
    "baked pooled": ("baked4", 4.0, {}),
    "baked fixed-K": ("baked1", None, {}),
    "span": ("ngp", 6.0, dict(span_candidates=16)),
    "block words": ("ngp", None, dict(block_gather_stride=2)),
    "span and block words": ("ngp", 6.0, dict(span_candidates=16, span_block_gather=4, block_gather_stride=4)),
    "ref-nerf ngp fixed-K": ("ref_ngp", None, {}),
}


def occupancy_renderer(fields, mode):
    field, budget, levers = OCCUPANCY_MODES[mode]
    grid, state = grid_and_state()
    renderer = occ_render.OccupancyRenderer(model=fields[field], grid=grid, candidates=48, samples=12, **levers,
                                            **CUBE)
    return renderer, state, budget


def old_occupancy_frame(renderer, rays, background, state, eps, generator, budget_per_ray, depth):
    """The occupancy frame as the tile loop rendered it before the static
    buffers: each tile's strided view made contiguous, its uniforms drawn
    inside the tile's renderer."""
    m = rays.shape[0]
    rays_p, n = render.pad_rays_to_tiles(rays, TILE, renderer.bbox_max)
    pooled = budget_per_ray is not None
    rays_t = rays_p.reshape(TILE, n, 2, 3).transpose(0, 1) if pooled else rays_p.reshape(n, TILE, 2, 3)
    keys = ("outputs", "alphas", "coords") if depth else ("outputs",)
    tables = renderer.selection_tables(state)
    tiles, selected, dropped = {k: [] for k in keys}, [], []
    for i in range(n):
        common = dict(generator=generator, tables=tables)
        tile = rays_t[i].contiguous()
        if pooled:
            out = renderer.render_rays_pooled(tile, background, state, int(TILE * budget_per_ray), eps, **common)
            selected.append(out["selected"])
            dropped.append(out["dropped"])
        elif renderer.fused and not depth:
            out = renderer.render_rays_fused(tile, background, state, eps, **common)
        else:
            out, _ = renderer.render_rays(tile, background, state, eps, **common)
        for k in keys:
            tiles[k].append(out[k])
    result = {}
    for k, parts in tiles.items():
        v = torch.stack(parts)
        if pooled:
            v = v.transpose(0, 1)
        result[k] = v.reshape(-1, v.shape[-1])[:m]
    if pooled:
        result.update(selected=torch.stack(selected).sum(), dropped=torch.stack(dropped).sum())
    return result


def old_hierarchy_frame(renderer, rays, background, generator, depth):
    rays_p, n = render.pad_rays_to_tiles(rays, TILE, renderer.bbox_max)
    keys = ("outputs", "alphas", "coords") if depth else ("outputs",)
    parts = {k: [] for k in keys}
    for i in range(n):
        fine = renderer.render_rays(rays_p[i * TILE:(i + 1) * TILE], background, generator=generator)["fine"]
        for k in keys:
            parts[k].append(fine[k])
    return {k: torch.cat(v)[:rays.shape[0]] for k, v in parts.items()}


def assert_equal_frames(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


BACKGROUND = torch.tensor([0.1, 0.2, 0.3])


def flat(frame):
    """Whether every ray of the frame shows the background."""
    return float((frame["outputs"] - BACKGROUND).abs().max()) < 1e-3


@pytest.mark.parametrize("depth", [False, True], ids=["outputs", "depth outputs"])
@pytest.mark.parametrize("mode", list(OCCUPANCY_MODES))
def test_the_static_buffer_route_equals_the_old_occupancy_frame(fields, mode, depth):
    renderer, state, budget = occupancy_renderer(fields, mode)
    rays = t(rays_into_bbox(RAYS, seed=11))
    with torch.inference_mode():
        got = occ_render.render_frame_occupancy(renderer, rays, BACKGROUND, state, tile_size=TILE,
                                                transmittance_eps=1e-2, generator=torch.Generator().manual_seed(5),
                                                budget_per_ray=budget, include_depth_outputs=depth)
        want = old_occupancy_frame(renderer, rays, BACKGROUND, state, 1e-2, torch.Generator().manual_seed(5),
                                   budget, depth)
    assert_equal_frames(got, want)
    assert not flat(got)


HIERARCHY_MODES = {"vanilla": "vanilla", "vanilla --bf16": "bf16", "ngp": "ngp", "ref-nerf": "ref_nerf",
                   "ref-nerf ngp": "ref_ngp"}


def hierarchy_renderer(fields, mode):
    field = fields[HIERARCHY_MODES[mode]]
    return render.Renderer(coarse=field, fine=field, coarse_ts=6, fine_ts=5, **CUBE)


@pytest.mark.parametrize("depth", [False, True], ids=["outputs", "depth outputs"])
@pytest.mark.parametrize("mode", list(HIERARCHY_MODES))
def test_the_static_buffer_route_equals_the_old_hierarchy_frame(fields, mode, depth):
    renderer = hierarchy_renderer(fields, mode)
    rays = t(rays_into_bbox(RAYS, seed=12))
    with torch.inference_mode():
        got = render.render_frame(renderer, rays, BACKGROUND, tile_size=TILE,
                                  generator=torch.Generator().manual_seed(6), include_depth_outputs=depth)
        want = old_hierarchy_frame(renderer, rays, BACKGROUND, torch.Generator().manual_seed(6), depth)
    assert_equal_frames(got, want)
    assert not flat(got)


def test_a_mesh_frame_equals_the_old_frame(fields):
    """Over a mesh the tiles run eagerly through the same prologue: the
    draws for every tile come from the one generator, in tile order."""
    renderer, state, budget = occupancy_renderer(fields, "pooled")
    rays = t(rays_into_bbox(RAYS, seed=11))
    mesh = Mesh(devices=(torch.device("cpu"), torch.device("cpu")))
    with torch.inference_mode():
        got = occ_render.render_frame_occupancy(renderer, rays, BACKGROUND, state, tile_size=TILE,
                                                generator=torch.Generator().manual_seed(5), budget_per_ray=budget,
                                                mesh=mesh)
        padded = render.pad_rays_to_tiles(rays, TILE, renderer.bbox_max, 2)[0]  # four tiles over two devices
        want = old_occupancy_frame(renderer, padded, BACKGROUND, state, 0.0, torch.Generator().manual_seed(5),
                                   budget, False)
    assert torch.equal(got["outputs"], want["outputs"][:RAYS])
    assert torch.equal(got["selected"], want["selected"]) and torch.equal(got["dropped"], want["dropped"])


# -- the graph route with a stand-in for the CUDA graph ------------------------


class FakeGraph:
    """A captured tile body's stand-in: each replay runs the body, with
    every launch counter as it was, and writes its outputs into the
    captured ones, as a replay writes the graph's."""

    def __init__(self, body, outputs):
        self.body, self.outputs = body, outputs

    def replay(self):
        counts = [(c.launches, c.plain_calls) for c in build.COUNTERS]
        fresh = self.body()
        for c, (launches, plain) in zip(build.COUNTERS, counts):
            c.launches, c.plain_calls = launches, plain
        for k, v in self.outputs.items():
            v.copy_(fresh[k])


@pytest.fixture
def fake_graphs(monkeypatch):
    """``StepGraphs._capture`` replaced by :class:`FakeGraph`; yields the
    list of captures."""
    log = []

    def capture(self, body):
        outputs = body()
        log.append(self)
        return FakeGraph(body, outputs), outputs

    monkeypatch.setattr(step_graph.StepGraphs, "_capture", capture)
    return log


def cpu_graphs():
    return frame_graph.FrameGraphs(torch.device("cpu"))


def moved_counters(call):
    before = [(c.launches, c.plain_calls) for c in build.COUNTERS]
    result = call()
    return result, [(c.launches - a, c.plain_calls - b) for c, (a, b) in zip(build.COUNTERS, before)]


@pytest.mark.parametrize("mode", ["fixed-K", "fused", "baked pooled", "span and block words"])
def test_one_capture_a_key_and_a_replay_a_tile(fields, fake_graphs, mode):
    renderer, state, budget = occupancy_renderer(fields, mode)
    sessions = [occ_render.OccupancyFrameSession(renderer, BACKGROUND, state, tile_size=TILE, budget_cfg=budget)
                for _ in range(2)]
    sessions[0].graphs = cpu_graphs()
    rays = t(rays_into_bbox(RAYS, seed=11))

    def frames(session):
        g = torch.Generator().manual_seed(3)
        outs = [session.render(rays, g) for _ in range(2)]
        if budget is not None:
            session.budget_cfg = budget / 2  # another key
            outs.append(session.render(rays, g))
            session.budget_cfg = budget  # the first key again
            outs.append(session.render(rays, g))
        return outs

    with torch.inference_mode():
        got, got_moved = moved_counters(lambda: frames(sessions[0]))
        want, want_moved = moved_counters(lambda: frames(sessions[1]))
    for a, b in zip(got, want):
        assert_equal_frames(a, b)
    graphs = sessions[0].graphs
    keys = 2 if budget is not None else 1
    assert len(fake_graphs) == graphs.captures == keys and graphs.drops == 0
    assert graphs.replays == 3 * len(got)  # every tile of every frame
    assert got_moved == want_moved and any(launches or plain for launches, plain in got_moved)
    assert sessions[1].graphs is None


def test_the_hierarchy_replays_a_tile(fields, fake_graphs):
    renderer = hierarchy_renderer(fields, "vanilla --bf16")
    rays = t(rays_into_bbox(RAYS, seed=12))
    graphs = cpu_graphs()
    with torch.inference_mode():
        for seed in (1, 2):
            got = render.render_frame(renderer, rays, BACKGROUND, tile_size=TILE,
                                      generator=torch.Generator().manual_seed(seed), graphs=graphs)
            want = render.render_frame(renderer, rays, BACKGROUND, tile_size=TILE,
                                       generator=torch.Generator().manual_seed(seed))
            assert_equal_frames(got, want)
    assert (graphs.captures, graphs.replays, graphs.drops) == (1, 6, 0)


def test_a_changed_grid_drops_the_graphs(fields, fake_graphs):
    """A grid changed in place: the session builds its tables again and the
    graphs that read the old ones are dropped before any replay; kept, they
    render the old grid."""
    renderer, state, _ = occupancy_renderer(fields, "fixed-K")
    rays = t(rays_into_bbox(RAYS, seed=11))
    session = occ_render.OccupancyFrameSession(renderer, BACKGROUND, state, tile_size=TILE)
    session.graphs = cpu_graphs()
    with torch.inference_mode():
        before = session.render(rays, torch.Generator().manual_seed(1))
    first = session.tables()
    assert session.tables() is first  # built once while the grid stands
    with torch.no_grad():  # in place: its _version moves
        state.densities.copy_(torch.from_numpy(word_grid(32, "random", seed=4) * 2.0))
    with torch.inference_mode():
        got = session.render(rays, torch.Generator().manual_seed(1))
        want = old_occupancy_frame(renderer, rays, BACKGROUND, state, 0.0, torch.Generator().manual_seed(1), None,
                                   False)
    assert session.tables() is not first
    assert_equal_frames(got, want)
    assert not torch.equal(got["outputs"], before["outputs"]) and not flat(got)
    assert (session.graphs.captures, session.graphs.drops) == (2, 1)

    kept = occ_render.OccupancyFrameSession(renderer, BACKGROUND, state, tile_size=TILE)
    kept.graphs = cpu_graphs()
    with torch.inference_mode():
        kept.render(rays, torch.Generator().manual_seed(1))
        kept.graphs.follow = lambda reads: None  # the fault: nothing drops
        kept.grid_state = acceleration.OccupancyGridState(torch.zeros_like(state.densities), state.step)
        stale = kept.render(rays, torch.Generator().manual_seed(1))
        fresh = old_occupancy_frame(renderer, rays, BACKGROUND, kept.grid_state, 0.0,
                                    torch.Generator().manual_seed(1), None, False)
    assert torch.equal(stale["outputs"], got["outputs"]) and not torch.equal(stale["outputs"], fresh["outputs"])


def test_a_changed_packed_model_drops_the_graphs(fields, fake_graphs):
    model = port_model(random_flax_tree(4, input_layers=1, mid_layers=1, hidden=16, color=8), "bfloat16",
                       input_layers=1, mid_layers=1)
    grid, state = grid_and_state()
    renderer = occ_render.OccupancyRenderer(model=model, grid=grid, candidates=48, samples=12, **CUBE)
    session = occ_render.OccupancyFrameSession(renderer, BACKGROUND, state, tile_size=TILE)
    session.graphs = cpu_graphs()
    rays = t(rays_into_bbox(RAYS, seed=11))
    with torch.inference_mode():
        session.render(rays, torch.Generator().manual_seed(1))
        packed = model.packed()
        session.render(rays, torch.Generator().manual_seed(1))
    assert (session.graphs.captures, session.graphs.drops) == (1, 0)
    with torch.no_grad():
        model.rgb.bias.add_(0.5)
    with torch.inference_mode():
        got = session.render(rays, torch.Generator().manual_seed(1))
        want = old_occupancy_frame(renderer, rays, BACKGROUND, state, 0.0, torch.Generator().manual_seed(1), None,
                                   False)
    assert model.packed() is not packed
    assert (session.graphs.captures, session.graphs.drops) == (2, 1)
    assert_equal_frames(got, want)


def test_no_tensor_from_python_values_once_a_session_stands(fields, fake_graphs, monkeypatch):
    """After a session's first frame, its frames make no tensor from Python
    values in the port's frame code: on the card that is a host copy,
    which a capture forbids."""
    sessions = []
    for mode in [*OCCUPANCY_MODES, "auto"]:
        renderer, state, budget = occupancy_renderer(fields, "pooled" if mode == "auto" else mode)
        sessions.append(occ_render.OccupancyFrameSession(renderer, BACKGROUND, state, tile_size=TILE,
                                                         budget_cfg="auto" if mode == "auto" else budget,
                                                         transmittance_eps=1e-2))
    rays = t(rays_into_bbox(RAYS, seed=11))
    hierarchy = [hierarchy_renderer(fields, mode) for mode in HIERARCHY_MODES]
    graphs = [cpu_graphs() for _ in hierarchy]

    def frames():
        for session in sessions:
            session.render(rays, torch.Generator().manual_seed(1))
        for renderer, g in zip(hierarchy, graphs):
            render.render_frame(renderer, rays, BACKGROUND, tile_size=TILE,
                                generator=torch.Generator().manual_seed(1), graphs=g)

    for session in sessions:
        session.graphs = cpu_graphs()
    with torch.inference_mode():
        frames()
    made = []
    tensor = torch.tensor

    def recording(*args, **kwargs):
        made.append(sys._getframe(1).f_code.co_filename)
        return tensor(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", recording)
    with torch.inference_mode():
        frames()
    # The hash-grid encoding's plain version builds its corner offsets; on
    # the card the encode kernel runs in its place.
    plain_encode = os.path.join("ops", "hashgrid.py")
    mine = sorted({f for f in made if "learn_nerf_tpu_torch" in f and not f.endswith(plain_encode)})
    assert mine == []


def test_no_graph_on_the_cpu_or_over_a_mesh(fields, tmp_path):
    assert frame_graph.frame_graphs(torch.device("cpu")) is None
    assert frame_graph.frame_graphs(torch.device("cuda"), Mesh(devices=(torch.device("cuda"),) * 2)) is None
    assert isinstance(frame_graph.frame_graphs(torch.device("cuda", 0)), frame_graph.FrameGraphs)
    renderer, state, _ = occupancy_renderer(fields, "fixed-K")
    assert occ_render.OccupancyFrameSession(renderer, BACKGROUND, state).graphs is None
    mesh = Mesh(devices=(torch.device("cpu"), torch.device("cpu")))
    with pytest.raises(ValueError, match="over a mesh run eagerly"):
        occ_render.render_frame_occupancy(renderer, t(rays_into_bbox(8)), BACKGROUND, state, tile_size=4, mesh=mesh,
                                          graphs=cpu_graphs())
    with pytest.raises(ValueError, match="over a mesh run eagerly"):
        render.render_frame(hierarchy_renderer(fields, "ngp"), t(rays_into_bbox(8)), BACKGROUND, tile_size=4,
                            mesh=mesh, graphs=cpu_graphs())
    scene, pkl = tiny_checkpoint(tmp_path)
    for flags in ([], ["--occupancy"]):
        args = render_nerf.argparser().parse_args(notebook_flags(scene, pkl) + flags + [f"{scene}/metadata.json"])
        assert render_nerf.RenderSession(args).graphs is None


def test_the_stamp_follows_identity_and_version():
    a, b = torch.zeros(3), torch.ones(3)
    graphs = cpu_graphs()
    graphs._graphs["k"] = ("graph", {}, [])
    graphs.follow([a, b])
    graphs._graphs["k"] = ("graph", {}, [])
    graphs.follow([a, b])
    assert graphs.drops == 1 and "k" in graphs._graphs  # the first follow dropped the graph made before it
    b.add_(1.0)
    graphs.follow([a, b])
    assert graphs.drops == 2 and not graphs._graphs
    graphs._graphs["k"] = ("graph", {}, [])
    graphs.follow([a, torch.ones(3)])
    assert graphs.drops == 3
    with torch.inference_mode():
        c = torch.zeros(3)
    graphs.follow([c])
    assert graphs._stamp[0][2] is None  # an inference tensor keeps no version


def test_draws_through_another_device_generator_keep_the_order():
    buf = torch.empty(4, 3)
    g = torch.Generator().manual_seed(8)
    frame_graph.draw_uniforms(buf, g)
    want = torch.rand((4, 3), generator=torch.Generator().manual_seed(8))
    assert torch.equal(buf, want)


# -- parity with the JAX package through the graph route -----------------------


def test_the_graph_route_matches_jax_render_frame_occupancy(fake_graphs):
    tree = random_flax_tree(2, input_layers=1, mid_layers=1, hidden=16, color=8)
    flax_model = FlaxNeRFModel(hidden_dim=16, color_layer_dim=8, input_layers=1, mid_layers=1)
    j_grid, j_state, grid, state = grids(32, word_grid(32, "blobs", seed=13) * 2.0)
    j, port = renderers(j_grid, grid, (flax_model, port_model(tree, input_layers=1, mid_layers=1)), candidates=48,
                        samples=12)
    rays = rays_into_bbox(RAYS, seed=11)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    key = jax.random.PRNGKey(7)
    ref = jocc.render_frame_occupancy(j, key, jnp.asarray(rays), tree, jnp.asarray(bg), j_state, tile_size=TILE,
                                      budget_per_ray=6.0, transmittance_eps=1e-2)
    graphs = cpu_graphs()
    with torch.inference_mode():
        out = occ_render.render_frame_occupancy(port, t(rays), t(bg), state, tile_size=TILE, budget_per_ray=6.0,
                                                transmittance_eps=1e-2, uniforms=_frame_uniforms(key, 3, TILE, 48),
                                                graphs=graphs)
    assert graphs.replays == 3 and graphs.captures == 1
    np.testing.assert_allclose(out["outputs"].numpy(), np.asarray(ref["outputs"]), **F32)
    assert int(out["dropped"]) == int(ref["dropped"]) and int(out["selected"]) == int(ref["selected"])


def test_the_graph_route_matches_jax_render_frame(fake_graphs):
    params = load_params_pickle(os.path.join(GOLDEN, "vanilla_params.pkl"))
    hierarchy = dict(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3, coarse_ts=6, fine_ts=5)
    j = jrender.Renderer(coarse=FlaxNeRFModel(hidden_dim=32, color_layer_dim=16),
                         fine=FlaxNeRFModel(hidden_dim=48, color_layer_dim=16), **hierarchy)
    port = render.Renderer(coarse=port_model(params["coarse"]), fine=port_model(params["fine"]), **hierarchy)
    rng = np.random.RandomState(0)
    origins = rng.randn(45, 3).astype(np.float32) * 2
    dirs = -origins + rng.randn(45, 3).astype(np.float32) * 0.3
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = np.stack([origins, dirs], axis=1)
    bg = np.array([0.2, -0.1, 0.4], np.float32)
    key = jax.random.PRNGKey(9)
    ref = jrender.render_frame(j, key, jnp.asarray(rays), params["coarse"], params["fine"], jnp.asarray(bg),
                               tile_size=16, include_depth_outputs=True)
    uniforms = []
    for k in jax.random.split(key, 3):
        coarse_key, fine_key = jax.random.split(k)
        uniforms.append((t(jax.random.uniform(coarse_key, (16, 6))), t(jax.random.uniform(fine_key, (16, 5)))))
    graphs = cpu_graphs()
    with torch.inference_mode():
        frame = render.render_frame(port, t(rays), t(bg), tile_size=16, uniforms=uniforms, include_depth_outputs=True,
                                    graphs=graphs)
    assert (graphs.captures, graphs.replays) == (1, 3)
    np.testing.assert_allclose(frame["outputs"].numpy(), np.asarray(ref["outputs"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(frame["alphas"].numpy(), np.asarray(ref["alphas"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(frame["coords"].numpy(), np.asarray(ref["coords"]), rtol=1e-4, atol=1e-4)


# -- the interactive notebook ------------------------------------------------------


def tiny_checkpoint(tmp_path):
    scene = str(tmp_path / "scene")
    write_dataset(scene, num_views=2, resolution=16)
    rng = np.random.RandomState(0)
    pkl = str(tmp_path / "nerf.pkl")
    save_params_pickle(pkl, dict(coarse=random_flax_tree(1), fine=random_flax_tree(2),
                                 background=np.array([0.3, -0.2, 0.9], np.float32),
                                 occupancy_densities=(rng.rand(8**3) < 0.5).astype(np.float32),
                                 occupancy_resolution=8))
    return scene, pkl


def notebook_flags(scene, pkl):
    return ["--device", "cpu", "--width", "8", "--height", "8", "--batch_size", "32", "--coarse_samples", "4",
            "--fine_samples", "4", "--occ_grid", "8",
            "--occ_candidates", "16", "--occ_samples", "8", "--model_path", pkl]


def test_the_notebook_runs_on_a_tiny_checkpoint(tmp_path, monkeypatch):
    scene, pkl = tiny_checkpoint(tmp_path)
    with open(NOTEBOOK) as f:
        notebook = json.load(f)
    shown = []
    display = types.ModuleType("IPython.display")
    display.display = shown.append
    monkeypatch.setitem(sys.modules, "IPython.display", display)
    edits = {
        "METADATA_JSON = 'data/metadata.json'": f"METADATA_JSON = {scene + '/metadata.json'!r}",
        "VIEW_JSON = 'data/0000.json'": f"VIEW_JSON = {scene + '/0000.json'!r}",
        "OUTPUT_DIR = 'flythrough'": f"OUTPUT_DIR = {str(tmp_path / 'flythrough')!r}",
        "FLAGS = ['--device', 'cuda']": f"FLAGS = {notebook_flags(scene, pkl)!r}",
    }
    cells = ["".join(c["source"]) for c in notebook["cells"] if c["cell_type"] == "code"]
    for old, new in edits.items():
        assert sum(old in c for c in cells) == 1, old
        cells = [c.replace(old, new) for c in cells]
    for cell in cells:
        assert "learn_nerf_tpu." not in cell and "import jax" not in cell
    namespace = {}
    for cell in cells:
        exec(compile(cell, NOTEBOOK, "exec"), namespace)
    frames = namespace["frames"]
    assert len(frames) == 14 and all(f.shape == (8, 8, 3) and f.dtype == np.uint8 for f in frames)
    assert len(shown) == 15  # each frame, then the contact sheet
    assert len(os.listdir(tmp_path / "flythrough")) == 14
    assert not np.array_equal(frames[0], frames[1])  # the fly cell moved the camera


# -- chip_smoke's rule for a profiled frame's trace -----------------------------


def traced(ran, in_graphs, per_replay, without_kernel=0, kernels=100):
    """A ``chip_smoke.traced_call`` result of an 8-tile frame of one graph
    whose counters claim select_strided and hashgrid_encode once a replay
    and one eager select_strided; ``per_replay`` the kernel records of each
    replay, a full one 30 (two of them the port's)."""
    full = dict(select_strided=1, hashgrid_encode=1)
    return dict(kernels_launched=kernels, port_calls=ran, port_graph_calls=in_graphs,
                claimed=dict(select_strided=9, hashgrid_encode=8),
                claimed_graph=dict(select_strided=8, hashgrid_encode=8), replays=8, graphs=1,
                graph_launch_kernels=per_replay, graph_launch_port_calls=[full if n == 30 else {} for n in per_replay],
                launches_without_kernel=without_kernel)


def test_a_trace_may_differ_from_the_counters_only_by_records_it_shows_lost():
    import chip_smoke

    full = dict(select_strided=8, hashgrid_encode=8)
    assert chip_smoke.trace_matches(traced(dict(select_strided=9, hashgrid_encode=8), full, [30] * 8))
    # A replay that holds two records fewer than the others lost them: the
    # full replays back the claim.
    short = traced(dict(select_strided=8, hashgrid_encode=7), dict(select_strided=7, hashgrid_encode=7),
                   [28] + [30] * 7)
    assert chip_smoke.trace_matches(short) and chip_smoke.lost_records(short) == 2
    # Every replay full but the counters claim more a replay: a miscount.
    over = dict(traced(dict(select_strided=9, hashgrid_encode=8), full, [30] * 8),
                claimed_graph=dict(select_strided=16, hashgrid_encode=8))
    assert not chip_smoke.trace_matches(over) and not chip_smoke.trace_loss_explained(over)
    # A graph launch fewer than the counted replays: a miscount, not a loss.
    missing = traced(dict(select_strided=8, hashgrid_encode=7), dict(select_strided=7, hashgrid_encode=7), [30] * 7)
    assert not chip_smoke.trace_matches(missing) and not chip_smoke.trace_loss_explained(missing)
    # The eager select_strided's record lost: its launch call shows it.
    eager = traced(full, full, [30] * 8, without_kernel=1)
    assert not chip_smoke.trace_matches(eager) and chip_smoke.trace_loss_explained(eager)
    assert not chip_smoke.trace_loss_explained(dict(eager, launches_without_kernel=0))
    # More than the counters claim is never a loss; no kernel at all is.
    assert not chip_smoke.trace_loss_explained(traced(dict(select_strided=10, hashgrid_encode=8), full, [30] * 8, 1))
    assert chip_smoke.trace_loss_explained(traced({}, {}, [0] * 8, kernels=0))
