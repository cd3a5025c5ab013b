"""Frame-time matrix over the occupancy renderer's inference levers, one
configuration a row (the counterpart of ``tools/frame_matrix.py`` and of
``bench.py``'s ``frame_800_baked`` frame workload).

The workload is scene-free: a 16-level Instant-NGP at the JAX widths with
weights drawn from a NumPy seed, a 128^3 grid holding a thin spherical
shell (:func:`shell_grid_state`: a surface's few occupied cells a ray, as a
trained grid has), one camera (:func:`frame_view`), pooled ``auto`` budgets
and ``--eps`` early termination.  ``BASE`` is the JAX package's north-star
frame (baked 384^3 bf16 at pack 4, 96 candidates, 32 samples, span 64);
``CONFIGS`` holds the JAX tool's seven rows, the port's serving default
before the levers (live, 192 candidates, no span) first, and the live field
with the block-word levers.  The baked fields are built once and shared
between rows of one bake (resolution, pack).

On the card every configuration is timed in one process, in turns A B ...
B A (``--turns``; 6 by default, as host-timed frames move by tens of per
cent): each turn renders one warm-up frame, ``--reps`` timed frames (host
clock around a synchronised render) and one frame under
``torch.profiler``.  Each row prints its median seconds a frame, device
ms, idle share, kernel count, auto budget and ``dropped`` (which must be
0), and the ``selection`` rows the device time of one 8192-ray tile's
selection alone with each lever, as the frames take it (CUDA events).  The last line is
one JSON object with the card's name and power limit.  ``--device cpu``
runs the same at a small size with no device numbers (a smoke run).

Usage:
  python -m learn_nerf_tpu_torch.scripts.frame_matrix --size 800 --reps 3
  python -m learn_nerf_tpu_torch.scripts.frame_matrix --device cpu --size 16 \\
      --tile 64 --bake_override 17 --configs live_no_levers,baked384_p4
"""

import argparse
import json
import statistics
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..acceleration import OccupancyGrid, OccupancyGridState
from ..baked import bake_instant_ngp
from ..data.camera import CameraView
from ..models import InstantNGPModel
from ..occ_render import OccupancyFrameSession, OccupancyRenderer
from .common import resolve_device
from .profile_render import profile_call

BBOX = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
#: The NumPy seed of the weights: the workload is fixed, as bench.py's is.
SEED = 0

#: The JAX package's north-star frame (``bench.bench_frame``).
BASE = dict(bake=384, pack=4, candidates=96, samples=32, span_candidates=64, block_gather=0,
            span_block_gather=0)

#: name -> overrides on BASE (bake 0: the live hash-grid field).
CONFIGS = {
    "live_no_levers": dict(bake=0, candidates=192, span_candidates=0),
    "live_span": dict(bake=0),
    "live_span_bg4": dict(bake=0, block_gather=4),
    "live_span_bg4_sb4": dict(bake=0, block_gather=4, span_block_gather=4),
    "baked384_p1": dict(pack=1),
    "baked384_p4": dict(),
    "baked384_p4_bg4": dict(block_gather=4),
    "baked384_p4_bg4_sb4": dict(block_gather=4, span_block_gather=4),
    "baked384_p4_bg4_sb4_c64": dict(block_gather=4, span_block_gather=4, candidates=64),
    "baked256_p8_bg4_sb4": dict(bake=256, pack=8, block_gather=4, span_block_gather=4),
}

#: The selection rows: one tile's selection alone, per lever.
SELECTIONS = {
    "192 candidates, no levers": dict(candidates=192),
    "96, span 64": dict(span_candidates=64),
    "96, span 64, span block words 4": dict(span_candidates=64, span_block_gather=4),
    "96, span 64, block words 4": dict(span_candidates=64, block_gather_stride=4),
    "96, span 64, both block words 4": dict(span_candidates=64, block_gather_stride=4, span_block_gather=4),
    "192, block words 4": dict(candidates=192, block_gather_stride=4),
}


def argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--size", type=int, default=800, help="frame side in pixels")
    parser.add_argument("--reps", type=int, default=3, help="timed frames a configuration a turn")
    parser.add_argument("--turns", type=int, default=6, help="passes over the configurations, alternating order")
    parser.add_argument("--tile", type=int, default=8192, help="rays a tile")
    parser.add_argument("--eps", type=float, default=1e-2, help="--occ_t_eps")
    parser.add_argument("--configs", default=",".join(CONFIGS), help="comma-separated subset of CONFIGS")
    parser.add_argument("--bake_override", type=int, default=0,
                        help="bake every baked configuration at this resolution (0: their own)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser


def shell_grid_state(grid: OccupancyGrid, device: torch.device, radius: float = 0.5,
                     thickness_cells: float = 1.5) -> OccupancyGridState:
    """A thin spherical shell of occupied cells, past warmup (the port's
    copy of ``bench.shell_grid_state``): rays cross it once or twice with a
    handful of occupied cells a crossing, as they cross a trained scene's
    surface."""
    res = grid.resolution
    centers = ((np.arange(res) + 0.5) / res) * 2.0 - 1.0
    x, y, z = np.meshgrid(centers, centers, centers, indexing="ij")
    rad = np.sqrt(x * x + y * y + z * z)
    shell = np.abs(rad - radius) < thickness_cells * 2.0 / res
    densities = torch.from_numpy(shell.reshape(-1).astype(np.float32)).to(device)
    return OccupancyGridState(densities=densities, step=grid.warmup_updates)


def frame_view() -> CameraView:
    """The flagship frame's camera (``bench.frame_view``)."""
    return CameraView(camera_direction=(0.0, 0.0, 1.0), camera_origin=(0.0, 0.0, -3.0), x_axis=(1.0, 0.0, 0.0),
                      y_axis=(0.0, 1.0, 0.0), x_fov=0.69, y_fov=0.69)


def seeded_ngp(device: torch.device) -> InstantNGPModel:
    """The 16-level Instant-NGP of the JAX widths (2^18 rows a level) over
    the workload's bbox, with flax's initial scales drawn from the NumPy
    seed SEED: tables uniform in +-1e-4, lecun-normal kernels, zero biases."""
    model = InstantNGPModel(table_sizes=[2**18] * 16, grid_sizes=[2 ** (4 + i // 2) for i in range(16)], **BBOX)
    rng = np.random.RandomState(SEED)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("encoding."):
                v = rng.uniform(-1e-4, 1e-4, p.shape)
            elif p.ndim == 2:
                v = rng.randn(*p.shape) / np.sqrt(p.shape[1])
            else:
                v = np.zeros(p.shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return model.to(device).eval()


def frame_session(cfg: Dict[str, int], model: InstantNGPModel, grid: OccupancyGrid, grid_state: OccupancyGridState,
                  tile: int, eps: float, bake_cache: dict) -> OccupancyFrameSession:
    """One configuration's frame session (pooled ``auto``), its bake taken
    from ``bake_cache`` when an earlier row made it."""
    field = model
    if cfg["bake"]:
        key = (cfg["bake"], cfg["pack"])
        if key not in bake_cache:
            bake_cache[key] = bake_instant_ngp(model, cfg["bake"], dtype=torch.bfloat16, pack=cfg["pack"],
                                               verbose=False)
        field = bake_cache[key]
    renderer = OccupancyRenderer(model=field, grid=grid, candidates=cfg["candidates"], samples=cfg["samples"],
                                 span_candidates=cfg["span_candidates"], block_gather_stride=cfg["block_gather"],
                                 span_block_gather=cfg["span_block_gather"], **BBOX)
    return OccupancyFrameSession(renderer, torch.zeros(3, device=grid_state.densities.device), grid_state,
                                 tile_size=tile, transmittance_eps=eps, budget_cfg="auto")


def card_line() -> Optional[str]:
    """``name, power limit`` of the card, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_config(session: OccupancyFrameSession, rays: torch.Tensor, reps: int, device: torch.device) -> dict:
    """One turn of one configuration: a warm-up frame, ``reps`` timed
    frames and one profiled frame."""
    generator = torch.Generator(device=device).manual_seed(1)

    def render():
        _sync(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = session.render(rays, generator)
        _sync(device)
        render.last = out
        return (time.perf_counter() - t0) * 1e3

    render()
    seconds = [render() / 1e3 for _ in range(reps)]
    profiled = profile_call(render, device)
    pool = session.last_pool
    return dict(seconds=seconds, device_ms=profiled["device_ms"], idle_share=profiled["idle_share"],
                kernels=profiled["kernels_launched"], budget=pool["budget"], dropped=pool["dropped"],
                selected=pool["selected"], finite=bool(torch.isfinite(render.last["outputs"]).all()))


def time_selection(model, grid, grid_state, rays, tile, eps, device) -> Dict[str, float]:
    """Device ms of one tile's selection as the frames take it (tables
    included; the selection kernel, or with block words the plain candidate
    test and compaction) per lever, by CUDA events."""
    from .timing import cuda_ms

    tile_rays = rays[:tile].contiguous()
    generator = torch.Generator(device=device).manual_seed(2)
    result = {}
    for name, levers in SELECTIONS.items():
        renderer = OccupancyRenderer(model=model, grid=grid, **{"candidates": 96, "samples": 32, **levers}, **BBOX)

        def select():
            tables = renderer.selection_tables(grid_state)
            return renderer._select(tile_rays, grid_state, eps, None, generator, tables)

        with torch.inference_mode():
            result[name] = cuda_ms(select, reps=20)
    return result


def main(argv=None) -> dict:
    args = argparser().parse_args(argv)
    device = resolve_device(args.device)
    names = args.configs.split(",")
    unknown = set(names) - set(CONFIGS)
    if unknown:
        raise SystemExit(f"unknown configurations {sorted(unknown)}; choose from {list(CONFIGS)}")
    card = card_line() if device.type == "cuda" else None
    model = seeded_ngp(device)
    grid = OccupancyGrid(resolution=128, **BBOX)
    grid_state = shell_grid_state(grid, device)
    rays = torch.from_numpy(frame_view().bare_rays(args.size, args.size)).to(device)

    bake_cache, configs, sessions, runs = {}, {}, {}, {name: [] for name in names}
    for name in names:
        cfg = configs[name] = dict(BASE, **CONFIGS[name])
        if args.bake_override and cfg["bake"]:
            cfg["bake"] = args.bake_override
        sessions[name] = frame_session(cfg, model, grid, grid_state, args.tile, args.eps, bake_cache)
    for turn in range(args.turns):
        for name in (names if turn % 2 == 0 else names[::-1]):
            runs[name].append(time_config(sessions[name], rays, args.reps, device))

    rows = {}
    for name in names:
        turns = runs[name]
        seconds = [s for r in turns for s in r["seconds"]]
        device_ms = [r["device_ms"] for r in turns]
        rows[name] = dict(
            config=configs[name],
            median_s=statistics.median(seconds),
            seconds=seconds,
            device_ms=None if None in device_ms else statistics.median(device_ms),
            idle_share=None if device_ms[0] is None else statistics.median(r["idle_share"] for r in turns),
            kernels=turns[-1]["kernels"],
            budget=turns[-1]["budget"],
            dropped=max(r["dropped"] for r in turns),
            selected=turns[-1]["selected"],
        )
        row = rows[name]
        device_note = "" if row["device_ms"] is None else (
            f"  device {row['device_ms']:.3f} ms  idle {row['idle_share']:.3f}  {row['kernels']} kernels")
        print(f"{name:26s} {row['median_s']:.4f} s/frame{device_note}  budget {row['budget']}  "
              f"dropped {row['dropped']}", flush=True)
        if row["dropped"] or not all(r["finite"] for r in turns):
            raise RuntimeError(f"{name}: dropped {row['dropped']} samples or rendered values that are not finite")
    selection = None
    if device.type == "cuda":
        selection = time_selection(model, grid, grid_state, rays, args.tile, args.eps, device)
        for name, ms in selection.items():
            print(f"selection of one {args.tile}-ray tile, {name}: {ms:.4f} ms", flush=True)
    result = dict(tool="frame_matrix", device=torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                  card=card, size=args.size, reps=args.reps, turns=args.turns, tile=args.tile, eps=args.eps,
                  bake_override=args.bake_override, rows=rows, selection_ms=selection)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
