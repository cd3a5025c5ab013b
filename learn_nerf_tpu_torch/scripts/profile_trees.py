"""Profile the train step and every render mode of several checkouts of the
port in one call on the card, in turns, so that they can be compared.

    python -m learn_nerf_tpu_torch.scripts.profile_trees --turns 2 \\
        --out profiles.jsonl PARENT_CHECKOUT .

Each run is one fresh Python process in a checkout's root, which imports
that checkout's own ``chip_smoke.py`` and package: it builds the
checkout's kernels, writes ``chip_smoke.py``'s scene and training views,
then profiles one train step cell (``scripts/profile_train.py`` with
``chip_smoke.py``'s train flags: 3 warm-up steps, ``--repeats`` timed (16),
one profiled) and, unless ``--train_only``, each render mode of
``chip_smoke.py --profile`` (the vanilla hierarchy
and occupancy, ``--bf16`` and f32; the three NGP modes in f32;
``scripts/profile_render.py``: one warm-up render at 256x256, five timed,
one profiled); with ``--pooled`` also ``bench_pooled``'s cell
(``profile_train.py --pooled``: the dense and the auto-pooled step on a
frozen 5 %-occupied grid); with ``--hierarchy`` also the coarse/fine
hierarchy's step of each model of ``chip_smoke.HIERARCHY_RUNS``
(``profile_train.py --hierarchy`` with ``chip_smoke.py``'s hierarchy flags:
batch 4096, 64 + 128 samples) and the Ref-NeRF hybrid's occupancy step
(``chip_smoke.ref_nerf_phase``'s flags); with ``--train_rates`` also ``train_nerf``'s
steps/s and rays/s over the last 64 and 48 of 96 steps, dense and pooled
(``chip_smoke.train_run`` with ``chip_smoke.py``'s phase-6 flags, the
checkout's own); with ``--frames`` also 800x800 frames of those rows of
``scripts/frame_matrix.py`` (the checkout's own workload and sessions,
pooled ``auto`` at eps 1e-2, tiles of 8192 rays: one warm-up frame,
eight timed (``FRAME_REPS``), one profiled, with the frame graphs' replays and
captures where the checkout has them).  Checkouts run in the order given
on even turns and in the reverse order on odd ones (A B, then B A).

Every run counts the memsets of each profiled call, and times and profiles
the train steps with this checkout's ``profile_train.profile_steps`` and
``profile_render.profile_call`` whichever checkout it runs, so that the
composite kernels' wrappers are timed on the host during the timed steps
(``composite_host_us``), and the host's launches counted, the same way in
each.  Prints
one JSON line per checkout, turn and mode (with the checkout's path and
the card's name and power limit), and writes them to ``--out``.
"""

import argparse
import inspect
import os
import subprocess
import sys
from pathlib import Path

from . import profile_render, profile_train

# Runs inside a checkout: only that checkout's code is imported.
RUN = r'''
import contextlib, json, os, shutil, statistics, sys, tempfile, time
from pathlib import Path

import numpy as np
import torch

FRAME_REPS = 8  # timed 800x800 frames of a --frames row a run
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from learn_nerf_tpu_torch.data.camera import CameraView
from learn_nerf_tpu_torch.kernels import build
from learn_nerf_tpu_torch.kernels import composite as kc
from learn_nerf_tpu_torch.scripts import profile_render, profile_train, render_nerf

memsets = []
summary = profile_render.device_summary


def counting(events, *args, **kwargs):
    memsets.append(sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_memset"))
    return summary(events, *args, **kwargs)


profile_render.device_summary = counting
label = dict(tree=os.environ["PROFILE_TREE"], turn=int(os.environ["PROFILE_TURN"]), card=cs.card_line())


def emit(mode, result):
    result = {**label, "mode": mode, **result, "memsets": memsets.pop() if memsets else None}
    print("PROFILE " + json.dumps(result), flush=True)


build.library()
build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
root = Path(tempfile.mkdtemp(prefix="profile_trees_", dir=build.BUILD_DIR))
try:
    rng = np.random.RandomState(cs.SEED)
    with open(os.devnull, "w") as quiet:
        stdout, sys.stdout = sys.stdout, quiet
        try:
            cs.write_scene(root, rng)
            cs.write_train_scene(root / "train", np.random.RandomState(cs.SEED + 7))
        finally:
            sys.stdout = stdout
    flags = ["--instant_ngp", "--occupancy", "--seed", str(cs.SEED), "--lr", "1e-2",
             "--batch_size", str(cs.TRAIN_RAYS), "--occ_warmup", str(cs.TRAIN_WARMUP), str(root / "train")]
    args = profile_train.argparser().parse_args(flags + ["--repeats", os.environ["PROFILE_REPEATS"]])
    # Every checkout's steps are timed and profiled by the same profile_steps
    # and profile_call: the ones of the checkout that runs this script.
    profile_train.kc, profile_train.contextlib, profile_train.tempfile, profile_train.json = (
        kc, contextlib, tempfile, json)
    profile_train.device_summary, profile_train.host_summary = (profile_render.device_summary,
                                                                profile_render.host_summary)
    exec(os.environ["PROFILE_STEPS_SOURCE"], profile_train.__dict__)
    emit("ngp occupancy train step", profile_train.profile_args(args))
    if os.environ["PROFILE_POOLED"] == "1":
        pooled = profile_train.argparser().parse_args(flags + ["--repeats", os.environ["PROFILE_REPEATS"], "--pooled"])
        for half, result in profile_train.profile_args(pooled).items():
            emit(f"ngp occupancy train step, bench_pooled grid, {half}", result)
    if os.environ["PROFILE_HIERARCHY"] == "1":
        import gc

        repeats = ["--repeats", os.environ["PROFILE_REPEATS"]]
        runs = [(f"{name} train step", [*cs.HIERARCHY_FLAGS, *run_flags, "--hierarchy"])
                for name, (run_flags, _) in cs.HIERARCHY_RUNS.items()]
        runs.append(("ref-nerf ngp occupancy train step", ["--ref_nerf", *flags[:-1]]))
        for mode, run_flags in runs:
            emit(mode, profile_train.profile_args(profile_train.argparser().parse_args(
                [*run_flags, *repeats, str(root / "train")])))
            gc.collect()
            torch.cuda.empty_cache()
    if os.environ["PROFILE_RATES"] == "1":
        base = flags[:-1]
        pooled_flags = [*base, "--occ_train_budget", "auto", "--occ_train_budget_start", str(cs.POOL_START),
                        "--steps_per_dispatch", "8"]
        for run, run_flags in (("train_nerf", base), ("train_nerf pooled", pooled_flags)):
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                _, _, rate, loop = cs.train_run(root, run, run_flags, run.replace(" ", "_") + ".pkl")
            emit(run, dict(steps_per_s=rate, rays_per_s={n: r * cs.TRAIN_RAYS for n, r in rate.items()},
                           graph_replays=getattr(loop, "graph_replays", None)))
            del loop
            torch.cuda.empty_cache()
    if os.environ["PROFILE_FRAMES"] == "1":
        from learn_nerf_tpu_torch.acceleration import OccupancyGrid
        from learn_nerf_tpu_torch.scripts import frame_matrix as fm

        device = torch.device("cuda")
        model = fm.seeded_ngp(device)
        grid = OccupancyGrid(resolution=128, **fm.BBOX)
        state = fm.shell_grid_state(grid, device)
        frame_rays = torch.from_numpy(fm.frame_view().bare_rays(800, 800)).to(device)
        bakes = {}
        for name in os.environ["PROFILE_FRAME_ROWS"].split(","):
            session = fm.frame_session(dict(fm.BASE, **fm.CONFIGS[name]), model, grid, state, 8192, 1e-2, bakes)
            generator = torch.Generator(device=device).manual_seed(1)

            def render():
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                with torch.inference_mode():
                    session.render(frame_rays, generator)
                torch.cuda.synchronize(device)
                return (time.perf_counter() - t0) * 1e3

            render()  # warm-up: the captures, where the tree has graphs
            latencies = [render() for _ in range(FRAME_REPS)]
            graphs = getattr(session, "graphs", None)
            emit(f"frame 800 {name}", dict(latencies_ms=latencies, median_ms=statistics.median(latencies),
                                           **profile_train.profile_call(render, device), pool=session.last_pool,
                                           graph_replays=None if graphs is None else graphs.replays,
                                           graph_captures=None if graphs is None else graphs.captures))
            del session
        del bakes, model
        torch.cuda.empty_cache()
    view = CameraView.from_json(str(root / "0000.json"))
    runs = [(name, mode, bf16) for name, mode in cs.VANILLA_MODES.items() for bf16 in (True, False)]
    runs += [(name, mode, False) for name, mode in cs.NGP_MODES.items()]
    for name, mode, bf16 in runs if os.environ["PROFILE_RENDERS"] == "1" else []:
        argv = cs.mode_flags(root, mode, bf16) + [str(root / "metadata.json")]
        session = render_nerf.RenderSession(render_nerf.argparser().parse_args(argv))
        emit(name + (" --bf16" if bf16 else ""), profile_render.profile_view(session, view))
        del session
        torch.cuda.empty_cache()
finally:
    shutil.rmtree(root, ignore_errors=True)
'''


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="checkout roots (each with chip_smoke.py)")
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--out", type=str, default=None, help="also write the JSON lines here")
    parser.add_argument("--timeout", type=float, default=600, help="seconds a run may take")
    parser.add_argument("--repeats", type=int, default=16, help="timed train steps a run")
    parser.add_argument("--train_only", action="store_true", help="profile the train step, no render mode")
    parser.add_argument("--pooled", action="store_true", help="also profile bench_pooled's dense and pooled step")
    parser.add_argument("--hierarchy", action="store_true",
                        help="also profile the hierarchy's step of each chip_smoke.HIERARCHY_RUNS model and the "
                             "Ref-NeRF hybrid's occupancy step")
    parser.add_argument("--train_rates", action="store_true",
                        help="also time train_nerf's last steps, dense and pooled (chip_smoke's train flags)")
    parser.add_argument("--frames", default=None,
                        help="also time 800x800 frames of these comma-separated frame_matrix rows (for example "
                             "live_no_levers,baked384_p4,live_span)")
    args = parser.parse_args(argv)
    trees = [str(Path(t).resolve()) for t in args.trees]
    for tree in trees:
        if not (Path(tree) / "chip_smoke.py").exists():
            parser.error(f"{tree} holds no chip_smoke.py")
    steps_source = "\n\n".join([
        "from collections import defaultdict",
        f"HOST_API_CATEGORIES = {profile_render.HOST_API_CATEGORIES!r}",
        f"KERNEL_LAUNCH_CALLS = {profile_render.KERNEL_LAUNCH_CALLS!r}",
        f"LAUNCH_CALLS = {profile_render.LAUNCH_CALLS!r}",
        f"PORT_KERNELS = {profile_render.PORT_KERNELS!r}",
        f"KERNEL_ALIASES = {profile_render.KERNEL_ALIASES!r}",
        inspect.getsource(profile_render.port_kernel_of), inspect.getsource(profile_render.port_kernel_calls), inspect.getsource(profile_render.launch_records),
        inspect.getsource(profile_render.profile_call), inspect.getsource(profile_train.timed_launchers),
        inspect.getsource(profile_train.graph_pool_bytes), inspect.getsource(profile_train.profile_steps)])
    lines = []
    for turn in range(args.turns):
        for tree in trees if turn % 2 == 0 else trees[::-1]:
            env = dict(os.environ, PROFILE_TREE=tree, PROFILE_TURN=str(turn), PROFILE_STEPS_SOURCE=steps_source,
                       PROFILE_REPEATS=str(args.repeats), PROFILE_RENDERS="0" if args.train_only else "1",
                       PROFILE_POOLED="1" if args.pooled else "0", PROFILE_RATES="1" if args.train_rates else "0",
                       PROFILE_HIERARCHY="1" if args.hierarchy else "0",
                       PROFILE_FRAMES="1" if args.frames else "0", PROFILE_FRAME_ROWS=args.frames or "")
            proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env, capture_output=True,
                                  text=True, timeout=args.timeout)
            if proc.returncode != 0:
                raise SystemExit(f"profile run in {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            for line in proc.stdout.splitlines():
                if line.startswith("PROFILE "):
                    lines.append(line[len("PROFILE "):])
                    print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
