"""Adam's forms on the occupancy loop, on the card: what an Adam step costs,
and how each form moves the run-to-run noise of training.

    python -m learn_nerf_tpu_torch.scripts.adam_ablations --cost
    python -m learn_nerf_tpu_torch.scripts.adam_ablations --pairs 16 \\
        --adams foreach capturable fused --trees PARENT_CHECKOUT

``--cost``: one Adam step on the leaves of ``train_nerf``'s Instant-NGP (16
levels of 2^18 rows, its Adam settings) with random gradients, for each
form: ``foreach`` (a float lr: the loops' Adam), ``capturable`` (foreach,
its step counts on the card, the bias corrections f32 device ops: the form
a CUDA graph can capture) and ``fused`` (fused and capturable): the
kernels one step launches (``torch.profiler``) and its ms (CUDA events over
50 steps back to back, host time included).

``--pairs N``: ``chip_smoke.py``'s phase-6 pair (``train_nerf`` dense,
then pooled with ``--occ_train_budget auto`` from step 36 and
``--steps_per_dispatch 8``, 96 steps each at ``bench_occupancy``'s width on
its train scene, both scored by ``eval_psnr`` on its two held-out views)
``N`` times for each form of ``--adams`` (a fresh process each, the loops'
Adam swapped for the form), and ``N`` times in each checkout of
``--trees`` with its own Adam.  Prints one JSON line a pair and one summary
line a form: the pooled run's PSNR shortfall against the dense run's (what
``chip_smoke.py`` bounds by ``POOLED_PSNR_SHORTFALL``), its mean, standard
deviation, least and largest.  Only the hashgrid_backward kernel's atomics
tell the pairs apart, so the spread is the training's own noise.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# Runs in a checkout's root: only that checkout's code is imported.
RUN = r'''
import contextlib, io, json, os, sys, tempfile
from pathlib import Path
import numpy as np
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from learn_nerf_tpu_torch.kernels import build

form = os.environ["ADAM_FORM"]
adam = torch.optim.Adam
if form == "capturable":
    torch.optim.Adam = lambda params, **kw: adam(params, **dict(kw, capturable=True))
elif form == "fused":
    torch.optim.Adam = lambda params, foreach=None, **kw: adam(params, fused=True, capturable=True, **kw)
build.library()
build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
with tempfile.TemporaryDirectory(prefix="adam_", dir=build.BUILD_DIR) as tmp:
    root = Path(tmp)
    with contextlib.redirect_stdout(io.StringIO()):
        cs.write_train_scene(root / "train", np.random.RandomState(cs.SEED + 7))
        cs.write_train_scene(root / "heldout", np.random.RandomState(cs.SEED + 10), views=cs.HELDOUT_VIEWS)
    flags = ["--instant_ngp", "--occupancy", "--seed", str(cs.SEED), "--lr", "1e-2",
             "--batch_size", str(cs.TRAIN_RAYS), "--occ_warmup", str(cs.TRAIN_WARMUP)]
    pooled = [*flags, "--occ_train_budget", "auto", "--occ_train_budget_start", str(cs.POOL_START),
              "--steps_per_dispatch", "8"]
    for pair in range(int(os.environ["ADAM_PAIRS"])):
        with contextlib.redirect_stdout(io.StringIO()):
            cs.train_run(root, "train", flags, "dense.pkl")
            cs.train_run(root, "train pooled", pooled, "pooled.pkl")
            dense, pool = (cs.evaluate(root, name)[0] for name in ("dense.pkl", "pooled.pkl"))
        for name in ("dense.pkl", "pooled.pkl"):  # train_nerf would resume from them
            (root / name).unlink()
        print("PAIR " + json.dumps(dict(tree=os.getcwd(), adam=form, pair=pair, dense=dense, pooled=pool,
                                        shortfall=dense - pool)), flush=True)
'''

FORMS = {
    "foreach": dict(foreach=True),
    "capturable": dict(foreach=True, capturable=True),
    "fused": dict(fused=True, capturable=True),
}


def adam_cost(forms, steps=50) -> dict:
    """Kernels and ms of one Adam step of each form on the NGP's leaves."""
    import types

    import torch

    from .common import create_model, default_device
    from .train_nerf import build_parser

    device = default_device()
    args = build_parser().parse_args(["--instant_ngp", "--occupancy", "."])
    _, fine, train_kwargs = create_model(args, types.SimpleNamespace(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3))
    settings = dict(betas=(train_kwargs.get("adam_b1", 0.9), train_kwargs.get("adam_b2", 0.999)),
                    eps=train_kwargs.get("adam_eps", 1e-7))
    leaves = [p.detach().to(device) for p in fine.parameters()]
    generator = torch.Generator(device=device).manual_seed(0)
    out = {}
    for form in forms:
        params = [p.clone().requires_grad_(True) for p in leaves]
        for p in params:
            p.grad = torch.randn(p.shape, generator=generator, device=device) * 1e-3
        opt = torch.optim.Adam(params, lr=1e-2, **settings, **FORMS[form])
        for _ in range(5):
            opt.step()
        torch.cuda.synchronize(device)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            opt.step()
            torch.cuda.synchronize(device)
        kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            opt.step()
        end.record()
        torch.cuda.synchronize(device)
        out[form] = dict(kernels=kernels, ms=start.elapsed_time(end) / steps)
    return out


def pairs(n, forms, trees, timeout=1800):
    """The phase-6 pair ``n`` times for each form here and each checkout of
    ``trees``; returns every pair's line."""
    here = Path(__file__).resolve().parents[2]
    runs = [(form, here) for form in forms] + [("own", Path(t).resolve()) for t in trees]
    lines = []
    for form, tree in runs:
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True, text=True, timeout=timeout,
                              env=dict(os.environ, ADAM_FORM=form, ADAM_PAIRS=str(n)))
        if proc.returncode != 0:
            raise SystemExit(f"the pairs with Adam {form} in {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("PAIR "):
                lines.append(json.loads(line[len("PAIR "):]))
                print(json.dumps(lines[-1]), flush=True)
        shortfalls = [r["shortfall"] for r in lines if r["adam"] == form and r["tree"] == str(tree)]
        print(json.dumps(dict(tree=str(tree), adam=form, pairs=len(shortfalls),
                              mean=statistics.mean(shortfalls), std=statistics.stdev(shortfalls),
                              least=min(shortfalls), largest=max(shortfalls))), flush=True)
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cost", action="store_true", help="time one Adam step of each form")
    parser.add_argument("--pairs", type=int, default=0, help="phase-6 pairs for each form and checkout")
    parser.add_argument("--adams", nargs="+", choices=sorted(FORMS), default=["foreach"])
    parser.add_argument("--trees", nargs="*", default=[], help="other checkouts, each with its own Adam")
    args = parser.parse_args(argv)
    if args.cost:
        print(json.dumps({"adam_cost": adam_cost(args.adams)}), flush=True)
    if args.pairs:
        pairs(args.pairs, args.adams, args.trees)


if __name__ == "__main__":
    main()
