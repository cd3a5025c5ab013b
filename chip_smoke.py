#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (learn_nerf_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught; any failure exits
nonzero):

1. the card's name and power limit; build the CUDA kernels from
   ``learn_nerf_tpu_torch/csrc`` (one nvcc per source, in parallel; timed,
   with ptxas's resource report);
2. each kernel against its plain PyTorch version on the card at full width
   (fused_mlp on 2^20 points, fused_render on 8192 rays x 32 samples, and
   the edges of their persistent tile loops: fused_mlp at 1, 127, 128, 129
   and 2^20 - 37 points and on a hidden-40 model, fused_render at 1, 24,
   32 and 64 samples per ray with a last tile that is not full;
   table_gather at pallas_gather's own shape, [2^18, 2] f32 rows at
   999,424 indices, exactly, and at 1, 3, 4 and 5 indices with wrapped and
   NaN rows; the corner kernel at the 16-level fine schedule on 2^20
   points; the all-level encode kernel at the fine schedule on 2^20 points
   with unit-scale tables, at the 6-level coarse schedule, in smooth mode
   and at 1, 31, 32, 33 and 2^20 - 37 points, with the per-level route it
   replaced timed beside it), max abs error against the stated bound, both
   times, and each kernel's bound (the least time of its bytes at the HBM
   rate or of its operations at the peak rate of their type); ptxas must
   report no spills for the two MLP kernels;
3. a synthetic scene with a full-width vanilla checkpoint and a full-width
   Instant-NGP checkpoint (6 coarse and 16 fine hash-grid levels of 2^18
   rows) in the pickle contract (random weights from a NumPy seed, a 128^3
   occupancy grid with empty and occupied cells); the kernel route of each
   render mode (vanilla: hierarchy, occupancy; NGP: hierarchy, fixed-K
   occupancy, pooled) against the plain route on the CPU on a small view,
   with the same uniforms;
4. the port's ``serve_nerf`` in a thread, vanilla with ``--bf16`` in
   hierarchy and occupancy mode, and NGP in f32 (the CLI default) in
   hierarchy, occupancy and pooled mode (``--occ_budget_per_ray auto
   --occ_t_eps 1e-2``): three ``POST /render`` requests each at 256x256,
   each answered 200 with a PNG of that shape, with latencies;
5. every kernel of each mode launched during its serve phase (fused_mlp,
   fused_render, and the encode kernel in the three NGP modes), and no
   plain version called there.

It prints the card line and one JSON line of kernel results, then, as its
last line, ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits nonzero before printing any result.

    python3 chip_smoke.py --profile

adds, after phase 5, one JSON line per render mode and numerics mode
(vanilla hierarchy and occupancy, ``--bf16`` and f32; the three NGP modes
in f32) from ``learn_nerf_tpu_torch.scripts.profile_render`` on the same
scene and view size: median latency, one profiled render's device time,
idle share, top kernels and the port's own kernels' share.
"""

import argparse
import json
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from learn_nerf_tpu_torch.scripts.timing import cuda_ms, graph_ms

SEED = 0
MLP_POINTS = 1 << 20
RENDER_RAYS, RENDER_SAMPLES = 8192, 32
# Kernel vs plain version: the same bf16 rounding points, f32 sums in
# another order, so a bf16 rounding of an activation may flip and
# propagate through up to nine layers.  Each bound is about twice the
# error measured on an H100 at these inputs: 2.68e-3 (fused_mlp) and
# 2.25e-4 (fused_render, whose wide bins scale a flipped density).
MLP_BOUND = 5e-3
RENDER_BOUND = 5e-4
# fused_render's bins: up to 0.25 wide, a fifth of them padding (0), which
# puts each ray's optical depth at about 1-3 under the random weights
# (density ~0.6), as on the occupancy path.  At these depths a scan that
# is off by one sample (weight exp(-acc) in place of exp(-(acc - sig_dt)))
# moves the output by more than SCAN_MARGIN times RENDER_BOUND (measured
# 4.7e-2 on an H100, ~90 times); the check measures that and fails if it
# does not.
MAX_DELTA = 0.25
SCAN_MARGIN = 20
# The edges of the MLP kernels' persistent loops over 128-row tiles.
MLP_EDGE_ROWS = (1, 127, 128, 129, MLP_POINTS - 37)
RENDER_EDGE_SAMPLES = (1, 24, 32, 64)
# Peaks of one H100 SXM (NVIDIA's data sheet; dense, at the 700 W limit):
# bf16 tensor cores, f32 outside them, HBM3.  f32 operations per sample of
# fused_render's scan and composite: the product with delta, the running
# sum, the exclusive difference, two exponentials, 1 - exp, the weight, and
# three weighted sums.
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SCAN_OPS = 10
# Kernel route on the card vs plain route on the CPU through a whole frame,
# same uniforms: as above, plus the hierarchy's fine samples follow the
# coarse weights.  Measured on an H100: 8.7e-5 (hierarchy) and 3.0e-5
# (occupancy) for the bf16 vanilla model; 3.5e-6 to 4.3e-6 for the three
# f32 NGP modes, whose kernels move and index without rounding.
FRAME_BOUND = 1e-3
SIDE = 256
REQUESTS = 3
# pallas_gather's shape (tools/exp_gather.py): one NGP level, [2^18, 2] f32,
# gathered at 122 tiles of 8192 int32 indices.  Rows are moved, not summed:
# the kernel must equal index_select exactly, and its plain version at the
# edge lengths, NaN rows included.
GATHER_ROWS, GATHER_INDICES = 1 << 18, 999_424
GATHER_EDGE_INDICES = (1, 3, 4, 5)
# The NGP encoding at the fine schedule (16 levels of 2^18 rows, lattices
# 2^(4 + i//2)) on 2^20 points with unit-scale tables U(-1, 1), and at the
# edges of the encode kernel's grid of (point, level pair) threads, 8 to a
# warp's 32 lanes.  Indices and weights are bit-equal by design; the kernel
# sums the 8 weighted corners in corner order and the plain version in
# PyTorch's, so the two differ by rounding: 2.4e-7 measured on an H100, and
# the bound is about four times that.  A wrong index (the hash primes
# swapped; measured 1.97) must move the output by at least SCAN_MARGIN
# times it.
ENCODE_POINTS = 1 << 20
FINE_LEVELS, COARSE_LEVELS = 16, 6
ENCODE_BOUND = 1e-6
ENCODE_EDGE_POINTS = (1, 31, 32, 33, ENCODE_POINTS - 37)
# Mean density of the NGP checkpoint's fine field inside the ball (set
# through the density head's bias): rays crossing the occupied ball reach
# optical depth ~1-3.
NGP_DENSITY = 2.5
VANILLA_MODES = {"hierarchy": [], "occupancy": ["--occupancy"]}
NGP_MODES = {
    "ngp hierarchy": ["--instant_ngp"],
    "ngp occupancy": ["--instant_ngp", "--occupancy"],
    "ngp pooled": ["--instant_ngp", "--occupancy", "--occ_budget_per_ray", "auto",
                   "--occ_t_eps", "1e-2"],
}


def require(ok, message):
    if not ok:
        raise RuntimeError(message)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, flops=0.0, f32_ops=0.0):
    """(bound_ms, bound_by): the larger of the bytes' time at the HBM rate
    (each input read once, each output written once) and the operations'
    time at the peak rate of their type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (flops / BF16_FLOPS + f32_ops / F32_FLOPS) * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def ptxas_report(log):
    """``{kernel: (registers, spill bytes)}`` from ptxas's ``-v`` lines."""
    report, name, spills = {}, None, 0
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and name:
            spills = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            report[name] = (int(m.group(1)), spills)
            name = None
    return report


def flax_tree(rng, hidden=256, color=128, x_dim=60, d_dim=24):
    """Full-width vanilla ``Dense_i`` tree: lecun-normal kernels, small biases."""
    shapes = [(x_dim, hidden)] + [(hidden, hidden)] * 4
    shapes += [(hidden + x_dim, hidden)] + [(hidden, hidden)] * 3
    shapes += [(hidden, 1), (hidden + d_dim, color), (color, 3)]
    return {
        f"Dense_{i}": dict(
            kernel=(rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
            bias=(0.1 * rng.randn(s[1])).astype(np.float32),
        )
        for i, s in enumerate(shapes)
    }


def check_kernels(device, rng):
    from learn_nerf_tpu_torch.checkpoint import params_from_flax
    from learn_nerf_tpu_torch.kernels import fused_mlp as fm
    from learn_nerf_tpu_torch.kernels import fused_render as fr
    from learn_nerf_tpu_torch.models import NeRFModel

    model = NeRFModel(compute_dtype="bfloat16")
    model.load_state_dict(params_from_flax(flax_tree(rng)))
    model = model.to(device)
    packed = model.packed()
    # Multiply-adds per sample: every Dense layer's [in, out] (591,488).
    macs = sum(layer.weight.numel() for layer in model.dense_layers())

    uniform, unit, deltas_for = samplers(rng, device)
    weights = nbytes(packed.kernel_weights, packed.kernel_biases)
    results = []
    x, d = uniform(MLP_POINTS, 3, lo=-0.7, hi=0.7), unit(MLP_POINTS)
    out = fm.fused_mlp_cuda(packed, x, d)
    torch.cuda.synchronize()
    ref = fm.fused_mlp_reference(packed, x, d)
    require(torch.isfinite(out).all().item() and out.shape == (MLP_POINTS, 4),
            "fused_mlp produced non-finite values or the wrong shape")
    results.append(dict(
        name="fused_mlp", route="cuda", source="learn_nerf_tpu_torch/csrc/fused_nerf.cu",
        replaces="tools/pallas_recipe/fused_mlp.py:205",
        max_abs_err=(out - ref).abs().max().item(),
        ms=cuda_ms(lambda: fm.fused_mlp_cuda(packed, x, d), 20),
        plain_ms=cuda_ms(lambda: fm.fused_mlp_reference(packed, x, d), 5),
        flops=2.0 * macs * MLP_POINTS, nbytes=nbytes(x, d, out) + weights,
    ))
    del out, ref

    n, k = RENDER_RAYS, RENDER_SAMPLES
    points, dirs, deltas = uniform(n, k, 3, lo=-0.7, hi=0.7), unit(n), deltas_for(n, k)
    out = fr.fused_render_cuda(packed, points, dirs, deltas)
    torch.cuda.synchronize()
    ref = fr.fused_render_reference(packed, points, dirs, deltas)
    require(torch.isfinite(out).all().item() and out.shape == (n, 4),
            "fused_render produced non-finite values or the wrong shape")
    depth, shifted_err = shifted_scan(packed, points, dirs, deltas, ref)
    print(f"fused_render inputs: optical depth per ray median {depth.median().item():.3f}, "
          f"min {depth.min().item():.3f}, max {depth.max().item():.3f}; an off-by-one scan "
          f"moves the output by {shifted_err:.3e}", flush=True)
    require(shifted_err >= SCAN_MARGIN * RENDER_BOUND,
            f"fused_render's bound {RENDER_BOUND:g} would not catch an off-by-one scan")
    results.append(dict(
        name="fused_render", route="cuda", source="learn_nerf_tpu_torch/csrc/fused_nerf.cu",
        replaces="tools/pallas_recipe/fused_render.py:178",
        max_abs_err=(out - ref).abs().max().item(),
        ms=cuda_ms(lambda: fr.fused_render_cuda(packed, points, dirs, deltas), 20),
        plain_ms=cuda_ms(lambda: fr.fused_render_reference(packed, points, dirs, deltas), 5),
        flops=2.0 * macs * n * k, f32_ops=SCAN_OPS * n * k,
        nbytes=nbytes(points, dirs, deltas, out) + weights,
    ))
    for r in results:
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r["flops"], r.pop("f32_ops", 0.0))
        r["library_ms"] = None  # no one PyTorch call computes the fused chain
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["tflops"] = r.pop("flops") / r["ms"] / 1e9
    for r, limit in zip(results, (MLP_BOUND, RENDER_BOUND)):
        print(
            f"{r['name']}: max abs err {r['max_abs_err']:.3e} (bound {limit:g}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {100 * r['share_of_bound']:.1f} % of it, {r['tflops']:.1f} TFLOP/s",
            flush=True,
        )
        require(r["max_abs_err"] <= limit, f"{r['name']} disagrees with its plain version")
    # The edge cases draw from their own seed: the later phases see the same
    # weights and uniforms whether or not they run.
    check_edges(device, np.random.RandomState(SEED + 4), packed)
    return results


def samplers(rng, device):
    """Inputs on the card from ``rng``: uniform values, unit directions, and
    bin widths up to MAX_DELTA with a fifth of them padding (0)."""

    def uniform(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device)

    def unit(n):
        d = torch.from_numpy(rng.randn(n, 3).astype(np.float32)).to(device)
        return d / d.norm(dim=-1, keepdim=True)

    def deltas_for(n, k):
        return uniform(n, k, lo=0.0, hi=MAX_DELTA) * (uniform(n, k, lo=0.0, hi=1.0) < 0.8)

    return uniform, unit, deltas_for


def check_edges(device, rng, packed):
    """The MLP kernels where their persistent loops over 128-row tiles
    break: fused_mlp around one tile, just short of 2^20 points and on a
    hidden-40 model (padded to the kernel's widths); fused_render at each K
    with one ray in its last tile."""
    from learn_nerf_tpu_torch.checkpoint import params_from_flax
    from learn_nerf_tpu_torch.kernels import fused_mlp as fm
    from learn_nerf_tpu_torch.kernels import fused_render as fr
    from learn_nerf_tpu_torch.models import NeRFModel

    uniform, unit, deltas_for = samplers(rng, device)
    narrow = NeRFModel(hidden_dim=40, color_layer_dim=20, compute_dtype="bfloat16")
    narrow.load_state_dict(params_from_flax(flax_tree(rng, hidden=40, color=20)))
    cases = [(packed, m) for m in MLP_EDGE_ROWS] + [(narrow.to(device).packed(), 4099)]
    mlp_errs = []
    for p, m in cases:
        x, d = uniform(m, 3, lo=-0.7, hi=0.7), unit(m)
        out = fm.fused_mlp_cuda(p, x, d)
        torch.cuda.synchronize()
        require(out.shape == (m, 4) and torch.isfinite(out).all().item(),
                f"fused_mlp at {m} points: wrong shape or non-finite values")
        mlp_errs.append((out - fm.fused_mlp_reference(p, x, d)).abs().max().item())
    render_errs = []
    for k in RENDER_EDGE_SAMPLES:
        n = 128 // k * 50 + 1
        points, dirs, deltas = uniform(n, k, 3, lo=-0.7, hi=0.7), unit(n), deltas_for(n, k)
        out = fr.fused_render_cuda(packed, points, dirs, deltas)
        torch.cuda.synchronize()
        require(out.shape == (n, 4) and torch.isfinite(out).all().item(),
                f"fused_render at K = {k}: wrong shape or non-finite values")
        render_errs.append((out - fr.fused_render_reference(packed, points, dirs, deltas)).abs().max().item())
    rows = [f"{m}{' (hidden 40)' if p is not packed else ''}: {e:.2e}"
            for (p, m), e in zip(cases, mlp_errs)]
    print(f"fused_mlp edges, max abs err: {', '.join(rows)} (bound {MLP_BOUND:g})", flush=True)
    print("fused_render edges, max abs err: " + ", ".join(
        f"K {k} ({128 // k * 50 + 1} rays): {e:.2e}" for k, e in zip(RENDER_EDGE_SAMPLES, render_errs))
        + f" (bound {RENDER_BOUND:g})", flush=True)
    require(max(mlp_errs) <= MLP_BOUND, "fused_mlp disagrees with its plain version at an edge")
    require(max(render_errs) <= RENDER_BOUND, "fused_render disagrees with its plain version at an edge")


def shifted_scan(packed, points, dirs, deltas, ref):
    """Per-ray optical depth of the inputs, and how far the plain version
    moves from ``ref`` when its scan is off by one sample."""
    from learn_nerf_tpu_torch.kernels.fused_mlp import fused_mlp_reference

    n, k, _ = points.shape
    flat_dirs = dirs[:, None, :].expand(n, k, 3).reshape(-1, 3)
    out = fused_mlp_reference(packed, points.reshape(-1, 3), flat_dirs).reshape(n, k, 4)
    sig_dt = out[..., 0] * deltas
    acc = torch.cumsum(sig_dt, dim=1)
    weights = torch.exp(-acc) * (1.0 - torch.exp(-sig_dt))
    fg = torch.einsum("nk,nkc->nc", weights, out[..., 1:])
    return acc[:, -1], (fg - ref[:, :3]).abs().max().item()


def fine_schedule(levels):
    """Grid and table sizes of an NGP model's levels (scripts/common.py)."""
    return [2 ** (4 + i // 2) for i in range(levels)], [2**18] * levels


def check_hashgrid_kernels(device, rng):
    """table_gather at pallas_gather's shape and at its edges, the corner
    kernel at the fine schedule, then the all-level encode kernel at the
    fine and coarse schedules, in smooth mode and at the edges of its
    thread grid, each against its plain version."""
    from learn_nerf_tpu_torch.kernels import hashgrid as kh
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.kernels import table_gather as tg
    from learn_nerf_tpu_torch.ops import hashgrid as hg

    def on_card(a):
        return torch.from_numpy(a).to(device)

    table = on_card(rng.uniform(-1, 1, (GATHER_ROWS, 2)).astype(np.float32))
    idx = on_card(rng.randint(0, GATHER_ROWS, GATHER_INDICES).astype(np.int32))
    out = tg.table_gather_cuda(table, idx)
    torch.cuda.synchronize()
    err = max((out - table.index_select(0, idx)).abs().max().item(),
              (out - tg.table_gather_reference(table, idx)).abs().max().item())
    # The edges: M not a multiple of anything, with a wrapped index (-1)
    # and out-of-range ones (T, -T - 1), which give NaN rows.
    for m in GATHER_EDGE_INDICES:
        edge = rng.randint(0, GATHER_ROWS, m).astype(np.int32)
        edge[: min(m, 3)] = [-1, GATHER_ROWS, -GATHER_ROWS - 1][: min(m, 3)]
        edge = on_card(edge)
        got, want = tg.table_gather_cuda(table, edge), tg.table_gather_reference(table, edge)
        torch.cuda.synchronize()
        require(torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)),
                f"table_gather disagrees with its plain version at M = {m}")
    kernel, reference = (lambda: tg.table_gather_cuda(table, idx),
                         lambda: tg.table_gather_reference(table, idx))
    select = lambda: table.index_select(0, idx)
    gather = dict(
        name="table_gather", route="cuda", source="learn_nerf_tpu_torch/csrc/table_gather.cu",
        replaces="tools/exp_gather.py:64", max_abs_err=err,
        ms=graph_ms(kernel, 50), plain_ms=graph_ms(reference, 50),
    )
    select_ms = graph_ms(select, 50)
    gather["bound_ms"], gather["bound_by"] = bound(nbytes(table, idx, out))
    gather["library_ms"] = select_ms  # index_select, the one PyTorch call for it
    eager = [cuda_ms(fn, 200) for fn in (kernel, reference, select)]
    print(f"table_gather [{GATHER_ROWS}, 2] x {GATHER_INDICES}: max abs err {err:.3e} (bound 0), "
          f"equal at M = {GATHER_EDGE_INDICES} with wrapped and NaN rows; device time per call "
          f"(graph replay): kernel {gather['ms']:.4f} ms, plain {gather['plain_ms']:.4f} ms, "
          f"index_select {select_ms:.4f} ms; back-to-back eager calls: {eager[0]:.4f} / "
          f"{eager[1]:.4f} / {eager[2]:.4f} ms", flush=True)
    require(err == 0, "table_gather disagrees with index_select")

    grids, tables = fine_schedule(FINE_LEVELS)
    values = [on_card(rng.uniform(-1, 1, (hg.dense_level_rows(g, t), 2)).astype(np.float32))
              for g, t in zip(grids, tables)]
    bbox_min, bbox_max = (-0.7,) * 3, (0.7,) * 3
    x = on_card(rng.uniform(-0.75, 0.75, (ENCODE_POINTS, 3)).astype(np.float32))
    idx, w = kh.hashgrid_corners_cuda(x, grids, tables, bbox_min, bbox_max, False)
    torch.cuda.synchronize()
    ref_idx, ref_w = kh.hashgrid_corners_reference(x, grids, tables, bbox_min, bbox_max, False)
    differ = (idx != ref_idx).double().mean().item()
    corners = dict(
        name="hashgrid_corners", route="cuda", source="learn_nerf_tpu_torch/csrc/hashgrid.cu",
        replaces="learn_nerf_tpu/ops/hashgrid.py:43-99 (XLA)",
        max_abs_err=(w - ref_w).abs().max().item(),
        ms=cuda_ms(lambda: kh.hashgrid_corners_cuda(x, grids, tables, bbox_min, bbox_max, False), 20),
        plain_ms=cuda_ms(
            lambda: kh.hashgrid_corners_reference(x, grids, tables, bbox_min, bbox_max, False), 5),
        library_ms=None,
    )
    corners["bound_ms"], corners["bound_by"] = bound(nbytes(x, idx, w))
    del idx, w, ref_idx, ref_w
    print(f"hashgrid_corners {FINE_LEVELS} levels x {ENCODE_POINTS} points: share of indices "
          f"that differ {differ:.3e} (bound 0); max abs err of weights {corners['max_abs_err']:.3e} "
          f"(bound 0); kernel {corners['ms']:.4f} ms, plain {corners['plain_ms']:.4f} ms", flush=True)
    require(differ == 0 and corners["max_abs_err"] == 0, "hashgrid_corners disagrees with its plain version")

    encode = lambda: ke.hashgrid_encode_cuda(values, x, grids, tables, bbox_min, bbox_max, False)
    plain = lambda: hg.hash_grid_encode_reference(values, x, grids, tables, bbox_min, bbox_max)
    out, ref = encode(), plain()
    torch.cuda.synchronize()
    require(torch.isfinite(out).all().item() and out.shape == (ENCODE_POINTS, 2 * FINE_LEVELS),
            "the encode kernel's output is not finite or has the wrong shape")
    errs = {f"fine, {ENCODE_POINTS} points": (out - ref).abs().max().item()}
    # The same plain encoding with the hash primes swapped: a wrong index.
    primes = hg.HASH_PRIME_Y, hg.HASH_PRIME_Z
    hg.HASH_PRIME_Y, hg.HASH_PRIME_Z = primes[1], primes[0]
    try:
        wrong_err = (plain() - ref).abs().max().item()
    finally:
        hg.HASH_PRIME_Y, hg.HASH_PRIME_Z = primes
    del out, ref
    errs.update(encode_cases(values, x, grids, tables, bbox_min, bbox_max, device, rng))
    # Points along rays (128 samples 0.01 apart on each of 8192 rays), as a
    # frame feeds them: neighbouring points share cells in the coarse levels.
    origins = rng.uniform(-0.7, 0.7, (ENCODE_POINTS // 128, 1, 3))
    dirs = rng.randn(ENCODE_POINTS // 128, 1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ray_x = on_card((origins + 0.01 * dirs * np.arange(128)[:, None]).reshape(-1, 3).astype(np.float32))

    def per_level():
        # The route the encode kernel replaced, from the kernels that remain:
        # corners, one table_gather per level, the weighted sums and cat.
        idx, w = kh.hashgrid_corners_cuda(x, grids, tables, bbox_min, bbox_max, False)
        return torch.cat([hg.interpolate(w[level], tg.table_gather_cuda(v, idx[level].reshape(-1))
                                         .view(len(x), 8, v.shape[1]))
                          for level, v in enumerate(values)], dim=-1)

    enc = dict(
        name="hashgrid_encode", route="cuda", source="learn_nerf_tpu_torch/csrc/hashgrid_encode.cu",
        replaces="learn_nerf_tpu/ops/hashgrid.py:135 (XLA)", max_abs_err=max(errs.values()),
        ms=cuda_ms(encode, 20), plain_ms=cuda_ms(plain, 3), library_ms=None,
    )
    route_ms = cuda_ms(per_level, 5)
    ray_ms = cuda_ms(lambda: ke.hashgrid_encode_cuda(values, ray_x, grids, tables, bbox_min, bbox_max,
                                                     False), 20)
    out_bytes = ENCODE_POINTS * 2 * FINE_LEVELS * 4
    enc["bound_ms"], enc["bound_by"] = bound(nbytes(x, *values) + out_bytes)
    # What the kernel really pulls from L2: one 32-byte sector per corner row.
    l2_gb = ENCODE_POINTS * FINE_LEVELS * 8 * 32 / 1e9
    print(f"hashgrid_encode {FINE_LEVELS} levels x {ENCODE_POINTS} points: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bound {ENCODE_BOUND:g}); swapped hash primes move the plain route by {wrong_err:.3e}; "
          f"kernel {enc['ms']:.4f} ms ({ray_ms:.4f} ms on points along rays), plain "
          f"{enc['plain_ms']:.4f} ms, the per-level route (corners + {FINE_LEVELS} table_gather + "
          f"sums + cat) {route_ms:.4f} ms; L2 sectors of its corner rows {l2_gb:.2f} GB, "
          f"{l2_gb / enc['ms']:.2f} TB/s", flush=True)
    require(enc["max_abs_err"] <= ENCODE_BOUND, "the encode kernel disagrees with its plain version")
    require(wrong_err >= SCAN_MARGIN * ENCODE_BOUND,
            f"the encoding's bound {ENCODE_BOUND:g} would not catch a wrong hash index")
    require(enc["ms"] <= route_ms, "the encode kernel is slower than the per-level route")
    return [gather, corners, enc]


def encode_cases(values, x, grids, tables, bbox_min, bbox_max, device, rng):
    """The encode kernel against its plain version at the coarse schedule,
    in smooth mode and at the edges of its thread grid; ``{case: error}``."""
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.ops import hashgrid as hg

    coarse = COARSE_LEVELS
    cases = [(f"coarse, {len(x)} points", values[:coarse], x, grids[:coarse], tables[:coarse], False),
             (f"smooth, {len(x)} points", values, x, grids, tables, True)]
    cases += [(f"{n} points", values, x[-n:].contiguous(), grids, tables, False) for n in ENCODE_EDGE_POINTS]
    errs = {}
    for name, vals, pts, g, t, smooth in cases:
        out = ke.hashgrid_encode_cuda(vals, pts, g, t, bbox_min, bbox_max, smooth)
        torch.cuda.synchronize()
        ref = hg.hash_grid_encode_reference(vals, pts, g, t, bbox_min, bbox_max, smooth)
        require(out.shape == ref.shape and torch.isfinite(out).all().item(),
                f"the encode kernel ({name}): wrong shape or non-finite values")
        errs[name] = (out - ref).abs().max().item()
    return errs


def ngp_tree(rng, levels):
    """Full-width NGP tree in flax's layout: unit-scale tables, lecun-normal
    ``Dense_i`` kernels (64 wide, density_dim 16, 2 color layers, d_freqs
    4), small biases."""
    grids, tables = fine_schedule(levels)
    shapes = [(2 * levels, 64), (64, 16), (24 + 16, 64), (64, 64), (64, 3)]
    tree = {
        f"Dense_{i}": dict(
            kernel=(rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
            bias=(0.1 * rng.randn(s[1])).astype(np.float32),
        )
        for i, s in enumerate(shapes)
    }
    tree["HashGridEncoding_0"] = {
        f"table_{i}": rng.uniform(-1, 1, (min(g**3, t), 2)).astype(np.float32)
        for i, (g, t) in enumerate(zip(grids, tables))
    }
    return tree


def set_density_bias(tree, levels, rng):
    """Shift the density head's bias so the field's mean density in the
    ball (radius 0.45) is ``NGP_DENSITY``; returns the bias."""
    from learn_nerf_tpu_torch.checkpoint import ngp_params_from_flax
    from learn_nerf_tpu_torch.models import InstantNGPModel

    grids, tables = fine_schedule(levels)
    model = InstantNGPModel(table_sizes=tables, grid_sizes=grids, bbox_min=(-0.7,) * 3,
                            bbox_max=(0.7,) * 3)
    tree["Dense_1"]["bias"][0] = 0.0
    model.load_state_dict(ngp_params_from_flax(tree))
    x = rng.uniform(-0.45, 0.45, (16384, 3)).astype(np.float32)
    x = x[(x**2).sum(-1) < 0.45**2]
    with torch.inference_mode():
        raw = model(torch.from_numpy(x), torch.zeros(x.shape), spatial_only=True)[:, 0]
    bias = float(np.log(NGP_DENSITY) - np.log(torch.exp(raw).mean().item()))
    tree["Dense_1"]["bias"][0] = bias
    return bias


def write_scene(root, rng):
    """metadata.json, three orbit views, and a full-width checkpoint."""
    from learn_nerf_tpu_torch.checkpoint import save_params_pickle
    from learn_nerf_tpu_torch.data.camera import CameraView

    (root / "metadata.json").write_text(json.dumps({"min": [-0.7] * 3, "max": [0.7] * 3}))
    views = []
    for i in range(REQUESTS):
        theta = 2 * np.pi * i / REQUESTS
        z = -np.array([np.cos(theta), np.sin(theta), 0.3])
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        view = CameraView(tuple(z.tolist()), tuple((-2.0 * z).tolist()),
                          tuple(x.tolist()), tuple(y.tolist()), 1.0, 1.0)
        (root / f"{i:04}.json").write_text(view.to_json())
        views.append(view)
    # Occupied: a ball of radius 0.45 around the origin; empty elsewhere.
    res = 128
    centers = (np.arange(res, dtype=np.float32) + 0.5) / res * 1.4 - 0.7
    zz, yy, xx = np.meshgrid(centers, centers, centers, indexing="ij")  # x fastest
    ball = (xx**2 + yy**2 + zz**2 < 0.45**2).reshape(-1)
    params = dict(
        coarse=flax_tree(rng), fine=flax_tree(rng),
        background=np.array([1.0, 1.0, 1.0], np.float32),
        occupancy_densities=np.where(ball, 5.0, 0.0).astype(np.float32),
        occupancy_resolution=res,
    )
    save_params_pickle(str(root / "nerf.pkl"), params)
    print(f"occupancy grid: {ball.mean():.3f} of {res}^3 cells occupied", flush=True)

    # The NGP checkpoint draws from its own seed: the vanilla phases see
    # the same weights and uniforms whether or not the NGP phases run.
    ngp_rng = np.random.RandomState(SEED + 1)
    coarse, fine = ngp_tree(ngp_rng, COARSE_LEVELS), ngp_tree(ngp_rng, FINE_LEVELS)
    biases = [set_density_bias(tree, levels, ngp_rng)
              for tree, levels in ((coarse, COARSE_LEVELS), (fine, FINE_LEVELS))]
    save_params_pickle(str(root / "ngp.pkl"), dict(
        params, coarse=coarse, fine=fine,
    ))
    print(f"NGP checkpoint: {COARSE_LEVELS} + {FINE_LEVELS} levels, density bias "
          f"{biases[0]:.4f} (coarse) / {biases[1]:.4f} (fine) for mean density "
          f"{NGP_DENSITY:g} in the ball", flush=True)
    return views


def check_frames(root, views, device, rng, modes, bf16):
    """The kernel route (card) against the plain route (CPU) on a 16x16
    view through each mode's frame renderer, with the same uniforms (and,
    for a pooled mode, the same budget, resolved on the CPU)."""
    from learn_nerf_tpu_torch.occ_render import render_frame_occupancy, resolve_auto_budget
    from learn_nerf_tpu_torch.render import render_frame
    from learn_nerf_tpu_torch.scripts import render_nerf

    rays = torch.from_numpy(views[0].bare_rays(16, 16))
    for name, mode in modes.items():
        argv = [*(["--bf16"] if bf16 else []), "--model_path", str(root / checkpoint_name(mode)),
                *mode, str(root / "metadata.json")]
        args = render_nerf.argparser().parse_args(argv)
        sessions = [render_nerf.RenderSession(args, device=dev) for dev in (device, torch.device("cpu"))]
        r = sessions[0].renderer
        occupancy = "--occupancy" in mode
        if occupancy:
            u = torch.from_numpy(rng.rand(1, 256, r.candidates).astype(np.float32))
        else:
            u = [(torch.from_numpy(rng.rand(256, r.coarse_ts).astype(np.float32)),
                  torch.from_numpy(rng.rand(256, r.fine_ts).astype(np.float32)))]
        cpu = sessions[1]
        budget = None
        if args.occ_budget_per_ray == "auto":
            budget = resolve_auto_budget(cpu.renderer, cpu.grid_state, rays, args.occ_t_eps, quiet=True)
        outs = []
        for s in sessions:
            dev = s.device
            with torch.inference_mode():
                if occupancy:
                    out = render_frame_occupancy(
                        s.renderer, rays.to(dev), s.background, s.grid_state, tile_size=256,
                        transmittance_eps=args.occ_t_eps, uniforms=u.to(dev), budget_per_ray=budget)
                else:
                    out = render_frame(s.renderer, rays.to(dev), s.background, tile_size=256,
                                       uniforms=[(a.to(dev), b.to(dev)) for a, b in u])
            outs.append(out["outputs"].cpu())
        err = (outs[0] - outs[1]).abs().max().item()
        extra = f"; pool budget {budget} samples/ray, dropped {int(out['dropped'])}" if budget else ""
        print(f"{name} frame, kernel route vs plain route: max abs err {err:.3e} "
              f"(bound {FRAME_BOUND:g}){extra}", flush=True)
        if occupancy and budget is None and "--instant_ngp" in mode:
            with torch.inference_mode():
                ref, _ = cpu.renderer.render_rays(rays, cpu.background, cpu.grid_state, u=u[0])
            depth = -torch.log(ref["weights"][:, -1])
            depth = depth[depth > 1e-3]
            print(f"{name} inputs: optical depth of the {depth.numel()} rays that cross the ball: "
                  f"median {depth.median().item():.3f}, min {depth.min().item():.3f}, "
                  f"max {depth.max().item():.3f}", flush=True)
        require(torch.isfinite(outs[0]).all().item(), f"{name} frame is not finite")
        require(err <= FRAME_BOUND, f"{name} kernel route disagrees with the plain route")
        require(outs[0].std().item() > 1e-3, f"{name} frame is flat")


def png_size(body):
    require(body[:8] == b"\x89PNG\r\n\x1a\n", "response is not a PNG")
    width, height = struct.unpack(">II", body[16:24])
    return height, width


def checkpoint_name(mode):
    return "ngp.pkl" if "--instant_ngp" in mode else "nerf.pkl"


def mode_flags(root, mode, bf16):
    """Render flags of one mode: tiles of 4096 rays (hierarchy) or 8192
    (occupancy), ``SIDE`` x ``SIDE`` views."""
    batch = "8192" if "--occupancy" in mode else "4096"
    return ["--seed", str(SEED), *(["--bf16"] if bf16 else []), "--batch_size", batch,
            "--width", str(SIDE), "--height", str(SIDE),
            "--model_path", str(root / checkpoint_name(mode)), *mode]


def profile_modes(root):
    """One profile_render line per render mode and numerics mode."""
    from learn_nerf_tpu_torch.data.camera import CameraView
    from learn_nerf_tpu_torch.scripts import profile_render, render_nerf

    view = CameraView.from_json(str(root / "0000.json"))
    runs = [(name, mode, bf16) for name, mode in VANILLA_MODES.items() for bf16 in (True, False)]
    runs += [(name, mode, False) for name, mode in NGP_MODES.items()]
    for name, mode, bf16 in runs:
        argv = mode_flags(root, mode, bf16) + [str(root / "metadata.json")]
        session = render_nerf.RenderSession(render_nerf.argparser().parse_args(argv))
        result = profile_render.profile_view(session, view)
        label = dict(mode=name, bf16=bf16, side=SIDE)
        print("profile:", json.dumps({**label, **result}), flush=True)
        del session
        torch.cuda.empty_cache()


def serve_mode(root, name, mode, bf16):
    """Serve, send the requests, return ``{kernel: (launches, plain
    calls)}`` of the serve phase."""
    from learn_nerf_tpu_torch.kernels import fused_mlp as fm
    from learn_nerf_tpu_torch.kernels import fused_render as fr
    from learn_nerf_tpu_torch.kernels import hashgrid as kh
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.kernels import table_gather as tg
    from learn_nerf_tpu_torch.scripts import serve_nerf

    counters = dict(fused_mlp=fm.counter, fused_render=fr.counter, table_gather=tg.counter,
                    hashgrid_corners=kh.counter, hashgrid_encode=ke.counter)
    argv = mode_flags(root, mode, bf16) + ["--port", "0", str(root / "metadata.json")]
    server = serve_nerf.make_server(serve_nerf.argparser().parse_args(argv))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    latencies = []
    try:
        for c in counters.values():
            c.reset()
        for i in range(REQUESTS):
            body = (root / f"{i:04}.json").read_bytes()
            req = urllib.request.Request(f"http://{host}:{port}/render", data=body, method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, ctype, png = resp.status, resp.headers.get("Content-Type"), resp.read()
            latencies.append((time.perf_counter() - t0) * 1e3)
            require(status == 200 and ctype == "image/png", f"request {i}: {status} {ctype}")
            require(png_size(png) == (SIDE, SIDE), f"request {i}: PNG is {png_size(png)}")
        counts = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
        frames = getattr(server.session, "frames", None)
        pool = frames.last_pool if frames is not None else None
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    pool_note = f"; last frame's pool {pool}" if pool else ""
    print(f"serve {name}{' --bf16' if bf16 else ''} {SIDE}x{SIDE}: latencies ms "
          f"{[round(v, 3) for v in latencies]}; (launches, plain calls) {counts}{pool_note}",
          flush=True)
    require(all(plain == 0 for _, plain in counts.values()),
            f"{name} serving called a plain version: {counts}")
    return counts


def main():
    parser = argparse.ArgumentParser(description="Smoke test of the port on one card.")
    parser.add_argument("--profile", action="store_true",
                        help="also profile one render per mode (see the module doc)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card", file=sys.stderr)
        return 2

    from learn_nerf_tpu_torch.kernels import build
    from learn_nerf_tpu_torch.scripts.common import default_device

    device = default_device()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s", flush=True)
    log = (build.library_dir() / "build.log").read_text()
    report = ptxas_report(log)
    for name, (registers, spills) in report.items():
        print(f"  ptxas: {name}: {registers} registers, {spills} bytes spilled", flush=True)
    print(f"  ptxas: {log.count('warpgroup.arrive is injected')} wgmma fences added by the "
          f"compiler", flush=True)
    for kernel in ("fused_mlp_kernel", "fused_render_kernel"):
        spills = [v[1] for k, v in report.items() if kernel in k]
        require(spills == [0], f"ptxas reports spills for {kernel}: {spills}")

    rng = np.random.RandomState(SEED)
    kernels = check_kernels(device, rng)
    kernels += check_hashgrid_kernels(device, np.random.RandomState(SEED + 3))
    torch.cuda.empty_cache()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build.BUILD_DIR) as tmp:
        root = Path(tmp)
        views = write_scene(root, rng)
        check_frames(root, views, device, rng, VANILLA_MODES, bf16=True)
        check_frames(root, views, device, np.random.RandomState(SEED + 2), NGP_MODES, bf16=False)
        served = {name: serve_mode(root, name, mode, bf16=True) for name, mode in VANILLA_MODES.items()}
        served.update({name: serve_mode(root, name, mode, bf16=False) for name, mode in NGP_MODES.items()})
        if args.profile:
            profile_modes(root)

    # Each mode's kernels ran in its serve phase (serve_mode holds that no
    # plain version ran there).
    require(served["hierarchy"]["fused_mlp"][0] > 0, "hierarchy serving never launched fused_mlp")
    require(served["occupancy"]["fused_render"][0] > 0, "occupancy serving never launched fused_render")
    for name in NGP_MODES:
        require(served[name]["hashgrid_encode"][0] > 0, f"{name} serving never launched hashgrid_encode")
    for k in kernels:
        k["launches"] = sum(counts[k["name"]][0] for counts in served.values())
    ordered = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
               "bound_ms", "bound_by", "library_ms", "share_of_bound", "tflops"]
    for k in kernels:
        k.setdefault("share_of_bound", k["bound_ms"] / k["ms"])
    print(card)
    print(json.dumps({"kernels": [{key: k[key] for key in ordered if key in k} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
