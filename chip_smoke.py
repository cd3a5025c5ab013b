#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (learn_nerf_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught; any failure exits
nonzero):

1. the card's name and power limit; build the CUDA kernels from
   ``learn_nerf_tpu_torch/csrc`` (timed, with ptxas's resource report);
2. each kernel against its plain PyTorch version on the card at full width
   (fused_mlp on 2^20 points, fused_render on 8192 rays x 32 samples):
   max abs error against the stated bound, and both times;
3. a synthetic scene and a full-width vanilla checkpoint in the pickle
   contract (random weights from a NumPy seed, a 128^3 occupancy grid with
   empty and occupied cells); the kernel route of both render modes
   against the plain route on the CPU on a small view, with the same
   uniforms;
4. the port's ``serve_nerf`` with ``--bf16`` in a thread, once in hierarchy
   mode and once with ``--occupancy``: three ``POST /render`` requests each
   at 256x256, each answered 200 with a PNG of that shape, with latencies;
5. every kernel of each mode launched during its serve phase, and no plain
   version called there.

It prints the card line and one JSON line of kernel results, then, as its
last line, ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits nonzero before printing any result.

    python3 chip_smoke.py --profile

adds, after phase 5, one JSON line per render mode and numerics mode
(hierarchy and occupancy, ``--bf16`` and f32) from
``learn_nerf_tpu_torch.scripts.profile_render`` on the same scene and view
size: median latency, one profiled render's device time, idle share and
top kernels.
"""

import argparse
import json
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
# Kernel route on the card vs plain route on the CPU through a whole frame,
# same uniforms: as above, plus the hierarchy's fine samples follow the
# coarse weights.  Measured 8.7e-5 (hierarchy) and 3.0e-5 (occupancy).
FRAME_BOUND = 1e-3
SIDE = 256
REQUESTS = 3


def require(ok, message):
    if not ok:
        raise RuntimeError(message)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    fn()  # warm up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    packed = model.to(device).packed()

    def uniform(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device)

    def unit(n):
        d = torch.from_numpy(rng.randn(n, 3).astype(np.float32)).to(device)
        return d / d.norm(dim=-1, keepdim=True)

    results = []
    x, d = uniform(MLP_POINTS, 3, lo=-0.7, hi=0.7), unit(MLP_POINTS)
    out = fm.fused_mlp_cuda(packed, x, d)
    torch.cuda.synchronize()
    ref = fm.fused_mlp_reference(packed, x, d)
    require(torch.isfinite(out).all().item(), "fused_mlp produced non-finite values")
    results.append(dict(
        name="fused_mlp", route="cuda", source="learn_nerf_tpu_torch/csrc/fused_nerf.cu",
        replaces="tools/pallas_recipe/fused_mlp.py:205",
        max_abs_err=(out - ref).abs().max().item(),
        ms=cuda_ms(lambda: fm.fused_mlp_cuda(packed, x, d), 20),
        plain_ms=cuda_ms(lambda: fm.fused_mlp_reference(packed, x, d), 5),
    ))

    n, k = RENDER_RAYS, RENDER_SAMPLES
    points, dirs = uniform(n, k, 3, lo=-0.7, hi=0.7), unit(n)
    deltas = uniform(n, k, lo=0.0, hi=MAX_DELTA) * (uniform(n, k, lo=0.0, hi=1.0) < 0.8)
    out = fr.fused_render_cuda(packed, points, dirs, deltas)
    torch.cuda.synchronize()
    ref = fr.fused_render_reference(packed, points, dirs, deltas)
    require(torch.isfinite(out).all().item(), "fused_render produced non-finite values")
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
    ))
    for r, bound in zip(results, (MLP_BOUND, RENDER_BOUND)):
        print(
            f"{r['name']}: max abs err {r['max_abs_err']:.3e} (bound {bound:g}); "
            f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms",
            flush=True,
        )
        require(r["max_abs_err"] <= bound, f"{r['name']} disagrees with its plain version")
    return results


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
    return views


def check_frames(root, views, device, rng):
    """The kernel route (card) against the plain route (CPU) on a 16x16
    view through both frame renderers, with the same uniforms."""
    from learn_nerf_tpu_torch.occ_render import render_frame_occupancy
    from learn_nerf_tpu_torch.render import render_frame
    from learn_nerf_tpu_torch.scripts import render_nerf

    rays = torch.from_numpy(views[0].bare_rays(16, 16))
    for mode in ([], ["--occupancy"]):
        argv = ["--bf16", "--model_path", str(root / "nerf.pkl"), *mode, str(root / "metadata.json")]
        args = render_nerf.argparser().parse_args(argv)
        sessions = [render_nerf.RenderSession(args, device=dev) for dev in (device, torch.device("cpu"))]
        r = sessions[0].renderer
        if mode:
            u = torch.from_numpy(rng.rand(1, 256, r.candidates).astype(np.float32))
        else:
            u = [(torch.from_numpy(rng.rand(256, r.coarse_ts).astype(np.float32)),
                  torch.from_numpy(rng.rand(256, r.fine_ts).astype(np.float32)))]
        outs = {}
        for s in sessions:
            dev = s.device
            with torch.inference_mode():
                if mode:
                    out = render_frame_occupancy(s.renderer, rays.to(dev), s.background, s.grid_state,
                                                 tile_size=256, uniforms=u.to(dev))
                else:
                    out = render_frame(s.renderer, rays.to(dev), s.background, tile_size=256,
                                       uniforms=[(a.to(dev), b.to(dev)) for a, b in u])
            outs[dev.type] = out["outputs"].cpu()
        err = (outs["cuda"] - outs["cpu"]).abs().max().item()
        name = "occupancy" if mode else "hierarchy"
        print(f"{name} frame, kernel route vs plain route: max abs err {err:.3e} "
              f"(bound {FRAME_BOUND:g})", flush=True)
        require(torch.isfinite(outs["cuda"]).all().item(), f"{name} frame is not finite")
        require(err <= FRAME_BOUND, f"{name} kernel route disagrees with the plain route")
        require(outs["cuda"].std().item() > 1e-3, f"{name} frame is flat")


def png_size(body):
    require(body[:8] == b"\x89PNG\r\n\x1a\n", "response is not a PNG")
    width, height = struct.unpack(">II", body[16:24])
    return height, width


def mode_flags(root, mode, bf16):
    """Render flags of one mode: tiles of 4096 rays (hierarchy) or 8192
    (occupancy), ``SIDE`` x ``SIDE`` views."""
    batch = "8192" if mode else "4096"
    return ["--seed", str(SEED), *(["--bf16"] if bf16 else []), "--batch_size", batch,
            "--width", str(SIDE), "--height", str(SIDE), "--model_path", str(root / "nerf.pkl"),
            *mode]


def profile_modes(root):
    """One profile_render line per render mode and numerics mode."""
    from learn_nerf_tpu_torch.data.camera import CameraView
    from learn_nerf_tpu_torch.scripts import profile_render, render_nerf

    view = CameraView.from_json(str(root / "0000.json"))
    for mode in ([], ["--occupancy"]):
        for bf16 in (True, False):
            argv = mode_flags(root, mode, bf16) + [str(root / "metadata.json")]
            session = render_nerf.RenderSession(render_nerf.argparser().parse_args(argv))
            result = profile_render.profile_view(session, view)
            label = dict(mode="occupancy" if mode else "hierarchy", bf16=bf16, side=SIDE)
            print("profile:", json.dumps({**label, **result}), flush=True)
            del session
            torch.cuda.empty_cache()


def serve_mode(root, mode):
    """Serve, send the requests, return (latencies ms, counters)."""
    from learn_nerf_tpu_torch.kernels import fused_mlp as fm
    from learn_nerf_tpu_torch.kernels import fused_render as fr
    from learn_nerf_tpu_torch.scripts import serve_nerf

    argv = mode_flags(root, mode, bf16=True) + ["--port", "0", str(root / "metadata.json")]
    server = serve_nerf.make_server(serve_nerf.argparser().parse_args(argv))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    latencies = []
    try:
        for c in (fm.counter, fr.counter):
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
        counts = {c_name: (c.launches, c.plain_calls) for c_name, c in
                  (("fused_mlp", fm.counter), ("fused_render", fr.counter))}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    name = "occupancy" if mode else "hierarchy"
    print(f"serve {name} --bf16 {SIDE}x{SIDE}: latencies ms "
          f"{[round(v, 3) for v in latencies]}; (launches, plain calls) {counts}", flush=True)
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
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    rng = np.random.RandomState(SEED)
    kernels = check_kernels(device, rng)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build.BUILD_DIR) as tmp:
        root = Path(tmp)
        views = write_scene(root, rng)
        check_frames(root, views, device, rng)
        hierarchy = serve_mode(root, [])
        occupancy = serve_mode(root, ["--occupancy"])
        if args.profile:
            profile_modes(root)

    # Each mode's kernel ran in its serve phase; no plain version ran there.
    require(hierarchy["fused_mlp"][0] > 0, "hierarchy serving never launched fused_mlp")
    require(occupancy["fused_render"][0] > 0, "occupancy serving never launched fused_render")
    for name, counts in (("hierarchy", hierarchy), ("occupancy", occupancy)):
        require(all(plain == 0 for _, plain in counts.values()),
                f"{name} serving called a plain version: {counts}")
    launches = {"fused_mlp": hierarchy["fused_mlp"][0] + occupancy["fused_mlp"][0],
                "fused_render": hierarchy["fused_render"][0] + occupancy["fused_render"][0]}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    ordered = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms"]
    print(card)
    print(json.dumps({"kernels": [{key: k[key] for key in ordered} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
