"""What each part of the composite kernels' design buys, by ablation, on
the card.

Builds ``csrc/composite.cu`` on its own, its measured variants and the
kernels it replaced, each into its own library, and times them in turns on
the same data (rays of optical depth 1-3), by CUDA-graph replay:

* ``as built``: the kernels on the path;
* ``atomic background``: the background's gradient summed as before, one
  atomic per channel and block into a [3] that a memset zeroes before each
  launch (as built: a slot per block, summed by the last block);
* ``loads after the scan``: a ray's colours, extras and cotangents are
  loaded once its scan is done, as the parent ordered them (as built: every
  load of the ray before the first scan step);
* ``stride at run time``: the widths' stride read from a flag at run time
  (as built: a template parameter, a kernel for each);
* ``bulk copy``: each block's rows staged in shared memory by
  ``cp.async.bulk`` on one mbarrier and the weights written back as one
  span (``csrc/ablations/composite_bulk.cu``; K <= 64);
* ``4 rays a block``, ``16 rays a block``: blocks of 128 or 512 threads
  (as built: 8 rays, 256 threads);
* ``parent``: the kernels as they were before
  (``csrc/ablations/composite_parent.cu``: K <= 64, one width per ray, no
  extras, the background's gradient by atomics into a zeroed [3]).

The calls:

* ``parent's call`` at 4096 x 32, 8192 x 32 and 4096 x 64: one width per
  ray, no extras; the backward takes the cotangents of all three outputs;
* ``step's call`` at 4096 x 32, as the train step makes it: one width per
  ray, the points as extras; the backward takes the outputs' cotangent
  alone and writes no gradient of the widths or the points.  The parent's
  row is its kernel and the plain coords blend (``ops.volume.composite``)
  that ran beside it;
* ``step's call, points read``: the same with a zero cotangent of the
  blended points, so that the backward reads the points (as built, extras
  without a cotangent are not passed to the kernel);
* ``hierarchy pass`` at 4096 x 64 and 4096 x 192, as a hierarchy tile's
  coarse and fine passes: one width per sample, the points as extras,
  forward only.  ``plain ops`` is the plain version these passes ran
  before (``render_composite_reference``).

Each line also gives a call's host time (``host_us``: back-to-back calls on
the host's clock, synchronised once at the end, over the calls), and in the
first turn each variant's largest difference from the kernels as built.
Prints one JSON line per variant, call and turn, then the card's name and
power limit.  The libraries build into
``learn_nerf_tpu_torch/_build/ablations/composite/``.

    python -m learn_nerf_tpu_torch.scripts.composite_ablations [--turns N] [variant ...]
"""

import argparse
import contextlib
import ctypes
import json
import shutil
import subprocess
import time
import types

import numpy as np
import torch

from ..kernels import build
from ..kernels import composite as kc
from ..ops.volume import composite
from .timing import graph_ms

BACKGROUND_TAIL = "  if (g.grad_background != nullptr) sum_background(bg_part, g, warp, lane);"
ATOMIC_TAIL = """  __shared__ float block_bg[kCompositeWarps][3];
  if (lane == 0) {
    for (int c = 0; c < 3; ++c) block_bg[warp][c] = bg_part[c];
  }
  __syncthreads();
  if (threadIdx.x < 3 && g.grad_background != nullptr) {
    float sum = 0.0f;
    for (int w = 0; w < kCompositeWarps; ++w) sum += block_bg[w][threadIdx.x];
    atomicAdd(g.grad_background + threadIdx.x, sum);
  }"""
BACKWARD_LAUNCH = ("  return composite_dispatch<LaunchBackward>(k, c, in.per_sample, in, g, "
                   "static_cast<cudaStream_t>(stream));")
MEMSET_LAUNCH = ("  if (grad_background != nullptr) {\n"
                 "    cudaMemsetAsync(grad_background, 0, 3 * sizeof(float), static_cast<cudaStream_t>(stream));\n"
                 "  }\n" + BACKWARD_LAUNCH)
# Loads after the scan, as the parent ordered them: the colours, extras and
# cotangents of a ray are loaded only once its scan is done (their addresses
# take a term that depends on the scan's result and is always 0).
FORWARD_PRELOAD = """    Sample<E> x[S];
#pragma unroll
    for (int i = 0; i < S; ++i) x[i] = load_sample<E, P>(in, first, lane + 32 * i, ray_delta);
#pragma unroll
    for (int i = 0; i < S; ++i) step(x[i], lane + 32 * i);"""
FORWARD_AFTER_SCAN = """    ScanStep r[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int t = lane + 32 * i;
      const float density = t < k ? __ldg(in.densities + first + t) : 0.0f;
      const float delta = P ? (t < k ? __ldg(in.deltas + first + t) : 0.0f) : ray_delta;
      r[i] = scan_step(density, delta, carry, lane);
    }
    const long long after = first + (__float_as_int(carry) < 0);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int t = lane + 32 * i;
      const Sample<E> x = load_sample<E, P>(in, after, t, ray_delta);
      if (t < k) w_row[t] = r[i].w;
#pragma unroll
      for (int c = 0; c < 3; ++c) fg[c] += r[i].w * x.rgb[c];
#pragma unroll
      for (int j = 0; j < E; ++j) ex[j] += r[i].w * x.extra[j];
    }"""
BACKWARD_PRELOAD = """#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int t = lane + 32 * i;
        x[i] = load_sample<E, P>(in, first, t, ray_delta);
        gw[i] = gw_row != nullptr && t < k ? __ldg(gw_row + t) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const ScanStep r = scan_step(x[i].density, x[i].delta, carry, lane);
        w[i] = r.w;
        t_next[i] = expf(-r.incl);
      }"""
BACKWARD_AFTER_SCAN = """#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int t = lane + 32 * i;
        const float density = t < k ? __ldg(in.densities + first + t) : 0.0f;
        const float delta = P ? (t < k ? __ldg(in.deltas + first + t) : 0.0f) : ray_delta;
        const ScanStep r = scan_step(density, delta, carry, lane);
        w[i] = r.w;
        t_next[i] = expf(-r.incl);
      }
      const long long after = first + (__float_as_int(carry) < 0);
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int t = lane + 32 * i;
        x[i] = load_sample<E, P>(in, after, t, ray_delta);
        gw[i] = gw_row != nullptr && t < k ? __ldg(gw_row + t + (after - first)) : 0.0f;
      }"""
THREADS = "constexpr int kCompositeThreads = 256;"
SOURCE, PARENT_SOURCE = "composite.cu", "ablations/composite_parent.cu"
# name -> (the source compiled, [(old text, new text)] edits of it, rays a block)
VARIANTS = {
    "as built": (SOURCE, [], 8),
    "atomic background": (SOURCE, [(BACKGROUND_TAIL, ATOMIC_TAIL), (BACKWARD_LAUNCH, MEMSET_LAUNCH)], 8),
    "loads after the scan": (SOURCE, [(FORWARD_PRELOAD, FORWARD_AFTER_SCAN), (BACKWARD_PRELOAD, BACKWARD_AFTER_SCAN)], 8),
    "stride at run time": (SOURCE, [("P ? ", "in.per_sample ? "), ("if (P) {", "if (in.per_sample) {"),
                                    ("if (!P && ", "if (!in.per_sample && ")], 8),
    "bulk copy": ("ablations/composite_bulk.cu", [], 8),
    "4 rays a block": (SOURCE, [(THREADS, "constexpr int kCompositeThreads = 128;")], 4),
    "16 rays a block": (SOURCE, [(THREADS, "constexpr int kCompositeThreads = 512;")], 16),
    "parent": (PARENT_SOURCE, [], 8),
}
RAYS = 4096


def build_libraries(names):
    """Compile each variant's one source (with its edits) into its own
    library, all at once; ``{name: ctypes.CDLL}``."""
    root = build.BUILD_DIR / "ablations" / "composite"
    procs = {}
    for name in names:
        source, edits, _ = VARIANTS[name]
        out = root / name.replace(" ", "_")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, out)
        text = (out / source).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in {source}")
            text = text.replace(old, new)
        (out / source).write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out / "libcomposite.so"), str(out / source)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / "libcomposite.so"))
        if name == "parent":
            lib.nerf_composite_parent_forward.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * 4
            lib.nerf_composite_parent_backward.argtypes = [ptr] * 8 + [i32, i32] + [ptr] * 5
            funcs = (lib.nerf_composite_parent_forward, lib.nerf_composite_parent_backward)
        else:
            lib.nerf_composite_forward.argtypes = [ptr] * 6 + [i32] * 4 + [ptr] * 5
            lib.nerf_composite_backward.argtypes = [ptr] * 10 + [i32] * 4 + [ptr] * 8
            funcs = (lib.nerf_composite_forward, lib.nerf_composite_backward)
        for f in funcs:
            f.restype = i32
        libs[name] = lib
    return libs


class Parent:
    """The parent's two wrappers, as they were: outputs from torch.empty,
    the background's gradient from torch.zeros_like."""

    def __init__(self, lib):
        self.lib = lib

    def _check(self, err):
        if err != 0:
            raise RuntimeError(f"the parent's composite kernel failed to launch ({err})")

    def forward(self, densities, dt, rgbs, background, mask):
        n, k = densities.shape
        device = densities.device
        outputs = torch.empty((n, 3), dtype=torch.float32, device=device)
        weights = torch.empty((n, k + 1), dtype=torch.float32, device=device)
        alphas = torch.empty((n, 1), dtype=torch.float32, device=device)
        self._check(self.lib.nerf_composite_parent_forward(
            densities.data_ptr(), dt.data_ptr(), rgbs.data_ptr(), background.data_ptr(), mask.data_ptr(),
            n, k, outputs.data_ptr(), weights.data_ptr(), alphas.data_ptr(), build.current_stream(device)))
        return outputs, weights, alphas

    def backward(self, densities, dt, rgbs, background, mask, grad_outputs, grad_weights, grad_alphas):
        n, k = densities.shape
        grads = [torch.empty_like(densities), torch.empty_like(dt), torch.empty_like(rgbs),
                 torch.zeros_like(background)]
        ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
        self._check(self.lib.nerf_composite_parent_backward(
            densities.data_ptr(), dt.data_ptr(), rgbs.data_ptr(), background.data_ptr(), mask.data_ptr(),
            ptr(grad_outputs), ptr(grad_weights), ptr(grad_alphas), n, k, *(g.data_ptr() for g in grads),
            build.current_stream(densities.device)))
        return grads


@contextlib.contextmanager
def launching_from(lib, rays_per_block):
    """Inside, the composite wrappers launch from ``lib`` (a variant built
    by :func:`build_libraries`) with its blocks' ray count."""
    built, per_block = build._library, kc.RAYS_PER_BLOCK
    build._library = types.SimpleNamespace(
        nerf_composite_forward=lib.nerf_composite_forward,
        nerf_composite_backward=lib.nerf_composite_backward,
        nerf_error_string=build.library().nerf_error_string)
    kc.RAYS_PER_BLOCK = rays_per_block
    try:
        yield
    finally:
        build._library, kc.RAYS_PER_BLOCK = built, per_block


def host_us(fn, calls=200):
    """Host time per call of back-to-back calls, synchronised once at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def make_data(rng, device, n, k, per_sample):
    """Rays of optical depth 1-3 (densities up to 2, a fifth of the slots
    padding, widths around 2 / k), points as extras, and cotangents."""
    def on_card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return dict(
        densities=on_card(rng.uniform(0, 2, (n, k)) * (rng.rand(n, k) < 0.8)),
        deltas=on_card(rng.uniform(0.03, 0.1, (n, k if per_sample else 1)) * 32 / k),
        rgbs=on_card(rng.uniform(-1, 1, (n, k, 3))),
        background=on_card([-1.0, 0.3, 1.0]),
        mask=torch.from_numpy(rng.rand(n) < 0.9).to(device),
        points=on_card(rng.uniform(-0.7, 0.7, (n, k, 3))),
        grad_outputs=on_card(rng.randn(n, 3)),
        grad_weights=on_card(rng.randn(n, k + 1)),
        grad_alphas=on_card(rng.randn(n, 1)),
        zeros=torch.zeros((n, 3), device=device),
    )


def calls_of(name, parent, d):
    """``{call: (forward, backward or None)}`` of one variant on data ``d``."""
    ins = (d["densities"], d["deltas"], d["rgbs"], d["background"], d["mask"])
    cots = (d["grad_outputs"], d["grad_weights"], d["grad_alphas"])
    k = d["densities"].shape[1]
    per_sample = d["deltas"].shape[1] == k and k > 1
    if per_sample:  # a hierarchy pass: forward only
        if name == "plain ops":
            return lambda: kc.render_composite_reference(*ins, d["points"]), None
        return lambda: kc.composite_forward_cuda(*ins, d["points"]), None
    if name == "parent":
        return (lambda: parent.forward(*ins), lambda: parent.backward(*ins, *cots),
                lambda: composite(parent.forward(*ins)[1], d["points"], d["background"].new_zeros(3), d["mask"]),
                lambda: parent.backward(*ins, cots[0], None, None))
    return (lambda: kc.composite_forward_cuda(*ins), lambda: kc.composite_backward_cuda(*ins, None, *cots),
            lambda: kc.composite_forward_cuda(*ins, d["points"]),
            lambda: kc.composite_backward_cuda(*ins, d["points"], cots[0], None, None, None,
                                               wanted=(False, True, True, False)),
            # The points read by the backward: a zero cotangent keeps them
            # (as built, extras without a cotangent are not read).
            lambda: kc.composite_backward_cuda(*ins, d["points"], cots[0], None, None, d["zeros"],
                                               wanted=(False, True, True, False)))


def max_difference(got, want):
    pairs = [(a, b) for a, b in zip(got, want) if a is not None and b is not None]
    return max((a - b).abs().max().item() for a, b in pairs)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", help=f"any of {list(VARIANTS)} (default: all)")
    parser.add_argument("--turns", type=int, default=3, help="turns over the variants")
    args = parser.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("composite_ablations: no CUDA device; the ablations run on the card")
    device = torch.device("cuda")
    names = ["as built", *[v for v in args.variants or VARIANTS if v != "as built"]]
    build.library()
    libs = build_libraries(names)
    parent = Parent(libs["parent"]) if "parent" in libs else None

    rng = np.random.RandomState(0)
    data = {f"parent's call {n} x {k}": make_data(rng, device, n, k, False)
            for n, k in ((RAYS, 32), (2 * RAYS, 32), (RAYS, 64))}
    data[f"step's call {RAYS} x 32"] = data[f"parent's call {RAYS} x 32"]
    data[f"step's call, points read {RAYS} x 32"] = data[f"parent's call {RAYS} x 32"]
    data.update({f"hierarchy pass {RAYS} x {k}": make_data(rng, device, RAYS, k, True) for k in (64, 192)})

    def runs(name):
        """``[(call, forward, backward)]`` of a variant."""
        out = []
        for call, d in data.items():
            fns = calls_of(name, parent, d)
            if call.startswith("hierarchy pass"):
                out.append((call, *fns))
            elif call.startswith("step's call, points read"):
                if name != "parent":
                    out.append((call, fns[2], fns[4]))
            elif call.startswith("step's call"):
                out.append((call, fns[2], fns[3]))
            else:
                out.append((call, fns[0], fns[1]))
        return out

    reference = {}
    with launching_from(libs["as built"], 8):
        for call, forward, backward in runs("as built"):
            reference[call] = (forward(), backward() if backward else None)
    order = names + ["plain ops"]
    for turn in range(args.turns):
        for name in order:
            variant_lib = libs.get(name, libs["as built"])
            context = (contextlib.nullcontext() if name in ("parent", "plain ops")
                       else launching_from(variant_lib, VARIANTS[name][2]))
            with context:
                for call, forward, backward in runs(name):
                    if name == "plain ops" and not call.startswith("hierarchy pass"):
                        continue
                    k = data[call]["densities"].shape[1]
                    if name == "parent" and (k > 64 or call.startswith("hierarchy pass")):
                        continue
                    result = dict(variant=name, call=call, turn=turn,
                                  forward_us=graph_ms(forward, 50) * 1e3,
                                  forward_host_us=host_us(forward))
                    if backward is not None:
                        result.update(backward_us=graph_ms(backward, 50) * 1e3,
                                      backward_host_us=host_us(backward))
                    if turn == 0 and name not in ("parent", "plain ops"):
                        want_fwd, want_bwd = reference[call]
                        result["forward_max_diff"] = max_difference(forward(), want_fwd)
                        if backward is not None:
                            result["backward_max_diff"] = max_difference(backward(), want_bwd)
                    print(json.dumps(result), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
