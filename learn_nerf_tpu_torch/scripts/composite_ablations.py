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
  extras, the background's gradient by atomics into a zeroed [3]);
* ``other checkout``, with ``--against DIR``: ``csrc/composite.cu`` of
  another checkout of the port (its dense kernels at this checkout's
  interface), to hold a change of the source to the dense kernels' times
  in one call.

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

With ``--pooled`` it times the pool-layout pair instead (``POOLED_VARIANTS``)
at the pooled step's pool, two pooled frame tiles of short rays and one
whose rows sit in runs of long rays, as a served frame's do
(``POOLED_SHAPES``), the points as extras, in turns whose order alternates
(A B B A):

* ``as built``: the kernels on the path, groups of as many rays as the
  wrapper's rule gives (``kernels.composite.pooled_rays_per_warp``);
* ``1 ray a warp``: a warp a ray at every shape; ``R rays a warp``: groups
  of R = 2, 4, 8, 16 or 32 rays, each taken whole by one warp where its
  rows fit in 32;
* ``tail zeros first``, ``tail zeros last``: the pool tail's zeros written
  before the rays' work (the stores overlap it) or after it, in every
  kernel (as built: before where groups leave warps idle and there are no
  extras, after otherwise);
* ``f32 background sum``: the background's gradient summed as the dense
  backward sums it, in f32 (as built: the same order in f64);
* ``no background sum``, ``no tail zeroing``: the backward kernels without
  the background gradient's last-block sum or without the pool tail's
  zeros, to time those parts (their results are not the function's);
* ``parent``: the pair as it was before, one warp a ray
  (``csrc/ablations/composite_pooled_parent.cu``).

Each line gives the forward (``forward_us``), the backward with all three
cotangents (``backward_us``) and as the train step calls it (the outputs'
cotangent alone, ``step_backward_us``), all by CUDA-graph replay; the
same three on cold caches (``cold_forward_us``, ``cold_backward_us``,
``cold_step_backward_us``: the kernel's own duration in the profiler, each
call after a 96 MB fill that evicts L2, as in a frame, where other kernels
run between); the floor of a launch at the grid (``floor_us``: an empty
kernel of as many blocks of 256 threads, ``csrc/ablations/probes.cu``,
timed by graph replay); the byte bounds (``bound_us``, ``backward_bound_us``: the rows the
rays own read once, every output written once, at 3.35 TB/s); and in the
first turn the largest difference from the kernels as built.

    python -m learn_nerf_tpu_torch.scripts.composite_ablations [--turns N] [--against DIR] [variant ...]
    python -m learn_nerf_tpu_torch.scripts.composite_ablations --pooled [--turns N] [variant ...]
"""

import argparse
import contextlib
import ctypes
import json
import shutil
import subprocess
import time
import types
from pathlib import Path

import numpy as np
import torch

from ..kernels import build
from ..kernels import composite as kc
from ..ops.volume import composite
from .hashgrid_ablations import build_probes
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
    for (int i = 0; i < S; ++i) x[i] = load_sample<E, P>(in, first, k, lane + 32 * i, ray_delta);
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
      const Sample<E> x = load_sample<E, P>(in, after, k, t, ray_delta);
      if (t < k) w_row[t] = r[i].w;
#pragma unroll
      for (int c = 0; c < 3; ++c) fg[c] += r[i].w * x.rgb[c];
#pragma unroll
      for (int j = 0; j < E; ++j) ex[j] += r[i].w * x.extra[j];
    }"""
BACKWARD_PRELOAD = """#pragma unroll
      for (int i = 0; i < S; ++i) {
        const int t = lane + 32 * i;
        x[i] = load_sample<E, P>(in, first, k, t, ray_delta);
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
        x[i] = load_sample<E, P>(in, after, k, t, ray_delta);
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
POOLED_PARENT_SOURCE = "ablations/composite_pooled_parent.cu"
TAIL_RULE = "constexpr bool kTailFirst = R > 1 && E == 0;"
BACKGROUND_SUM = "  if (g.grad_background != nullptr) sum_background_pooled(bg_part, g, warp, lane);  // after the tail's zeros"
# name -> (the source compiled, [(old text, new text)] edits of it, rays a
# warp: None for the wrapper's rule)
POOLED_VARIANTS = {
    "as built": (SOURCE, [], None),
    **{f"{r} ray{'s' if r > 1 else ''} a warp": (SOURCE, [], r) for r in kc.POOLED_RAYS_PER_WARP},
    "tail zeros first": (SOURCE, [(TAIL_RULE, "constexpr bool kTailFirst = true;")], None),
    "tail zeros last": (SOURCE, [(TAIL_RULE, "constexpr bool kTailFirst = false;")], None),
    "f32 background sum": (SOURCE, [(BACKGROUND_SUM, BACKGROUND_SUM.replace("sum_background_pooled", "sum_background"))],
                           None),
    "no background sum": (SOURCE, [(BACKGROUND_SUM, "")], None),
    "no tail zeroing": (SOURCE, [("  if constexpr (kTailFirst) zero_pool_tail(in, g);\n", ""),
                                 ("  if constexpr (!kTailFirst) zero_pool_tail(in, g);\n", "")], None),
    "parent": (POOLED_PARENT_SOURCE, [], 1),
}
# (rays, K, pool rows a ray, mean survivors a ray, width of a run of rays
# that own rows or None), as chip_smoke.py's POOLED_SHAPES: the pooled
# train step's pool, pooled frame tiles at budget 6 and 32, and a budget-6
# frame tile as a served frame fills it (rays in runs across the ball).
POOLED_SHAPES = {
    "step 4096 x 16 of 32": (4096, 32, 16, 9.6, None),
    "tile 8192 x 6 of 32": (8192, 32, 6, 4.6, None),
    "tile 8192 x 32 of 32": (8192, 32, 32, 23.0, None),
    "tile 8192 x 6 of 32, runs": (8192, 32, 6, 34.0, 36),
}
# Rays a row of a served frame's image; a run is centred in each.
IMAGE_SIDE = 256
FLUSH_BYTES = 96 << 20
HBM_BYTES_PER_S = 3.35e12
THREADS_A_BLOCK = 256
RAYS = 4096
OTHER = "other checkout"
# The csrc directory each variant is built from (``--against`` adds one).
CSRC_OF = {}


def build_libraries(names, variants=VARIANTS):
    """Compile each variant's one source (with its edits) into its own
    library, all at once (variants of the same source and edits share
    one); ``{name: ctypes.CDLL}``."""
    root = build.BUILD_DIR / "ablations" / ("composite_pooled" if variants is POOLED_VARIANTS else "composite")
    procs, same = {}, {}
    for name in names:
        source, edits, _ = variants[name]
        key = (CSRC_OF.get(name), source, tuple(edits))
        if key in same:
            procs[name] = procs[same[key]]
            continue
        same[key] = name
        out = root / name.replace(" ", "_").replace(".", "")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(CSRC_OF.get(name, build.CSRC_DIR), out)
        text = (out / source).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in {source}")
            text = text.replace(old, new)
        (out / source).write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out / "libcomposite.so"), str(out / source)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, loaded = {}, {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (out, proc) in procs.items():
        if out in loaded:
            libs[name] = loaded[out]
            continue
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log[-4000:]}")
        (out / "build.log").write_text(log)
        lib = ctypes.CDLL(str(out / "libcomposite.so"))
        loaded[out] = lib
        if variants[name][0] == POOLED_PARENT_SOURCE:
            lib.nerf_composite_forward_parent.argtypes = [ptr] * 6 + [i32] * 4 + [ptr] * 5
            lib.nerf_composite_backward_parent.argtypes = [ptr] * 10 + [i32] * 4 + [ptr] * 8
            lib.nerf_composite_pooled_forward_parent.argtypes = [ptr] * 7 + [i32] * 4 + [ptr] * 4
            lib.nerf_composite_pooled_backward_parent.argtypes = [ptr] * 10 + [i32] * 4 + [ptr] * 7
            funcs = (lib.nerf_composite_forward_parent, lib.nerf_composite_backward_parent,
                     lib.nerf_composite_pooled_forward_parent, lib.nerf_composite_pooled_backward_parent)
        elif name == "parent":
            lib.nerf_composite_parent_forward.argtypes = [ptr] * 5 + [i32, i32] + [ptr] * 4
            lib.nerf_composite_parent_backward.argtypes = [ptr] * 8 + [i32, i32] + [ptr] * 5
            funcs = (lib.nerf_composite_parent_forward, lib.nerf_composite_parent_backward)
        else:
            lib.nerf_composite_forward.argtypes = [ptr] * 6 + [i32] * 4 + [ptr] * 5
            lib.nerf_composite_backward.argtypes = [ptr] * 10 + [i32] * 4 + [ptr] * 8
            lib.nerf_composite_pooled_forward.argtypes = [ptr] * 7 + [i32] * 5 + [ptr] * 4
            lib.nerf_composite_pooled_backward.argtypes = [ptr] * 10 + [i32] * 5 + [ptr] * 7
            funcs = (lib.nerf_composite_forward, lib.nerf_composite_backward, lib.nerf_composite_pooled_forward,
                     lib.nerf_composite_pooled_backward)
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


class PooledEntries:
    """A built library's pool-layout entry points at this checkout's
    interface: the parent's (which take no rays a warp, and give a warp one
    ray) drop that argument."""

    def __init__(self, lib):
        self.parent = hasattr(lib, "nerf_composite_pooled_forward_parent")
        if self.parent:
            forward, backward = lib.nerf_composite_pooled_forward_parent, lib.nerf_composite_pooled_backward_parent
            self.forward = lambda *a: forward(*a[:11], *a[12:])
            self.backward = lambda *a: backward(*a[:14], *a[15:])
        else:
            self.forward, self.backward = lib.nerf_composite_pooled_forward, lib.nerf_composite_pooled_backward


@contextlib.contextmanager
def launching_pooled_from(lib, rays_per_warp=None):
    """Inside, the pool-layout wrappers launch from ``lib`` (a variant built
    by :func:`build_libraries` from ``POOLED_VARIANTS``) with ``rays_per_warp``
    rays a warp (None: the wrapper's rule; the parent takes 1)."""
    entries = PooledEntries(lib)
    built, rule = build._library, kc.pooled_rays_per_warp
    build._library = types.SimpleNamespace(
        nerf_composite_pooled_forward=entries.forward, nerf_composite_pooled_backward=entries.backward,
        nerf_error_string=build.library().nerf_error_string)
    if entries.parent:
        rays_per_warp = 1
    if rays_per_warp is not None:
        kc.pooled_rays_per_warp = lambda n, rows: rays_per_warp
    try:
        yield
    finally:
        build._library, kc.pooled_rays_per_warp = built, rule


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


def pool_counts(rng, n, k, mean, run=None):
    """Rows a ray: binomial(192, mean / 192), at most k; with ``run``, only
    the ``run`` rays at the middle of each image row of IMAGE_SIDE rays own
    rows (the rays of a served frame that cross the ball)."""
    counts = np.minimum(rng.binomial(192, mean / 192, n), k)
    if run is not None:
        x = np.arange(n) % IMAGE_SIDE - IMAGE_SIDE // 2
        counts = np.where((x >= -(run // 2)) & (x < run - run // 2), counts, 0)
    return counts


def make_pool(rng, device, n, k, budget, mean, run=None, extras=3):
    """A pool of ``n * budget`` rows whose rays own ``pool_counts`` rows
    each (clamped at the pool's end), optical depth about 1-3 on a full ray:
    ``(densities, starts, deltas, rgbs, background, mask, points)`` and the
    cotangents of the outputs, alphas and points' blend."""
    rows = n * budget
    counts = pool_counts(rng, n, k, mean, run)
    starts = np.concatenate([[0], np.minimum(np.cumsum(counts), rows)]).astype(np.int32)

    def on_card(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    inputs = (on_card((rng.uniform(0, 2, rows) * (rng.rand(rows) < 0.8)).astype(np.float32)), on_card(starts),
              on_card((rng.uniform(0.03, 0.1, (n, 1)) * 32 / k).astype(np.float32)),
              on_card(rng.uniform(-1, 1, (rows, 3)).astype(np.float32)), on_card(np.array([-1.0, 0.3, 1.0], np.float32)),
              on_card(rng.rand(n) < 0.9), on_card(rng.uniform(-1, 1, (rows, extras)).astype(np.float32)))
    cotangents = tuple(on_card(rng.randn(*s).astype(np.float32)) for s in ((n, 3), (n, 1), (n, extras)))
    return inputs, cotangents


def pooled_bounds(inputs):
    """(forward, backward) bytes: the rows the rays own read once, the
    starts, widths, mask and background, and every output written once (the
    backward: each gradient row, the tail's zeros included, and the
    cotangents)."""
    densities, starts, deltas, _, background, mask, extras = inputs
    n, used, c, rows = starts.shape[0] - 1, int(starts[-1]), extras.shape[1], densities.shape[0]
    small = sum(v.numel() * v.element_size() for v in (starts, deltas, mask, background)) + 4 * n * (4 + c)
    return 4 * used * (4 + c) + small, 4 * used * (4 + c) + 4 * rows * (4 + c) + small


def cold_ms(fn, flush, reps=20):
    """The mean duration of the composite kernels ``fn`` launches, each call
    after ``flush`` is filled (L2 evicted), from the profiler's device
    timestamps."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.fill_(1)
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if "composite" in e.key]
    return sum(e.device_time_total for e in kernels) / sum(e.count for e in kernels) / 1e3


def floor_ms(probes, blocks, device, reps=50):
    """The time of an empty kernel of ``blocks`` blocks of 256 threads, by
    CUDA-graph replay: the floor of one launch at that grid."""
    device = torch.device("cuda", torch.cuda.current_device()) if device.index is None else device

    def launch():
        err = probes.nerf_probe_empty(blocks, THREADS_A_BLOCK, build.current_stream(device))
        if err != 0:
            raise RuntimeError(f"the empty kernel failed to launch (cudaError {err})")
    return graph_ms(launch, reps)


def main_pooled(args):
    """``--pooled``: the pool-layout pair's variants in turns, one JSON line
    per variant, shape and turn."""
    device = torch.device("cuda", torch.cuda.current_device())
    names = ["as built", *[v for v in args.variants or POOLED_VARIANTS if v != "as built"]]
    build.library()
    libs = build_libraries(names, POOLED_VARIANTS)
    probes = build_probes()
    rng = np.random.RandomState(0)
    data = {name: (k, *make_pool(rng, device, n, k, budget, mean, run))
            for name, (n, k, budget, mean, run) in POOLED_SHAPES.items()}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)

    def calls(k, inputs, cotangents):
        return (lambda: kc.composite_pooled_forward_cuda(*inputs, k),
                lambda: kc.composite_pooled_backward_cuda(*inputs, k, *cotangents),
                lambda: kc.composite_pooled_backward_cuda(*inputs, k, cotangents[0], None, None,
                                                          wanted=(True, True, False)))

    reference = {}
    with launching_pooled_from(libs["as built"]):
        for shape, (k, inputs, cotangents) in data.items():
            forward, backward, _ = calls(k, inputs, cotangents)
            reference[shape] = (forward(), backward())
    for turn in range(args.turns):
        for name in (names if turn % 2 == 0 else names[::-1]):
            with launching_pooled_from(libs[name], POOLED_VARIANTS[name][2]):
                for shape, (k, inputs, cotangents) in data.items():
                    forward, backward, step_backward = calls(k, inputs, cotangents)
                    n, rows = inputs[1].shape[0] - 1, inputs[0].shape[0]
                    rays_per_warp = kc.pooled_rays_per_warp(n, rows)
                    blocks = kc.pooled_blocks(n)
                    fwd_bytes, bwd_bytes = pooled_bounds(inputs)
                    result = dict(variant=name, shape=shape, turn=turn, rays_per_warp=rays_per_warp, blocks=blocks,
                                  forward_us=graph_ms(forward, 50) * 1e3, backward_us=graph_ms(backward, 50) * 1e3,
                                  step_backward_us=graph_ms(step_backward, 50) * 1e3,
                                  cold_forward_us=cold_ms(forward, flush) * 1e3,
                                  cold_backward_us=cold_ms(backward, flush) * 1e3,
                                  cold_step_backward_us=cold_ms(step_backward, flush) * 1e3,
                                  floor_us=floor_ms(probes, blocks, device) * 1e3,
                                  bound_us=fwd_bytes / HBM_BYTES_PER_S * 1e6,
                                  backward_bound_us=bwd_bytes / HBM_BYTES_PER_S * 1e6)
                    if turn == 0:
                        want_fwd, want_bwd = reference[shape]
                        result["forward_max_diff"] = max_difference(forward(), want_fwd)
                        result["backward_max_diff"] = max_difference(backward(), want_bwd)
                    print(json.dumps(result), flush=True)


def max_difference(got, want):
    pairs = [(a, b) for a, b in zip(got, want) if a is not None and b is not None]
    return max((a - b).abs().max().item() for a, b in pairs)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*",
                        help=f"any of {list(VARIANTS)}, or with --pooled of {list(POOLED_VARIANTS)} (default: all)")
    parser.add_argument("--pooled", action="store_true", help="time the pool-layout pair's variants instead")
    parser.add_argument("--turns", type=int, default=3, help="turns over the variants")
    parser.add_argument("--against", type=str, default=None,
                        help="another checkout's root: time its csrc/composite.cu as the variant "
                             f"{OTHER!r}")
    args = parser.parse_args(argv)
    known = POOLED_VARIANTS if args.pooled else VARIANTS
    if args.pooled and args.against is not None:
        parser.error("--against times the dense kernels; it does not go with --pooled")
    if args.against is not None:
        VARIANTS[OTHER] = (SOURCE, [], 8)
        CSRC_OF[OTHER] = Path(args.against).resolve() / "learn_nerf_tpu_torch" / "csrc"
        args.variants = [*args.variants, OTHER] if args.variants else [*VARIANTS]
    unknown = set(args.variants) - set(known)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}; known: {list(known)}")
    if not torch.cuda.is_available():
        raise SystemExit("composite_ablations: no CUDA device; the ablations run on the card")
    if args.pooled:
        main_pooled(args)
        print(card_line())
        return
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
    print(card_line())


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    return card.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    main()
