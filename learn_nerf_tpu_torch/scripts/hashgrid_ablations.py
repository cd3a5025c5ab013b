"""Where the hash-grid kernels spend their time, by ablation, on the card.

Builds variants of ``csrc/`` with one part of the design taken out or
changed, and times each beside the kernels as built, in turns: the encode
kernel on 2^20 points at the 16-level fine schedule (F = 2), on uniform
random points and on points along rays (8192 rays of 128 samples 0.01
apart, as a frame feeds it); the encode and the table-gradient kernel at a
train step's shape (4096 rays of 32 samples 0.02 apart, and as many random
points); and table_gather at ``pallas_gather``'s [2^18, 2] x 999,424 by
CUDA-graph replay.  Each variant computes the same result, and every encode
variant is held bit for bit to the kernel as built (``as built``: the
encode kernel with one thread per (point, work item); the table-gradient
kernel on its ray-ordered layout with pair atomics and run combining):

* ``parent layout``: the table-gradient kernel as it was before the
  ray-ordered layout (``csrc/ablations/hashgrid_backward_parent.cu``): one
  thread per (point, work item), a point's items on consecutive lanes, one
  atomic per corner row;
* ``layout alone``: the table-gradient kernel on the new layout with one
  atomic per row and no combining;
* ``layout + pair atomics``: with one vector atomic per aligned pair of
  rows, no combining (``as built`` adds the combining of runs);
* ``combine always`` / ``combine from 16``: the warps combine whenever two
  lanes share a cell, or only from 16 merged lanes on (as built: 8);
* ``backward shared coarse levels``: the leading dense levels of at most
  32 KB sum in shared memory on a persistent grid, flushed once per block;
* ``tile 64``, ``128 threads``, ``64 threads``, ``32 threads``, ``tile 64,
  512 threads``: other block tiles of that layout (as built: 32 points, 256
  threads; with fewer warps than work items a warp takes several items in
  turn); they apply to the encode variants below as well;
* ``encode tiles``: the encode kernel in the table-gradient kernel's layout
  (``csrc/ablations/hashgrid_encode_tiles.cu``: a warp per work item, a
  lane per point, out staged in shared memory); the ``encode tiles, ...``
  variants are that kernel with one more change:
  ``shared coarse tables`` (the leading dense levels' tables copied into
  shared memory once per persistent block and read from there), ``hashed
  rows past L1`` (``ld.global.nc.L1::no_allocate`` on the hashed levels),
  ``direct stores`` (each lane writes its features into out itself),
  ``tile 64``, ``128 threads``, ``64 threads``, ``single-level items`` and
  ``128 threads, single-level items``;
* ``no pair loads``: the encode kernel reads each corner's row alone,
  never a pair of neighbouring rows as one vector;
* ``single-level items``: one work item per level, so level pairs compute
  their corners twice (the argument is packed with items of one level);
* ``gather four per thread``: table_gather takes four consecutive indices
  per thread from one 16-byte index load (four rows in flight) and stores
  their rows as one run;
* ``gather two per thread``: likewise with two indices and an 8-byte load;
* ``gather four strided``: four indices per thread, 256 apart, so every
  index load and row store of a warp stays one coalesced run;
* ``gather card-sized grid``: 8 blocks per SM, one index per thread and
  step, striding over the indices with the next index loaded ahead;
* ``gather card-sized grid, four strided``: the same grid striding over
  blocks of four strided indices per thread.

Then the card's own rate for the two access patterns that bound the
kernels (``csrc/ablations/probes.cu``): as many random 8-byte row reads as
the encode makes at 2^20 points x 16 levels over buffers of the tables'
sizes, every read in its own sector and with the encode's pair loads, and
as many random vector atomics of 2 and of 4 floats as the table-gradient
kernel adds rows at a train step's shape.  And what the points
themselves allow: the 32-byte sectors that the encode's loads touch per
point once the lanes of one instruction merge, a warp holding 32
consecutive points of a level or 4 (as built), and the atomics the
table-gradient kernel makes per point with pair atomics and combining.

The table-gradient kernel is timed by CUDA-graph replay (its memset
included): its wrapper's host work is as long as the kernel.

Prints one JSON line per variant and turn, one per probe and turn, then
the card's name and power limit.  Everything builds into
``learn_nerf_tpu_torch/_build/ablations/``.

    python -m learn_nerf_tpu_torch.scripts.hashgrid_ablations [--turns N] [--no-probes] [variant ...]
"""

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from ..kernels import build
from ..kernels import hashgrid as kh
from ..kernels import hashgrid_backward as kb
from ..kernels import hashgrid_encode as ke
from ..kernels import table_gather as tg
from ..ops.hashgrid import dense_level_rows
from .mlp_ablations import build_variants
from .timing import cuda_ms, graph_ms

# table_gather_kernel's body and grid as built, and the layouts put in
# their place.
GATHER_BODY = """\
  const long long i = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  if (i >= m) return;
  store_floats<C>(out + i * C, take_row<C>(table, rows, __ldg(idx + i)).v);
"""
GATHER_GRID = """\
  const unsigned int blocks = static_cast<unsigned int>((m + kGatherThreads - 1) / kGatherThreads);
"""
# K consecutive indices from one K*4-byte load, their rows stored as one run.
CONSECUTIVE = """\
  const long long i = {k}ll * (static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x);
  if (i + {k} <= m) {{
    const {vec} q = __ldg(reinterpret_cast<const {vec}*>(idx + i));
    const int j[4] = {{q.x, q.y, {zw}}};
    Row<C> r[{k}];
#pragma unroll
    for (int k = 0; k < {k}; ++k) r[k] = take_row<C>(table, rows, j[k]);
    float v[{k} * C];
#pragma unroll
    for (int k = 0; k < {k} * C; ++k) v[k] = r[k / C].v[k % C];
    store_floats<{k} * C>(out + i * C, v);
  }} else {{
    for (long long j = i; j < m; ++j) store_floats<C>(out + j * C, take_row<C>(table, rows, __ldg(idx + j)).v);
  }}
"""
# Four indices per thread, kGatherThreads apart, from `base` on.
STRIDED = """\
    int q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long j = base + k * kGatherThreads;
      q[k] = j < m ? __ldg(idx + j) : 0;
    }
    Row<C> r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = take_row<C>(table, rows, q[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long j = base + k * kGatherThreads;
      if (j < m) store_floats<C>(out + j * C, r[k].v);
    }
"""
QUAD_GRID = GATHER_GRID.replace("(m + kGatherThreads - 1) / kGatherThreads",
                                "(m + 4 * kGatherThreads - 1) / (4 * kGatherThreads)")
# At most 8 blocks of 256 threads per SM: one wave of the card.
CARD_GRID = """\
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long want = (m + {per_block} - 1) / ({per_block});
  const unsigned int blocks = static_cast<unsigned int>(want < 8ll * sms ? want : 8ll * sms);
"""
GRID_STRIDE = """\
  const long long stride = static_cast<long long>(gridDim.x) * kGatherThreads;
  long long i = static_cast<long long>(blockIdx.x) * kGatherThreads + threadIdx.x;
  int next = i < m ? __ldg(idx + i) : 0;
  for (; i < m; i += stride) {
    const int cur = next;
    if (i + stride < m) next = __ldg(idx + i + stride);
    store_floats<C>(out + i * C, take_row<C>(table, rows, cur).v);
  }
"""


def gather_layout(body, grid):
    return [("table_gather.cu", GATHER_BODY, body), ("table_gather.cu", GATHER_GRID, grid)]


BACKWARD, ENCODE, LAYOUT = "hashgrid_backward.cu", "hashgrid_encode.cu", "encode_args.cuh"
NO_COMBINING = (BACKWARD, "constexpr bool kCombineRuns = true;", "constexpr bool kCombineRuns = false;")
MIN_MERGED = "constexpr int kCombineMinMerged = 8;"
SHARED_OFF, SHARED_ON = "constexpr bool kSharedCoarse = false;", "constexpr bool kSharedCoarse = true;"
TILE_32, THREADS_256 = "constexpr int kTilePoints = 32;", "constexpr int kTileThreads = 256;"
TILES = (ENCODE, None, "ablations/hashgrid_encode_tiles.cu")
STAGED, THREADS_128 = "constexpr bool kStageOut = true;", "constexpr int kTileThreads = 128;"
VARIANTS = {
    "as built": [],
    "parent layout": [(BACKWARD, None, "ablations/hashgrid_backward_parent.cu")],
    "layout alone": [(BACKWARD, "constexpr bool kPairAtomics = true;", "constexpr bool kPairAtomics = false;"),
                     NO_COMBINING],
    "layout + pair atomics": [NO_COMBINING],
    "combine always": [(BACKWARD, MIN_MERGED, "constexpr int kCombineMinMerged = 1;")],
    "combine from 16": [(BACKWARD, MIN_MERGED, "constexpr int kCombineMinMerged = 16;")],
    "backward shared coarse levels": [(BACKWARD, SHARED_OFF, SHARED_ON)],
    "tile 64": [(LAYOUT, TILE_32, "constexpr int kTilePoints = 64;")],
    "128 threads": [(LAYOUT, THREADS_256, THREADS_128)],
    "64 threads": [(LAYOUT, THREADS_256, "constexpr int kTileThreads = 64;")],
    "32 threads": [(LAYOUT, THREADS_256, "constexpr int kTileThreads = 32;")],
    "tile 64, 512 threads": [(LAYOUT, TILE_32, "constexpr int kTilePoints = 64;"),
                             (LAYOUT, THREADS_256, "constexpr int kTileThreads = 512;")],
    "encode tiles": [TILES],
    "encode tiles, shared coarse tables": [TILES, (ENCODE, SHARED_OFF, SHARED_ON)],
    "encode tiles, hashed rows past L1": [TILES, (ENCODE, "constexpr bool kStreamHashed = false;",
                                                  "constexpr bool kStreamHashed = true;")],
    "encode tiles, direct stores": [TILES, (ENCODE, STAGED, "constexpr bool kStageOut = false;")],
    "encode tiles, tile 64": [TILES, (LAYOUT, TILE_32, "constexpr int kTilePoints = 64;")],
    "encode tiles, 128 threads": [TILES, (LAYOUT, THREADS_256, THREADS_128)],
    "encode tiles, 64 threads": [TILES, (LAYOUT, THREADS_256, "constexpr int kTileThreads = 64;")],
    "encode tiles, single-level items": [TILES],
    "encode tiles, 128 threads, single-level items": [TILES, (LAYOUT, THREADS_256, THREADS_128)],
    "no pair loads": [(ENCODE, "    if (paired) {", "    if (false) {")],
    "single-level items": [],
    "gather four per thread": gather_layout(CONSECUTIVE.format(k=4, vec="int4", zw="q.z, q.w"), QUAD_GRID),
    "gather two per thread": gather_layout(
        CONSECUTIVE.format(k=2, vec="int2", zw="0, 0"),
        GATHER_GRID.replace("(m + kGatherThreads - 1) / kGatherThreads",
                            "(m + 2 * kGatherThreads - 1) / (2 * kGatherThreads)")),
    "gather four strided": gather_layout(
        "  const long long base = static_cast<long long>(blockIdx.x) * 4 * kGatherThreads + threadIdx.x;\n"
        "  {\n" + STRIDED + "  }\n", QUAD_GRID),
    "gather card-sized grid": gather_layout(GRID_STRIDE, CARD_GRID.format(per_block="kGatherThreads")),
    "gather card-sized grid, four strided": gather_layout(
        "  const long long stride = static_cast<long long>(gridDim.x) * 4 * kGatherThreads;\n"
        "  for (long long base = static_cast<long long>(blockIdx.x) * 4 * kGatherThreads + threadIdx.x;\n"
        "       base < m; base += stride) {\n" + STRIDED + "  }\n",
        CARD_GRID.format(per_block="4 * kGatherThreads")),
}
POINTS, RAYS = 1 << 20, 8192
STEP_RAYS, STEP_SAMPLES = 4096, 32  # a train step's samples at batch 4096, 32 per ray
STEP_POINTS = STEP_RAYS * STEP_SAMPLES
PROBE_LEVELS = 16


class ProbeArgs(ctypes.Structure):
    """``csrc/ablations/probes.cu``'s ``ProbeArgs``, field for field."""

    _fields_ = [("table", ctypes.c_void_p * PROBE_LEVELS), ("rows", ctypes.c_uint * PROBE_LEVELS)]


def build_probes():
    """Compile ``csrc/ablations/probes.cu`` into its own library."""
    out = build.BUILD_DIR / "ablations" / "probes"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libprobes.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
           str(build.CSRC_DIR / "ablations" / "probes.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"the probes do not build:\n{(proc.stdout + proc.stderr)[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nerf_probe_reads.argtypes, lib.nerf_probe_reads.restype = [ptr, i64, i32, ptr, ptr], i32
    lib.nerf_probe_atomics.argtypes, lib.nerf_probe_atomics.restype = [ptr, i64, i32, ptr], i32
    lib.nerf_probe_runs.argtypes, lib.nerf_probe_runs.restype = [ptr, i64, i32, i64, ptr, ptr], i32
    lib.nerf_probe_runs_threads.argtypes, lib.nerf_probe_runs_threads.restype = [i64, i32], i64
    return lib


def run_probes(lib, tables, turns):
    """Time the probes over buffers of the tables' sizes; one JSON line per
    probe and turn, with the requests it made and their rate."""
    device = tables[0].device
    buffers = [torch.zeros_like(t) for t in tables]
    args = ProbeArgs()
    for level, buf in enumerate(buffers):
        args.table[level], args.rows[level] = buf.data_ptr(), buf.shape[0]
    items = PROBE_LEVELS // 2
    read_threads, atomic_threads = POINTS * items, STEP_POINTS * items
    out = torch.empty(read_threads, dtype=torch.float32, device=device)

    def launch(fn, *rest):
        err = fn(ctypes.byref(args), *rest, build.current_stream(device))
        if err != 0:
            raise RuntimeError(f"probe launch failed: cudaError {err}")

    probes = {
        # name: (call, requests it makes)
        "random sector reads": (lambda: launch(lib.nerf_probe_reads, read_threads, 0, out.data_ptr()),
                                read_threads * 16),
        "random sector reads, pair loads": (
            lambda: launch(lib.nerf_probe_reads, read_threads, 1, out.data_ptr()), read_threads * 12),
        "random vector atomics v2": (lambda: launch(lib.nerf_probe_atomics, atomic_threads, 2),
                                     atomic_threads * 16),
        "random vector atomics v4": (lambda: launch(lib.nerf_probe_atomics, atomic_threads, 4),
                                     atomic_threads * 16),
    }
    for turn in range(turns):
        for name, (call, requests) in probes.items():
            ms = cuda_ms(call)
            print(json.dumps(dict(probe=name, turn=turn, ms=ms, requests=requests,
                                  giga_requests_per_s=requests / ms / 1e6)), flush=True)


def request_counts(points, grids, sizes, bbox):
    """What these points ask of the card, per point: the encode's loads
    (pair loads at F = 2) and the 32-byte sectors they touch once the lanes
    of one instruction merge, with 32 consecutive points of a level in a
    warp and with 4; and the table-gradient kernel's atomics, one per
    corner row, with pair atomics, and with run combining on top (warps of
    32 consecutive points with at least 8 lanes that continue a run)."""
    idx, _ = kh.hashgrid_corners_cuda(points, grids, sizes, *bbox, False)
    n = len(points)
    point = torch.arange(n, device=points.device)[:, None]
    loads = merged_32 = merged_4 = paired = combined = 0
    for rows in idx:  # [n, 8] rows of one level
        first, second = rows[:, :4].long(), rows[:, 4:].long()
        alone = (first >> 1) != (second >> 1)  # corner c + 4 lies outside corner c's pair of rows
        sectors = torch.cat([first >> 2, torch.where(alone, second >> 2, -1)], dim=1)
        loads += int((sectors >= 0).sum())
        for lanes in (32, 4):
            keys = ((point // lanes) << 32 | sectors)[sectors >= 0]
            count = int(torch.unique(keys).numel())
            merged_32, merged_4 = (merged_32 + count, merged_4) if lanes == 32 else (merged_32, merged_4 + count)
        atomics = 8 - ((first ^ second) == 1).sum(dim=1)  # of one lane
        same = torch.zeros(n, dtype=torch.bool, device=points.device)
        same[1:] = (rows[1:] == rows[:-1]).all(dim=1)  # the same cell as the point before
        same[::32] = False
        combines = same.view(-1, 32).sum(dim=1, keepdim=True) >= 8
        adding = ~(same.view(-1, 32) & combines).view(-1)
        paired, combined = paired + int(atomics.sum()), combined + int(atomics[adding].sum())
    return dict(loads_per_point=loads / n, sectors_per_point_32_lanes=merged_32 / n,
                sectors_per_point_4_lanes=merged_4 / n, row_atomics_per_point=8 * len(idx),
                pair_atomics_per_point=paired / n, combined_atomics_per_point=combined / n)


def ray_points(rng, rays, samples, spacing, lo, hi):
    """``rays * samples`` f32 points, ray-major, as the renderers feed them:
    each ray's samples ``spacing`` apart from an origin drawn in
    ``[lo, hi]^3``."""
    origins = rng.uniform(lo, hi, (rays, 1, 3))
    dirs = rng.randn(rays, 1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (origins + spacing * dirs * np.arange(samples)[:, None]).reshape(-1, 3).astype(np.float32)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", help=f"any of {list(VARIANTS)} (default: all)")
    parser.add_argument("--turns", type=int, default=3, help="turns over the variants")
    parser.add_argument("--no-probes", action="store_true", help="skip the access-pattern probes")
    args = parser.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("hashgrid_ablations: no CUDA device; the ablations run on the card")
    device = torch.device("cuda")
    names = ["as built", *[v for v in args.variants or VARIANTS if v != "as built"]]
    build.library()  # the as-built kernels' checks run against the library they launch
    libs = build_variants(names, VARIANTS)
    probes = None if args.no_probes else build_probes()

    rng = np.random.RandomState(0)
    on_card = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    grids = [2 ** (4 + i // 2) for i in range(16)]
    sizes = [1 << 18] * 16
    tables = [on_card(rng.uniform(-1, 1, (dense_level_rows(g, t), 2))) for g, t in zip(grids, sizes)]
    bbox = (-0.7,) * 3, (0.7,) * 3
    x = on_card(rng.uniform(-0.75, 0.75, (POINTS, 3)))
    rays = on_card(ray_points(rng, RAYS, POINTS // RAYS, 0.01, -0.7, 0.7))
    table = tables[-1]
    idx = torch.from_numpy(rng.randint(0, 1 << 18, 999_424).astype(np.int32)).to(device)

    step_x = x[:STEP_POINTS].contiguous()
    step_rays = on_card(ray_points(rng, STEP_RAYS, STEP_SAMPLES, 0.02, -0.7, 0.4))
    step_g = on_card(rng.uniform(-1, 1, (STEP_POINTS, 2 * len(grids))))

    def encode(points):
        return lambda: ke.hashgrid_encode_cuda(tables, points, grids, sizes, *bbox, False)

    def backward(points):
        return lambda: kb.hashgrid_backward_cuda(
            points, step_g, ke.encode_args(tables, points.device, grids, sizes, *bbox, False))

    def worst(got, want):
        return max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))

    built, per_item = build._library, ke.LEVELS_PER_ITEM
    encoded = [encode(p)() for p in (x, rays)]
    summed = [[g.clone() for g in backward(p)()] for p in (step_x, step_rays)]
    try:
        for turn in range(args.turns):
            for name in names:
                build._library = libs[name]  # the wrappers launch from this library
                ke.LEVELS_PER_ITEM = 1 if "single-level items" in name else per_item
                ke._args_cache.clear()
                result = dict(
                    variant=name, turn=turn,
                    encode_random_ms=cuda_ms(encode(x)), encode_rays_ms=cuda_ms(encode(rays)),
                    encode_step_random_ms=cuda_ms(encode(step_x)),
                    encode_step_rays_ms=cuda_ms(encode(step_rays)),
                    backward_random_ms=graph_ms(backward(step_x), 20),
                    backward_rays_ms=graph_ms(backward(step_rays), 20),
                    gather_us=graph_ms(lambda: tg.table_gather_cuda(table, idx)) * 1e3,
                )
                if turn == 0:
                    result["encode_equals_as_built"] = all(
                        torch.equal(encode(p)(), want) for p, want in zip((x, rays), encoded))
                    result["backward_max_rel_diff"] = max(
                        worst(backward(p)(), want) for p, want in zip((step_x, step_rays), summed))
                print(json.dumps(result), flush=True)
    finally:
        build._library, ke.LEVELS_PER_ITEM = built, per_item
        ke._args_cache.clear()
    if probes is not None:
        run_probes(probes, tables, args.turns)
        for name, points in (("2^20 random points", x), ("2^20 points along rays", rays),
                             ("a step's random points", step_x), ("a step's points along rays", step_rays)):
            print(json.dumps(dict(points=name, **request_counts(points, grids, sizes, bbox))), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
