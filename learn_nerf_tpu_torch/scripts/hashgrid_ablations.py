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

Those five change table_gather's L2 route.  Its block route (the table in
every block's shared memory, ``csrc/table_gather.cu``) has variants of its
own, and so has the kernel that holds the table across a thread block
cluster (``csrc/ablations/table_gather_cluster.cu``, which the wrapper
gives no table):

* ``gather parent``: the kernel before the block route
  (``csrc/ablations/table_gather_parent.cu``: every table through L2);
* ``gather bulk fill``: the shared memory filled by bulk copies on an
  mbarrier (as built: 16-byte vector loads by every thread);
* ``gather one tile in flight``: a thread loads the next tile's indices
  after this tile's rows, not before;
* ``gather 4 in flight``, ``gather 16 in flight``: rows in flight a thread
  (as built: 8);
* ``gather 512 threads``, ``gather 128 threads``: other blocks (as built:
  256);
* ``gather cluster 16``: the cluster kernel, contiguous slices of 2^k rows
  on clusters of up to 16 blocks, which hold pallas_gather's whole table;
* ``gather cluster 8``: clusters of at most 8 blocks, which hold as much of
  the table as 8 slices do; the rows past them are read from L2;
* ``gather interleaved slices``: row j in block j % Q at j / Q, the slices
  filled by 4-byte loads.

Every gather variant is built from its one source alone, held bit for bit
to the kernel as built and timed by CUDA-graph replay at 999,424 indices:
[4096, 2] on the block route and on the L2 route, pallas_gather's [2^18,
2] (the L2 route, the wrapper's pick; the cluster variants' only shape),
and [2^21, 2] (L2).  Then a sweep of table sizes at C = 2, each on every
route that holds it (L2, the whole table in a block, slices on clusters of
2-16), in turns (L2 first and last): the measurement behind the wrapper's
threshold.

Then the card's own rate for the access patterns that bound the kernels
(``csrc/ablations/probes.cu``): as many random 8-byte row reads as
the encode makes at 2^20 points x 16 levels over buffers of the tables'
sizes, every read in its own sector and with the encode's pair loads, and
as many random vector atomics of 2 and of 4 floats as the table-gradient
kernel adds rows at a train step's shape; random 8-byte reads from a
block's own shared memory and from any block's of a cluster of 2, 4, 8 and
16 (distributed shared memory), each block holding 128 KiB; and the time
to fill the shared memory of every block of the persistent grid from an
L2-resident table (a 128 KiB slice a block on clusters of 16, a 32 KiB
table in one block a SM).  And what the points
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
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build
from ..kernels import hashgrid as kh
from ..kernels import hashgrid_backward as kb
from ..kernels import hashgrid_encode as ke
from ..kernels import table_gather as tg
from ..ops.hashgrid import dense_level_rows
from .mlp_ablations import build_variants, variant_sources
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


GATHER = "table_gather.cu"


def gather_layout(body, grid):
    return [(GATHER, GATHER_BODY, body), (GATHER, GATHER_GRID, grid)]


def resident(old, new):
    """An edit of one of the block route's constants."""
    return [(GATHER, f"constexpr {old};", f"constexpr {new};")]


# The block route's fill as built, and the bulk copies on an mbarrier put
# in its place.
VECTOR_FILL = """\
  for (long long k = threadIdx.x; k < whole / 4; k += kResidentThreads) {
    reinterpret_cast<float4*>(shared)[k] = __ldg(reinterpret_cast<const float4*>(table) + k);
  }
  for (long long k = whole + threadIdx.x; k < n; k += kResidentThreads) shared[k] = __ldg(table + k);
"""
BULK_FILL = """\
  __shared__ uint64_t filled;
  if (whole > 0) {
    if (threadIdx.x == 0) {
      mbar_init(&filled, 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const uint32_t bytes = static_cast<uint32_t>(whole * 4);
      if (threadIdx.x == 0) mbar_arrive_expect_tx(&filled, bytes);
      __syncwarp();
      for (uint32_t off = threadIdx.x * 16384u; off < bytes; off += 32 * 16384u) {
        const uint32_t chunk = bytes - off < 16384u ? bytes - off : 16384u;
        bulk_load(reinterpret_cast<char*>(shared) + off, reinterpret_cast<const char*>(table) + off, chunk, &filled);
      }
    }
  }
  for (long long k = whole + threadIdx.x; k < n; k += kResidentThreads) shared[k] = __ldg(table + k);
  if (whole > 0) mbar_wait(&filled, 0);
"""
# The block route's next-tile load as built, and moved after the stores.
NEXT_TILE = "    load_tile(next, idx, m, tile + gridDim.x);  // in flight while this tile's rows are read\n"
NEXT_HELD = "#pragma unroll\n    for (int u = 0; u < kInFlight; ++u) held[u] = next[u];\n"

CLUSTER = [(GATHER, None, "ablations/table_gather_cluster.cu")]
# The cluster kernel's slices as built (contiguous, 2^k rows) and
# interleaved: row j in block j % Q at j / Q.
CONTIGUOUS_FILL = """\
  const long long first = rank * slice_rows;
  const long long count = first >= rows ? 0 : rows - first < slice_rows ? rows - first : slice_rows;
  const float* src = table + first * C;
  const long long n = count * C;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const long long whole = aligned ? n & ~3ll : 0;  // floats in whole 16-byte chunks
  for (long long k = threadIdx.x; k < whole / 4; k += kResidentThreads) {
    reinterpret_cast<float4*>(slice)[k] = __ldg(reinterpret_cast<const float4*>(src) + k);
  }
  for (long long k = whole + threadIdx.x; k < n; k += kResidentThreads) slice[k] = __ldg(src + k);
"""
INTERLEAVED_FILL = """\
  for (long long k = threadIdx.x; k < slice_rows; k += kResidentThreads) {
    const long long row = k * ranks + rank;
    if (row < rows) {
#pragma unroll
      for (int c = 0; c < C; ++c) slice[k * C + c] = __ldg(table + row * C + c);
    }
  }
"""
CONTIGUOUS_ROW = ("  unsigned int rank = row >> slice_shift;\n"
                  "  const unsigned int offset = row & ((1u << slice_shift) - 1);\n")
INTERLEAVED_ROW = "  unsigned int rank = row % ranks;\n  const unsigned int offset = row / ranks;\n"

# A deliberate fault, never a variant: the cluster kernel reading every
# row from the slice of the next block of the cluster.  chip_smoke.py
# holds that the equality check catches it.
NEIGHBOUR_SLICE = CLUSTER + [(GATHER, "  if (rank >= ranks) return load_row<C>(table, row);",
                              "  rank = (rank + 1) % ranks;\n  if (rank >= ranks) return load_row<C>(table, row);")]


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
    "gather parent": [(GATHER, None, "ablations/table_gather_parent.cu")],
    "gather bulk fill": [(GATHER, '#include "gather.cuh"\n', '#include "gather.cuh"\n#include "sm90.cuh"\n'),
                         (GATHER, VECTOR_FILL, BULK_FILL)],
    "gather one tile in flight": [(GATHER, NEXT_TILE, ""), (GATHER, NEXT_HELD, NEXT_TILE + NEXT_HELD)],
    "gather 4 in flight": resident("int kInFlight = 8", "int kInFlight = 4"),
    "gather 16 in flight": resident("int kInFlight = 8", "int kInFlight = 16"),
    "gather 512 threads": resident("int kResidentThreads = 256", "int kResidentThreads = 512"),
    "gather 128 threads": resident("int kResidentThreads = 256", "int kResidentThreads = 128"),
    "gather cluster 16": CLUSTER,
    "gather cluster 8": CLUSTER + resident("int kMaxRanks = 16", "int kMaxRanks = 8"),
    "gather interleaved slices": CLUSTER + [(GATHER, CONTIGUOUS_FILL, INTERLEAVED_FILL),
                                            (GATHER, CONTIGUOUS_ROW, INTERLEAVED_ROW)],
}
# 999,424 indices (pallas_gather's 122 tiles of 8192) on each route's
# shape: name -> (rows, C, the route of the built kernel and its variants,
# or None for the one gather_route picks).  The cluster variants run at
# the shapes the cluster kernel holds past the block route.
GATHER_INDICES = 999_424
GATHER_SHAPES = {
    "[4096, 2]": (4096, 2, None),
    "[4096, 2] on L2": (4096, 2, "l2"),
    "[2^18, 2]": (1 << 18, 2, None),
    "[2^21, 2]": (1 << 21, 2, None),
}
# The cluster kernel: slices of at most SLICE_BYTES, a power of two of rows
# (16 of them hold pallas_gather's [2^18, 2] table), on clusters of up to
# LARGEST_CLUSTER blocks (the largest Hopper launches, a non-portable size).
SLICE_BYTES = 128 << 10
LARGEST_CLUSTER = 16
CLUSTER_VARIANT = "gather cluster 16"
# Table rows of the sweep at C = 2: 16 KiB to 2 MiB.
SWEEP_ROWS = (2048, 4096, 8192, 16384, 24576, 32768, 65536, 131072, 1 << 18)
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
    lib.nerf_probe_empty.argtypes, lib.nerf_probe_empty.restype = [i64, i32, ptr], i32
    lib.nerf_probe_shared_blocks.argtypes, lib.nerf_probe_shared_blocks.restype = [i32, i32, i64], i64
    lib.nerf_probe_shared_reads.argtypes, lib.nerf_probe_shared_reads.restype = [], i64
    lib.nerf_probe_shared.argtypes, lib.nerf_probe_shared.restype = [i32, i64, ptr, ptr], i32
    lib.nerf_probe_fill.argtypes, lib.nerf_probe_fill.restype = [ptr, i64, i32, i64, ptr], i32
    return lib


SHARED_CLUSTERS = (1, 2, 4, 8, 16)  # 1: a block's own shared memory
SHARED_FILLS = {"128 KiB a block, clusters of 16": (16, 128 << 10),
                "32 KiB a block, one block a SM": (1, 32 << 10)}


def shared_probes(lib, device):
    """The card's rate for random 8-byte shared-memory reads (G reads/s, by
    cluster size; 1: the block's own) and the µs to fill every block of
    the persistent grid from an L2-resident table (graph replay), with the
    blocks each probe ran."""

    def grid(kind, cluster, nbytes):
        blocks = lib.nerf_probe_shared_blocks(kind, cluster, nbytes)
        if blocks <= 0:
            raise RuntimeError(f"the shared-memory probe cannot place clusters of {cluster}: {blocks}")
        return blocks

    def checked(err):
        if err != 0:
            raise RuntimeError(f"probe launch failed: cudaError {err}")

    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    stream = build.current_stream(device)
    reads = {}
    for cluster in SHARED_CLUSTERS:
        blocks = grid(0, cluster, 0)
        out = torch.empty(blocks * 512, dtype=torch.int32, device=device)
        ms = cuda_ms(lambda: checked(lib.nerf_probe_shared(cluster, blocks, out.data_ptr(), stream)))
        count = blocks * lib.nerf_probe_shared_reads()
        reads[cluster] = dict(blocks=blocks, reads=count, ms=ms, giga_reads_per_s=count / ms / 1e6)
    fills = {}
    for name, (cluster, nbytes) in SHARED_FILLS.items():
        blocks = grid(1, cluster, nbytes)
        table = torch.zeros(cluster * nbytes // 4, dtype=torch.float32, device=device)
        us = 1e3 * graph_ms(lambda: checked(lib.nerf_probe_fill(table.data_ptr(), nbytes, cluster, blocks,
                                                                 build.current_stream(device))))
        fills[name] = dict(blocks=blocks, bytes=blocks * nbytes, us=us, tb_per_s=blocks * nbytes / us / 1e6)
    return dict(reads=reads, fills=fills)


def sector_us(lib, rows, reads, device):
    """µs of ``reads`` random 8-byte row reads, each in its own sector, over
    a [rows, 2] f32 buffer (the probe of the encode's reads, every level on
    this buffer; graph replay)."""
    buf = torch.zeros((rows, 2), dtype=torch.float32, device=device)
    args = ProbeArgs()
    for level in range(PROBE_LEVELS):
        args.table[level], args.rows[level] = buf.data_ptr(), rows
    threads = reads // 16
    out = torch.empty(threads, dtype=torch.float32, device=device)

    def call():
        err = lib.nerf_probe_reads(ctypes.byref(args), threads, 0, out.data_ptr(), build.current_stream(buf.device))
        if err != 0:
            raise RuntimeError(f"probe launch failed: cudaError {err}")

    return 1e3 * graph_ms(call)


def build_gather_libraries(names, variants=VARIANTS):
    """Compile each variant's ``table_gather.cu`` alone into its own
    library, all at once; ``{name: library}`` (the parent's entry point is
    ``nerf_table_gather_parent``, the cluster kernel's
    ``nerf_table_gather_cluster``)."""
    root = build.BUILD_DIR / "ablations" / "gather"
    procs = {}
    for name in names:
        out = root / name.replace(" ", "_").replace(",", "")
        variant_sources(out, name, variants[name])
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out / "libgather.so"), str(out / GATHER)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / "libgather.so"))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if hasattr(lib, "nerf_table_gather_parent"):
            lib.nerf_table_gather_parent.argtypes = [p, i64, i32, p, i64, p, p]
            lib.nerf_table_gather_parent.restype = i32
        elif hasattr(lib, "nerf_table_gather_cluster"):
            lib.nerf_table_gather_cluster.argtypes = [p, i64, i32, p, i64, p, i32, i32, p]
            lib.nerf_table_gather_cluster.restype = i32
            lib.nerf_table_gather_cluster_placement.argtypes = [i64, i32, i32, i32, p]
            lib.nerf_table_gather_cluster_placement.restype = i32
        else:
            build.bind_table_gather(lib)
        libs[name] = lib
    return libs


class ClusterRoute(NamedTuple):
    """How the cluster kernel holds a table: ``cluster`` blocks of
    ``slice_rows`` rows each (a power of two)."""

    cluster: int
    slice_rows: int

    @property
    def slice_shift(self) -> int:
        return self.slice_rows.bit_length() - 1


def cluster_route(rows, columns):
    """The smallest cluster of 2 to LARGEST_CLUSTER blocks whose slices of
    at most ``SLICE_BYTES`` hold a ``[rows, columns]`` table, each a slice
    of the fewest rows (a power of two) from which they cover it; None
    where no such cluster holds it."""
    most = 1 << ((SLICE_BYTES // (4 * columns)).bit_length() - 1)  # a slice's rows at most
    cluster = max(2, -(-rows // most))
    if rows < 1 or cluster > LARGEST_CLUSTER:
        return None
    return ClusterRoute(cluster, 1 << (-(-rows // cluster) - 1).bit_length())


def cluster_placement(lib, rows, columns, route):
    """Clusters of ``route`` that the card runs at once, by the cluster
    kernel's library ``lib``; raises where none fits."""
    count = ctypes.c_int(0)
    err = lib.nerf_table_gather_cluster_placement(rows, columns, route.cluster, route.slice_shift, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"table_gather: the card refused the placement query of {route} (cudaError {err})")
    if count.value == 0:
        raise RuntimeError(f"table_gather: the card cannot place {route} for a [{rows}, {columns}] table")
    return count.value


def gather_with(lib):
    """``(table, idx, route) -> rows`` by the kernel of ``lib`` (a library
    of :func:`build_gather_libraries`; None: the built one), adding nothing
    to the wrapper's launch count.  ``route`` is "block" or "l2" for the
    built kernel and its variants, a :class:`ClusterRoute` for the cluster
    kernel's; the parent has one route, L2, for every table."""
    if lib is None or hasattr(lib, "nerf_table_gather"):
        return lambda table, idx, route: tg.launch_route(table, idx, route, lib)

    def launch(table, idx, route):
        out = torch.empty((idx.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
        if not idx.shape[0]:
            return out
        args = (table.data_ptr(), table.shape[0], table.shape[1], idx.data_ptr(), idx.shape[0], out.data_ptr())
        stream = build.current_stream(table.device)
        if hasattr(lib, "nerf_table_gather_parent"):
            err, what = lib.nerf_table_gather_parent(*args, stream), "the parent table_gather"
        else:
            err = lib.nerf_table_gather_cluster(*args, route.cluster, route.slice_shift, stream)
            what = f"the cluster table_gather ({route})"
        build.check_launch(build.library(), err, what)
        return out

    return launch


def gather_inputs(rng, rows, columns, m, device):
    """A [rows, columns] f32 table of U(-1, 1) and m int32 indices in
    range, made on the host from ``rng``."""
    table = torch.from_numpy(rng.uniform(-1, 1, (rows, columns)).astype(np.float32)).to(device)
    return table, torch.from_numpy(rng.randint(0, rows, m).astype(np.int32)).to(device)


def sweep_routes(rows, columns=2):
    """``{name: route}`` of every route that can hold a [rows, columns]
    table: L2, the whole table in a block (up to 224 KiB), slices on
    clusters of 2-16 (up to SLICE_BYTES a slice)."""
    routes = {"l2": "l2"}
    if rows * 4 * columns <= 224 << 10:
        routes["block"] = "block"
    for cluster in (2, 4, 8, 16):
        need = -(-rows // cluster)
        slice_rows = 1 << (need - 1).bit_length()
        if slice_rows * 4 * columns <= SLICE_BYTES and (cluster - 1) * slice_rows < rows:
            routes[f"cluster {cluster}"] = ClusterRoute(cluster, slice_rows)
    return routes


def variant_routes(lib):
    """``{shape: route}`` of GATHER_SHAPES that the kernel of ``lib`` takes:
    the cluster kernel's where it holds a table past the block route."""
    if lib is not None and hasattr(lib, "nerf_table_gather_cluster"):
        return {shape: cluster_route(rows, c) for shape, (rows, c, _) in GATHER_SHAPES.items()
                if tg.gather_route(rows, c) == "l2" and cluster_route(rows, c)}
    return {shape: route or tg.gather_route(rows, c) for shape, (rows, c, route) in GATHER_SHAPES.items()}


def run_gathers(names, libs, device, turns):
    """One JSON line per gather variant and turn (µs at each of its
    GATHER_SHAPES, graph replay; on turn 0 whether its rows equal the
    kernel as built's), then one per table size of the sweep and turn
    (its cluster routes by ``libs[CLUSTER_VARIANT]``)."""
    rng = np.random.RandomState(1)
    inputs = {shape: gather_inputs(rng, rows, c, GATHER_INDICES, device) for shape, (rows, c, _) in GATHER_SHAPES.items()}
    built = {shape: tg.launch_route(*inputs[shape], route) for shape, route in variant_routes(None).items()}
    for turn in range(turns):
        for name in names:
            fn, routes = gather_with(libs.get(name)), variant_routes(libs.get(name))
            result = dict(variant=name, turn=turn, **{
                f"{shape} us": 1e3 * graph_ms(lambda: fn(*inputs[shape], route)) for shape, route in routes.items()})
            if turn == 0:
                result["equals_as_built"] = all(torch.equal(fn(*inputs[shape], route), built[shape])
                                                for shape, route in routes.items())
            print(json.dumps(result), flush=True)
    with_route = {"l2": gather_with(None), "block": gather_with(None)}
    clustered = gather_with(libs[CLUSTER_VARIANT])
    for turn in range(turns):
        for rows in SWEEP_ROWS:
            table, idx = gather_inputs(rng, rows, 2, GATHER_INDICES, device)
            routes = sweep_routes(rows)
            times = {name: [] for name in routes}
            for name in [*routes, *reversed(routes)]:  # in turns: the L2 route first and last
                fn = with_route.get(name, clustered)
                times[name].append(1e3 * graph_ms(lambda: fn(table, idx, routes[name])))
            print(json.dumps(dict(sweep=f"[{rows}, 2] x {GATHER_INDICES}", turn=turn, route=tg.gather_route(rows, 2),
                                  us={name: sum(t) / 2 for name, t in times.items()}, turns_us=times)), flush=True)


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
        rates = shared_probes(lib, device)
        for cluster, r in rates["reads"].items():
            where = "own shared memory" if cluster == 1 else f"shared memory of a cluster of {cluster}"
            print(json.dumps(dict(probe=f"random 8-byte reads, {where}", turn=turn, **r)), flush=True)
        for name, r in rates["fills"].items():
            print(json.dumps(dict(probe=f"shared-memory fill from L2, {name}", turn=turn, **r)), flush=True)


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
    gathers = [name for name in names if name.startswith("gather")]
    names = [name for name in names if name not in gathers]
    if args.variants and names == ["as built"] and gathers:
        names = []  # only gather variants named: the hash-grid kernels are not timed
    build.library()  # the as-built kernels' checks run against the library they launch
    with ThreadPoolExecutor() as pool:
        gather_libs = pool.submit(build_gather_libraries, [*gathers, *{CLUSTER_VARIANT} - {*gathers}])  # the sweep's
        probes = None if args.no_probes else pool.submit(build_probes)
        libs = build_variants(names, VARIANTS)
        gather_libs, probes = gather_libs.result(), probes and probes.result()

    rng = np.random.RandomState(0)
    on_card = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    grids = [2 ** (4 + i // 2) for i in range(16)]
    sizes = [1 << 18] * 16
    tables = [on_card(rng.uniform(-1, 1, (dense_level_rows(g, t), 2))) for g, t in zip(grids, sizes)]
    bbox = (-0.7,) * 3, (0.7,) * 3
    x = on_card(rng.uniform(-0.75, 0.75, (POINTS, 3)))
    rays = on_card(ray_points(rng, RAYS, POINTS // RAYS, 0.01, -0.7, 0.7))
    rng.randint(0, 1 << 18, 999_424)  # drawn as before, so the train-step inputs below stay the same

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
    run_gathers(["as built", *gathers], gather_libs, device, args.turns)
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
