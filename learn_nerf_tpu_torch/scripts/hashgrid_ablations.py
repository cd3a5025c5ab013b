"""Where the hash-grid kernels spend their time, by ablation, on the card.

Builds variants of ``csrc/`` with one part of the design taken out or
changed, and times each beside the kernels as built, in turns: the encode
kernel on 2^20 points at the 16-level fine schedule (F = 2), on uniform
random points and on points along rays (8192 rays of 128 samples 0.01
apart, as a frame feeds it), and table_gather at ``pallas_gather``'s
[2^18, 2] x 999,424 by CUDA-graph replay.  Each variant computes the same
result:

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

Prints one JSON line per variant and turn, then the card's name and power
limit.  The variants build into ``learn_nerf_tpu_torch/_build/ablations/``.

    python -m learn_nerf_tpu_torch.scripts.hashgrid_ablations [--turns N] [variant ...]
"""

import argparse
import json
import subprocess

import numpy as np
import torch

from ..kernels import build
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


VARIANTS = {
    "as built": [],
    "no pair loads": [("hashgrid_encode.cu", "    if (paired) {", "    if (false) {")],
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", help=f"any of {list(VARIANTS)} (default: all)")
    parser.add_argument("--turns", type=int, default=3, help="turns over the variants")
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

    rng = np.random.RandomState(0)
    on_card = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    grids = [2 ** (4 + i // 2) for i in range(16)]
    sizes = [1 << 18] * 16
    tables = [on_card(rng.uniform(-1, 1, (dense_level_rows(g, t), 2))) for g, t in zip(grids, sizes)]
    bbox = (-0.7,) * 3, (0.7,) * 3
    x = on_card(rng.uniform(-0.75, 0.75, (POINTS, 3)))
    origins = rng.uniform(-0.7, 0.7, (RAYS, 1, 3))
    dirs = rng.randn(RAYS, 1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rays = on_card((origins + 0.01 * dirs * np.arange(POINTS // RAYS)[:, None]).reshape(-1, 3))
    table = tables[-1]
    idx = torch.from_numpy(rng.randint(0, 1 << 18, 999_424).astype(np.int32)).to(device)

    def encode(points):
        return lambda: ke.hashgrid_encode_cuda(tables, points, grids, sizes, *bbox, False)

    built, per_item = build._library, ke.LEVELS_PER_ITEM
    try:
        for turn in range(args.turns):
            for name in names:
                build._library = libs[name]  # the wrappers launch from this library
                ke.LEVELS_PER_ITEM = 1 if name == "single-level items" else per_item
                ke._args_cache.clear()
                result = dict(
                    variant=name, turn=turn,
                    encode_random_ms=cuda_ms(encode(x)), encode_rays_ms=cuda_ms(encode(rays)),
                    gather_us=graph_ms(lambda: tg.table_gather_cuda(table, idx)) * 1e3,
                )
                print(json.dumps(result), flush=True)
    finally:
        build._library, ke.LEVELS_PER_ITEM = built, per_item
        ke._args_cache.clear()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
