"""Which row-gather formulation is fastest on the card: the port of
``tools/exp_gather.py``.

At the JAX tool's shapes, 1,000,000 int32 indices into a [2^18, 2] f32
table (one hash-grid level), each formulation's device time per call:

* ``index_select`` (``jnp.take``'s counterpart);
* ``table[idx]``;
* the lane-axis take: ``table.T[:, idx].T``;
* the [M/8, 8] index shape: ``table[idx.view(-1, 8)]``;
* ``table_gather`` (the port's kernel, ``kernels/table_gather.py``) at
  999,424 indices, ``pallas_gather``'s 122 tiles of 8192, by the route it
  picks from the table's shape;

and on a 4,096-row table: the bf16 one-hot matmul, and the plain take.
Every formulation's rows are checked against ``index_select`` (the
one-hot matmul's after bf16 rounding of the table).

On the card (the default) the times come from CUDA events around a CUDA
graph of 20 calls (``scripts/timing.graph_ms``), the one-hot matmul's,
whose one-hot matrix takes 8 GB, from 3 eager calls; the card's name and
power limit come first.  ``--device cpu`` runs the same formulations on
the CPU at a size given by ``--indices`` and prints host seconds.

    python -m learn_nerf_tpu_torch.scripts.exp_gather [--device cpu] [--indices N]
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..kernels import table_gather as tg
from .timing import cuda_ms, graph_ms

TABLE_ROWS, SMALL_ROWS = 1 << 18, 4096
TILE = 8192  # pallas_gather's tile of indices


def formulations(table, small, idx):
    """``{name: (call, the rows it must equal)}`` at these inputs."""
    n = idx.shape[0] - idx.shape[0] % TILE or idx.shape[0]
    small_idx = idx % SMALL_ROWS
    table_t = table.t().contiguous()
    idx8 = idx[: idx.shape[0] - idx.shape[0] % 8].view(-1, 8)
    route = tg.gather_route(*table.shape)
    how = f"{route} route" if table.is_cuda else "its plain version on the CPU"
    small_bf16 = small.to(torch.bfloat16)

    def one_hot():
        hot = torch.zeros((small_idx.shape[0], SMALL_ROWS), dtype=torch.bfloat16, device=small.device)
        hot.scatter_(1, small_idx[:, None].long(), 1.0)
        return hot @ small_bf16

    wide = idx.long()
    return {
        "index_select": (lambda: table.index_select(0, idx), table.index_select(0, idx)),
        "table[idx]": (lambda: table[wide], table.index_select(0, idx)),
        "lane-axis take": (lambda: table_t[:, wide].t(), table.index_select(0, idx)),
        "take [M/8, 8]": (lambda: table[idx8.long()], table.index_select(0, idx8.reshape(-1)).view(-1, 8, 2)),
        f"table_gather ({how}, {n} indices)": (
            lambda: tg.table_gather(table, idx[:n]), table.index_select(0, idx[:n])),
        f"one-hot matmul bf16 ({SMALL_ROWS} rows)": (one_hot, small_bf16.index_select(0, small_idx).float()),
        f"take ({SMALL_ROWS} rows)": (lambda: small.index_select(0, small_idx), small.index_select(0, small_idx)),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="where to run (default: the card)")
    parser.add_argument("--indices", type=int, default=1_000_000, help="gather count (the JAX tool's: 1,000,000)")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("exp_gather: no CUDA device; pass --device cpu to run on the CPU")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60)
        print(f"device: {card.stdout.strip().splitlines()[0]}", flush=True)
    device = torch.device(args.device)
    rng = np.random.RandomState(0)
    table = torch.from_numpy(rng.randn(TABLE_ROWS, 2).astype(np.float32)).to(device)
    idx = torch.from_numpy(rng.randint(0, TABLE_ROWS, args.indices).astype(np.int32)).to(device)
    small = torch.from_numpy(rng.randn(SMALL_ROWS, 2).astype(np.float32)).to(device)
    results = {}
    for name, (call, want) in formulations(table, small, idx).items():
        got = call()
        if not torch.equal(got.float(), want):
            raise SystemExit(f"exp_gather: {name} disagrees with index_select")
        if args.device == "cuda":
            ms = cuda_ms(call, 3) if name.startswith("one-hot") else graph_ms(call, 20)
            results[name] = ms
            print(f"{name}: {ms:.4f} ms", flush=True)
        else:
            start = time.perf_counter()
            call()
            results[name] = time.perf_counter() - start
            print(f"{name}: {results[name]:.4f} s on the host (CPU)", flush=True)
        del got
    unit = "device_ms" if args.device == "cuda" else "cpu_host_s"
    print(json.dumps({"indices": args.indices, unit: results}))


if __name__ == "__main__":
    main()
