"""Run one cell of the benchmark and print its result as the last line of
standard output (one JSON object).

  python3 nerfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``learn_nerf_tpu_torch``, on a
machine with an NVIDIA card.  The program's kernel library is built into
the checkout (``learn_nerf_tpu_torch/_build``), and every other cache goes
to ``.nerfbench_cache/`` there, so only a checkout's first run builds.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".nerfbench_cache"


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0,
                        help="1: report the per-layer metrics from a traced run")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    # One OpenMP thread for the program's host-side copies: the host is shared,
    # and its work is single-threaded Python and NumPy either way.
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in manifest["workloads"]]
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {cells}", file=sys.stderr)
        return 2
    chips = next(w["chips"] for w in manifest["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s): the benchmark measures the program on them", file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    print(f"[{time.time() - T0:8.2f} s] torch imported, CUDA ready", file=sys.stderr, flush=True)
    from nerfbench import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T0, torch.device("cuda"))
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
