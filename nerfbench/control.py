"""Readings for the limits of ``correct``: for each seed, a cell's set-up
at its own size, its window (short: ``--seconds``), then the numbers the
check compares, read for the program, for the control (the reference in
the precision one step below the configuration's, put in the program's
place: TF32 for the f32 models, float8 e4m3 for the bf16 MLP) and for the
planted faults each cell can have (train cells: half of the batch left
out; frame cells: an answer altered where it is produced).  One JSON line
a seed; ``nerfbench/tests/test_control.py`` holds the same at a small size.

  python3 nerfbench/control.py --workload <cell> --seconds 2 --seeds 11 12 13
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(name: str, seed: int, seconds: float, device, overrides=None) -> dict:
    from nerfbench import harness

    cell = harness.resolve_cell(name, seed, device, time.time(), overrides=overrides)
    driver = harness.load_module(harness.BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py").Driver(cell)
    harness.f32_products()
    driver.setup()
    driver.window(seconds, False)
    driver.release()
    return dict(cell=name, seed=seed, **driver.readings())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, torch.device("cuda"))), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
