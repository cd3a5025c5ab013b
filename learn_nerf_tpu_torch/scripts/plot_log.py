"""Plot one or more training logs saved as text files (the CLI of
``learn_nerf_tpu.scripts.plot_log``): parses the ``step i: k=v ...`` lines
both train CLIs print, with optional smoothing and a log scale;
``--output`` saves the figure headlessly.  Host only: matplotlib is
imported when the plot is drawn.
"""

import argparse
import os
from collections import defaultdict
from typing import Dict

import numpy as np


def label_for_path(path: str) -> str:
    name, _ = os.path.splitext(os.path.basename(path))
    return name.replace("_", " ")


def read_log(path: str) -> Dict[str, np.ndarray]:
    result = defaultdict(list)
    with open(path, "r") as f:
        for line in f:
            if not line.startswith("step"):
                continue
            for field in (x for x in line.split() if "=" in x):
                name, value = field.split("=")
                result[name].append(float(value))
    return {k: np.asarray(v) for k, v in result.items()}


def argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--field", type=str, default="fine")
    parser.add_argument("--log_scale", action="store_true")
    parser.add_argument("--smoothing", type=int, default=0)
    parser.add_argument(
        "--output", type=str, default=None, help="save the plot instead of showing it"
    )
    parser.add_argument("log_paths", nargs="+")
    return parser


def main(argv=None):
    args = argparser().parse_args(argv)

    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for path in args.log_paths:
        log = read_log(path)
        ys = log[args.field]
        xs = np.arange(len(ys))
        if args.smoothing:
            cut = (len(ys) // args.smoothing) * args.smoothing
            xs = xs[:cut].reshape(-1, args.smoothing).mean(axis=-1)
            ys = ys[:cut].reshape(-1, args.smoothing).mean(axis=-1)
        plt.plot(xs, ys, label=label_for_path(path))
    if args.log_scale:
        plt.yscale("log")
    plt.legend()
    plt.ylabel(args.field)
    plt.xlabel("step")
    if args.output:
        plt.savefig(args.output, dpi=120, bbox_inches="tight")
        print(f"wrote {args.output}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
