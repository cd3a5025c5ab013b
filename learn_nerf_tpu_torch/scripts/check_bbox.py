"""Validate that a dataset's bbox covers the scene content (the CLI of
``learn_nerf_tpu.scripts.check_bbox``): reports the (min, max, mean) colour
of the pixels whose rays *miss* the bbox (:func:`~..ops.geometry.
ray_bbox_range`); if those are not all background, the bbox is too small.
The slab test runs on the CUDA card unless given ``--device cpu`` (a flag
of this port only).
"""

import argparse

import numpy as np
import torch

from ..data.dataset import load_dataset
from ..ops.geometry import ray_bbox_range
from ..utils.progress import progress
from .common import add_device_arg, resolve_device


def argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_device_arg(parser)
    parser.add_argument("data_dir")
    return parser


def main(argv=None):
    args = argparser().parse_args(argv)
    device = resolve_device(args.device)
    dataset = load_dataset(args.data_dir)
    bbox_min = torch.tensor(dataset.metadata.bbox_min, dtype=torch.float32, device=device)
    bbox_max = torch.tensor(dataset.metadata.bbox_max, dtype=torch.float32, device=device)

    min_color = None
    max_color = None
    color_sum = np.zeros(3)
    total = 0
    for view in progress(dataset.views, desc="views"):
        colored = view.rays()
        rays = torch.from_numpy(colored[:, :2]).to(device)
        miss = ~ray_bbox_range(rays[:, 0], rays[:, 1], bbox_min, bbox_max)[2].cpu().numpy()
        colors = colored[miss, 2]
        if colors.shape[0] == 0:
            continue
        local_min = colors.min(axis=0)
        local_max = colors.max(axis=0)
        min_color = local_min if min_color is None else np.minimum(min_color, local_min)
        max_color = local_max if max_color is None else np.maximum(max_color, local_max)
        color_sum += colors.sum(axis=0)
        total += colors.shape[0]

    if total == 0:
        print("no rays missed the bounding box")
        return
    print("min color", min_color.tolist())
    print("max color", max_color.tolist())
    print("mean color", (color_sum / total).tolist())


if __name__ == "__main__":
    main()
