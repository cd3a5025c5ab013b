"""Convert an LLFF forward-facing dataset (``poses_bounds.npy``; port of
``learn_nerf_tpu.convert.llff``, which writes the same files).

The 3x5 pose decode, the bmild/nerf axis swap ``(x,y,z) = (y,-x,z)``
followed by the blender-style ``y,z`` negation, FOVs from the hwf focal, a
loose bbox as the union of ``pos +- z_far`` over all views, an optional
downscale factor, and a thread pool for image conversion.

Usage: python -m learn_nerf_tpu_torch.convert.llff [--factor F] src dst
"""

import argparse
import json
import os
from functools import partial
from multiprocessing.pool import ThreadPool
from typing import Tuple

import numpy as np
from PIL import Image


def decode_pose(pose_bound: np.ndarray):
    """Decode one poses_bounds row into this repo's camera JSON dict plus
    the view's loose bbox contribution (``pos +- z_far``).

    Axis mapping: bmild/nerf's load_llff.py swaps ``(x, y, z) <-
    (y, -x, z)``; composing with this repo's OpenGL flip (negate y and z,
    as in the blender converter) gives ``x <- y_in``, ``y <- x_in``,
    ``z <- -z_in``.
    """
    cols = pose_bound[:15].reshape(3, 5)
    height, width, focal = cols[:, 4]
    z_far = pose_bound[16]
    position = cols[:, 3]
    camera = dict(
        origin=position.tolist(),
        x_fov=float(2 * np.arctan2(width, 2 * focal)),
        y_fov=float(2 * np.arctan2(height, 2 * focal)),
        x=cols[:, 1].tolist(),
        y=cols[:, 0].tolist(),
        z=(-cols[:, 2]).tolist(),
    )
    return camera, position - z_far, position + z_far


def process_img(
    output_dir: str, factor: float, item: Tuple[int, Tuple[np.ndarray, str]]
):
    i, (pose_bound, img_path) = item
    camera, local_min, local_max = decode_pose(pose_bound)
    with open(os.path.join(output_dir, f"{i:05}.json"), "w") as f:
        json.dump(camera, f)

    img = Image.open(img_path).convert("RGB")
    if factor != 1.0:
        img = img.resize((round(img.width * factor), round(img.height * factor)))
    img.save(os.path.join(output_dir, f"{i:05}.png"))

    return local_min, local_max


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--factor", type=float, default=1.0)
    parser.add_argument("input_dir", type=str)
    parser.add_argument("output_dir", type=str)
    args = parser.parse_args(argv)

    img_dir = os.path.join(args.input_dir, "images")
    img_paths = [
        os.path.join(img_dir, x)
        for x in sorted(os.listdir(img_dir))
        if os.path.splitext(x)[1].lower() in [".jpg", ".jpeg", ".png"]
    ]
    pose_bounds = np.load(os.path.join(args.input_dir, "poses_bounds.npy"))
    assert len(pose_bounds) == len(img_paths), "image count must match pose count"

    os.makedirs(args.output_dir, exist_ok=True)
    bbox_min, bbox_max = None, None
    with ThreadPool(8) as p:
        for local_min, local_max in p.imap_unordered(
            partial(process_img, args.output_dir, args.factor),
            enumerate(zip(pose_bounds, img_paths)),
        ):
            if bbox_min is None:
                bbox_min, bbox_max = local_min, local_max
            else:
                bbox_min = np.minimum(bbox_min, local_min)
                bbox_max = np.maximum(bbox_max, local_max)

    with open(os.path.join(args.output_dir, "metadata.json"), "w") as f:
        json.dump(dict(min=bbox_min.tolist(), max=bbox_max.tolist()), f)


if __name__ == "__main__":
    main()
