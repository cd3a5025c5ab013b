"""Distill a trained NeRF into a new RGBD dataset from random orbit views
(the CLI of ``learn_nerf_tpu.scripts.render_new_dataset``).

N random unit view directions at ``distance * |bbox|`` from the bbox
center, 60-degree FOV; writes ``{i:05}.json`` / ``.png`` / ``_depth.png``
and a copy of ``metadata.json``.  The poses come from
``np.random.RandomState(--seed)``, so a seed gives the JAX CLI's view JSONs.
Depth is ``clip(where(alpha > 0.9, <coords - origin, z> / (alpha + 1e-8),
max_depth), 0, max_depth) / max_depth``, a 16-bit PNG.  Renders through
:class:`~.render_nerf.RenderSession` with the frame's ``alphas`` and
``coords`` (the hierarchy's fine pass, or the occupancy path's), on the
CUDA card unless given ``--device cpu``.
"""

import argparse
import math
import os
import shutil

import numpy as np

from ..data.camera import CameraView
from ..utils.progress import progress
from .common import add_baked_args, add_device_arg, add_model_args, add_occupancy_args, to_u8_image
from .render_nerf import RenderSession


def argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=1024, help="rays per tile")
    parser.add_argument("--coarse_samples", type=int, default=64)
    parser.add_argument("--fine_samples", type=int, default=128)
    parser.add_argument("--num_images", type=int, default=100)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--distance", type=float, default=1.0)
    parser.add_argument("--max_depth", type=float, default=10.0)
    parser.add_argument("--model_path", type=str, default="nerf.pkl")
    add_model_args(parser)
    add_occupancy_args(parser)
    add_baked_args(parser)
    add_device_arg(parser)
    parser.add_argument("metadata_json", type=str)
    parser.add_argument("output_dir", type=str)
    return parser


def orbit_view(rng: np.random.RandomState, center: np.ndarray, scale: float, distance: float) -> CameraView:
    """One random view looking at ``center`` from ``distance * scale``."""
    z = rng.normal(size=(3,))
    z /= np.linalg.norm(z)
    x = np.array([z[1], -z[0], 0.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return CameraView(
        camera_direction=tuple(z.tolist()),
        camera_origin=tuple((-z * scale * distance + center).tolist()),
        x_axis=tuple(x.tolist()),
        y_axis=tuple(y.tolist()),
        x_fov=60.0 * math.pi / 180,
        y_fov=60.0 * math.pi / 180,
    )


def depth_image(view: CameraView, alphas: np.ndarray, coords: np.ndarray, max_depth: float) -> np.ndarray:
    """``[M, 1]`` depth in ``[0, 1]`` along the view direction, ``max_depth``
    (1.0) where the frame is not opaque (alpha <= 0.9)."""
    z_dir = np.asarray(view.camera_direction, np.float32)
    origin = np.asarray(view.camera_origin, np.float32)
    raw = ((coords - origin) @ z_dir)[:, None] / (alphas + 1e-8)
    return np.clip(np.where(alphas > 0.9, raw, max_depth), 0.0, max_depth) / max_depth


def main(argv=None):
    args = argparser().parse_args(argv)
    if os.path.exists(args.output_dir):
        raise FileExistsError(f"output directory exists: {args.output_dir}")
    from PIL import Image

    # RenderSession reads the render CLI's --width/--height only as a
    # default; every frame here is --size square.
    session = RenderSession(args, include_depth_outputs=True)
    metadata = session.metadata
    os.makedirs(args.output_dir)
    shutil.copy(args.metadata_json, os.path.join(args.output_dir, "metadata.json"))

    bbox_min = np.asarray(metadata.bbox_min)
    bbox_max = np.asarray(metadata.bbox_max)
    scale = float(np.linalg.norm(bbox_min - bbox_max))
    center = (bbox_min + bbox_max) / 2

    # Poses from the CLI seed: --seed N reproduces the distilled dataset's
    # views (fresh random poses without it).
    pose_rng = np.random.RandomState(args.seed)
    for frame in progress(range(args.num_images), desc="frames"):
        view = orbit_view(pose_rng, center, scale, args.distance)
        with open(os.path.join(args.output_dir, f"{frame:05}.json"), "w") as f:
            f.write(view.to_json())
        results = session.render_arrays(view, args.size, args.size)
        depth = depth_image(view, results["alphas"], results["coords"], args.max_depth)
        image = to_u8_image(results["outputs"], args.size, args.size)
        Image.fromarray(image).save(os.path.join(args.output_dir, f"{frame:05}.png"))
        depth_u16 = (depth.reshape(args.size, args.size) * 0xFFFF).astype(np.uint16)
        Image.fromarray(depth_u16).save(os.path.join(args.output_dir, f"{frame:05}_depth.png"))


if __name__ == "__main__":
    main()
