"""Convert an original-NeRF Blender-synthetic dataset to this repo's format
(port of ``learn_nerf_tpu.convert.blender``, which writes the same files).

Camera axes map OpenGL -> this convention as ``x = R @ [1,0,0]``,
``y = R @ [0,-1,0]``, ``z = R @ [0,0,-1]``; ``y_fov`` is derived from
``x_fov`` by the aspect ratio; the bbox is fixed at ``[-1, 1]^3``.

Usage: python -m learn_nerf_tpu_torch.convert.blender --split train|test src dst
"""

import argparse
import json
import math
import os
import shutil

import numpy as np
from PIL import Image


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("input_dir", type=str)
    parser.add_argument("output_dir", type=str)
    args = parser.parse_args(argv)

    if os.path.exists(args.output_dir):
        raise FileExistsError(f"output path exists: {args.output_dir}")
    os.mkdir(args.output_dir)

    with open(os.path.join(args.input_dir, f"transforms_{args.split}.json")) as f:
        info = json.load(f)

    x_fov = info["camera_angle_x"]
    for i, frame in enumerate(info["frames"]):
        img_path = os.path.join(args.input_dir, frame["file_path"] + ".png")
        width, height = Image.open(img_path).size

        pose = np.asarray(frame["transform_matrix"], dtype=np.float64)
        # OpenGL camera-to-world: columns of the rotation block are the
        # camera's right/up/backward axes; this repo's convention keeps
        # right but flips up (y down) and backward (z forward).
        camera = dict(
            origin=pose[:3, 3].tolist(),
            x=pose[:3, 0].tolist(),
            y=(-pose[:3, 1]).tolist(),
            z=(-pose[:3, 2]).tolist(),
            x_fov=x_fov,
            y_fov=2 * math.atan(math.tan(x_fov / 2) * height / width),
        )
        out_base = os.path.join(args.output_dir, f"{i:04}")
        with open(out_base + ".json", "w") as f:
            json.dump(camera, f)
        shutil.copyfile(img_path, out_base + ".png")

    with open(os.path.join(args.output_dir, "metadata.json"), "w") as f:
        json.dump(dict(min=[-1.0] * 3, max=[1.0] * 3), f)


if __name__ == "__main__":
    main()
