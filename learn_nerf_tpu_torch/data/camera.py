"""Pinhole camera model and ray generation (host-side NumPy).

The same geometry and JSON keys as ``learn_nerf_tpu.data.camera``: a camera
is an origin plus orthonormal x/y/z axes and two fields of view; the ray
grid spans ``tan(fov/2) * linspace(-1, 1)`` along each image axis added to
the view direction, normalized, in raster-scan order.  Kept as this
package's own copy so that the port runs with nothing of the JAX package
installed; ``tests/test_torch_ops.py`` holds the two to identical rays.
"""

import json
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

Vec3 = Tuple[float, float, float]


@dataclass
class CameraView:
    camera_direction: Vec3
    camera_origin: Vec3
    x_axis: Vec3
    y_axis: Vec3
    x_fov: float
    y_fov: float

    @classmethod
    def from_dict(cls, info: dict) -> "CameraView":
        """From the per-view JSON keys ``z, origin, x, y, x_fov, y_fov``."""
        return cls(
            camera_direction=tuple(info["z"]),
            camera_origin=tuple(info["origin"]),
            x_axis=tuple(info["x"]),
            y_axis=tuple(info["y"]),
            x_fov=float(info["x_fov"]),
            y_fov=float(info["y_fov"]),
        )

    @classmethod
    def from_json(cls, path: str) -> "CameraView":
        with open(path, "rb") as f:
            return cls.from_dict(json.load(f))

    def to_json(self) -> str:
        return json.dumps(
            dict(
                z=self.camera_direction,
                origin=self.camera_origin,
                x=self.x_axis,
                y=self.y_axis,
                x_fov=self.x_fov,
                y_fov=self.y_fov,
            )
        )

    def bare_rays(self, width: int, height: int) -> np.ndarray:
        """All rays of a ``width x height`` view in raster-scan order.

        :return: ``[H*W, 2, 3]`` float32 (origin, unit direction) pairs.
        """
        z = np.asarray(self.camera_direction, dtype=np.float32)
        ys = (
            math.tan(self.y_fov / 2)
            * np.linspace(-1, 1, num=height, dtype=np.float32)[:, None, None]
            * np.asarray(self.y_axis, dtype=np.float32)
        )
        xs = (
            math.tan(self.x_fov / 2)
            * np.linspace(-1, 1, num=width, dtype=np.float32)[None, :, None]
            * np.asarray(self.x_axis, dtype=np.float32)
        )
        directions = np.reshape(xs + ys + z, [-1, 3])
        directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
        origins = np.broadcast_to(
            np.asarray(self.camera_origin, dtype=np.float32), directions.shape
        )
        return np.stack([origins, directions], axis=1).astype(np.float32)
