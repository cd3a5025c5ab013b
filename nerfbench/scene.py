"""The benchmark's scene, made from the seed: an opaque, procedurally
textured sphere of radius 0.5 at the centre of the bbox [-1, 1]^3, on a
white background, filmed with the Blender test cameras' field of view
(``camera_angle_x`` 0.6911) from radius 3.5.

Every seed films the same sphere from the same poses, so every seed asks
the same work of the program: the seed moves the texture's phases and
directions only (and, in the harness, the weights, the draws, the order of
the batches and the orbit's first pose).  At radius 3.5 a ray's mean
survivors on the shell grid (about 1.9) sit in the middle of the auto
budget's bucket (1.3 times the demand between 2 and 3), so the budget
holds from batch to batch and pose to pose.

* :func:`train_views` and :func:`write_dataset`: the training views, written
  in the port's dataset layout (``metadata.json``, ``NAME.png`` beside
  ``NAME.json``);
* :func:`orbit`: the frame cells' spin-video orbit;
* :func:`bare_rays`: a camera's rays, the same arithmetic as the dataset
  reader's, so the reference can recompute any row the data path serves;
* :func:`shell_densities`: the occupancy grid of a converged run on this
  sphere (cells within 1.5 cells of its surface), past warm-up.
"""

import json
import math
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

BBOX_MIN = (-1.0, -1.0, -1.0)
BBOX_MAX = (1.0, 1.0, 1.0)
RADIUS = 0.5
CAMERA_DISTANCE = 3.5
FOV = 0.6911111611634243  # Blender's transforms_test.json camera_angle_x
BACKGROUND = np.array([255, 255, 255], dtype=np.uint8)
TEXTURE_FREQUENCY = 12.0


def sub_seed(seed: int, tag: int) -> int:
    """A 32-bit stream seed for ``tag`` from the run's seed (any size)."""
    return int(np.random.SeedSequence([seed & (2**64 - 1), tag]).generate_state(1)[0])


@dataclass(frozen=True)
class Camera:
    """The port's per-view JSON keys: ``z`` (view direction), ``origin``,
    ``x``, ``y`` (image axes), ``x_fov``, ``y_fov``."""

    z: Tuple[float, float, float]
    origin: Tuple[float, float, float]
    x: Tuple[float, float, float]
    y: Tuple[float, float, float]
    x_fov: float = FOV
    y_fov: float = FOV

    def to_dict(self) -> dict:
        return dict(z=list(self.z), origin=list(self.origin), x=list(self.x), y=list(self.y),
                    x_fov=self.x_fov, y_fov=self.y_fov)


def look_at_origin(azimuth: float, elevation: float) -> Camera:
    """A camera at ``CAMERA_DISTANCE`` looking at the bbox's centre."""
    p = CAMERA_DISTANCE * np.array([math.cos(elevation) * math.cos(azimuth),
                                    math.cos(elevation) * math.sin(azimuth), math.sin(elevation)])
    z = -p / np.linalg.norm(p)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return Camera(z=tuple(map(float, z)), origin=tuple(map(float, p)), x=tuple(map(float, x)),
                  y=tuple(map(float, y)))


def bare_rays(camera: Camera, width: int, height: int) -> np.ndarray:
    """``[H * W, 2, 3]`` float32 (origin, unit direction) in raster order:
    the dataset reader's arithmetic, step for step."""
    z = np.asarray(camera.z, dtype=np.float32)
    ys = (math.tan(camera.y_fov / 2) * np.linspace(-1, 1, num=height, dtype=np.float32)[:, None, None]
          * np.asarray(camera.y, dtype=np.float32))
    xs = (math.tan(camera.x_fov / 2) * np.linspace(-1, 1, num=width, dtype=np.float32)[None, :, None]
          * np.asarray(camera.x, dtype=np.float32))
    directions = np.reshape(xs + ys + z, [-1, 3])
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    origins = np.broadcast_to(np.asarray(camera.origin, dtype=np.float32), directions.shape)
    return np.stack([origins, directions], axis=1).astype(np.float32)


def train_views(count: int) -> List[Camera]:
    """``count`` cameras evenly round the sphere at elevations of 20 and 40
    degrees in turn."""
    return [look_at_origin(2 * math.pi * (i + 0.5) / count, math.radians(20 if i % 2 == 0 else 40))
            for i in range(count)]


def orbit(poses: int, elevation_deg: float = 30.0) -> List[Camera]:
    """A spin video's ``poses`` cameras at one elevation, evenly round the
    sphere."""
    return [look_at_origin(2 * math.pi * (i + 0.5) / poses, math.radians(elevation_deg)) for i in range(poses)]


def texture(seed: int):
    """The sphere's colour at surface points ``[N, 3]`` -> ``[N, 3]`` in
    [0, 1]: one sinusoid a channel along a direction drawn from the seed."""
    rng = np.random.RandomState(sub_seed(seed, 3))
    axes = rng.normal(size=(3, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    phases = rng.uniform(0, 2 * math.pi, size=3)
    return lambda p: 0.5 + 0.45 * np.sin(TEXTURE_FREQUENCY * p @ axes.T + phases)


def render_image(camera: Camera, size: int, seed: int) -> np.ndarray:
    """The ground-truth ``[size, size, 3]`` uint8 image of the sphere."""
    rays = bare_rays(camera, size, size).astype(np.float64)
    o, d = rays[:, 0], rays[:, 1]
    b = np.einsum("ij,ij->i", o, d)
    disc = b * b - (np.einsum("ij,ij->i", o, o) - RADIUS**2)
    hit = disc > 0
    t = -b[hit] - np.sqrt(disc[hit])
    image = np.broadcast_to(BACKGROUND, (rays.shape[0], 3)).copy()
    image[hit] = np.round(255.0 * texture(seed)(o[hit] + t[:, None] * d[hit])).astype(np.uint8)
    return image.reshape(size, size, 3)


def write_dataset(directory: str, seed: int, views: int, size: int) -> List[Tuple[Camera, np.ndarray]]:
    """Write the training views in the port's dataset layout; returns each
    camera with its image."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "metadata.json"), "w") as f:
        json.dump(dict(min=list(BBOX_MIN), max=list(BBOX_MAX)), f)
    written = []
    for i, camera in enumerate(train_views(views)):
        image = render_image(camera, size, seed)
        Image.fromarray(image).save(os.path.join(directory, f"{i:04d}.png"), compress_level=1)
        with open(os.path.join(directory, f"{i:04d}.json"), "w") as f:
            json.dump(camera.to_dict(), f)
        written.append((camera, image))
    return written


def shell_densities(resolution: int, radius: float = RADIUS, thickness_cells: float = 1.5) -> np.ndarray:
    """``[resolution^3]`` float32 cell densities (x fastest): 1 in the cells
    whose centres lie within ``thickness_cells`` cells of the sphere's
    surface, 0 elsewhere: the grid a converged run on this scene holds."""
    centers = ((np.arange(resolution) + 0.5) / resolution) * 2.0 - 1.0
    x, y, z = np.meshgrid(centers, centers, centers, indexing="ij")
    rad = np.sqrt(x * x + y * y + z * z)
    shell = np.abs(rad - radius) < thickness_cells * 2.0 / resolution
    # meshgrid "ij" puts x first; the grid's flat index is x fastest.
    return np.ascontiguousarray(shell.transpose(2, 1, 0)).reshape(-1).astype(np.float32)


def orbit_rays(cameras: List[Camera], size: int, device):
    """``[P, size^2, 2, 3]`` float32 rays of each camera (raster order, unit
    directions), made on ``device`` in a few large calls and returned on
    the host, where a client holds its requests: in pinned memory when
    ``device`` is a card."""
    import torch

    f32 = dict(dtype=torch.float32, device=device)
    z, x, y, origin = (torch.tensor([getattr(c, k) for c in cameras], **f32) for k in ("z", "x", "y", "origin"))
    tan_x = torch.tensor([math.tan(c.x_fov / 2) for c in cameras], **f32)[:, None, None, None]
    tan_y = torch.tensor([math.tan(c.y_fov / 2) for c in cameras], **f32)[:, None, None, None]
    lin = torch.linspace(-1, 1, size, **f32)
    dirs = (tan_x * lin[None, None, :, None] * x[:, None, None, :] + tan_y * lin[None, :, None, None] * y[:, None, None, :]
            + z[:, None, None, :]).reshape(len(cameras), -1, 3)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    rays = torch.stack([origin[:, None, :].expand_as(dirs), dirs], dim=2)
    host = torch.empty(rays.shape, dtype=torch.float32, pin_memory=torch.device(device).type == "cuda")
    return host.copy_(rays)
