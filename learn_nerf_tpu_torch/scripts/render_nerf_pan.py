"""Render a panning orbit around the scene center (the CLI of
``learn_nerf_tpu.scripts.render_nerf_pan``).

The camera circles the bbox center at ``distance * |bbox_diagonal|`` about
a fixed ``-z`` (or, with ``--random_axis``, a random) axis, looking inward,
with 60-degree FOV frames concatenated into one image.  Renders through
:class:`~.render_nerf.RenderSession`, on the CUDA card unless given
``--device cpu``.
"""

import math

import numpy as np

from ..data.camera import CameraView
from ..utils.progress import progress
from .render_nerf import RenderSession
from .render_nerf import argparser as render_argparser

FOV = math.radians(60.0)


def orbit_plane(random_axis: bool, rng=None) -> np.ndarray:
    """Rows: [rotation axis, in-plane basis 1, in-plane basis 2]."""
    if random_axis:
        # Seeded when the CLI passes --seed, so the orbit reproduces.
        axis = (rng or np.random).normal(size=3)
        axis /= np.linalg.norm(axis)
        b1 = np.array([-axis[2], 0.0, axis[0]])
        b1 /= np.linalg.norm(b1)
    else:
        axis = np.array([0.0, 0.0, -1.0])
        b1 = np.array([1.0, 0.0, 0.0])
    return np.stack([axis, b1, np.cross(axis, b1)])


def orbit_views(num_frames: int, bbox_min, bbox_max, distance: float, random_axis: bool = False, rng=None):
    """The orbit's cameras, one a frame."""
    axis, b1, b2 = orbit_plane(random_axis, rng)
    center = (np.asarray(bbox_min) + np.asarray(bbox_max)) / 2
    radius = distance * float(np.linalg.norm(np.asarray(bbox_max) - np.asarray(bbox_min)))

    theta = 2 * np.pi * np.arange(num_frames) / num_frames
    # The camera looks inward along look(theta); its x axis leads by 90
    # degrees and its y axis is the orbit axis.
    look = np.outer(np.cos(theta), b1) + np.outer(np.sin(theta), b2)
    right = -np.outer(np.sin(theta), b1) + np.outer(np.cos(theta), b2)

    for i in range(num_frames):
        yield CameraView(
            camera_direction=tuple(look[i].tolist()),
            camera_origin=tuple((center - radius * look[i]).tolist()),
            x_axis=tuple(right[i].tolist()),
            y_axis=tuple(axis.tolist()),
            x_fov=FOV,
            y_fov=FOV,
        )


def argparser():
    parser = render_argparser()
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--distance", type=float, default=2.0)
    parser.add_argument("--random_axis", action="store_true")
    parser.add_argument("output_png", type=str)
    return parser


def main(argv=None):
    args = argparser().parse_args(argv)
    session = RenderSession(args)
    views = orbit_views(
        args.frames,
        session.metadata.bbox_min,
        session.metadata.bbox_max,
        args.distance,
        args.random_axis,
        rng=np.random.RandomState(args.seed) if args.seed is not None else None,
    )
    for view in progress(views, desc="frames", total=args.frames):
        session.render_view(view)
    session.save(args.output_png)


if __name__ == "__main__":
    main()
