"""Spin around the camera's y axis from a fixed view (the CLI of
``learn_nerf_tpu.scripts.render_nerf_spin``).

N frames rotating the camera's x axis and view direction in their shared
plane (a yaw-in-place turntable), concatenated into one output image.
Renders through :class:`~.render_nerf.RenderSession` with the render CLI's
flags, on the CUDA card unless given ``--device cpu``.
"""

import numpy as np

from ..data.camera import CameraView
from ..utils.progress import progress
from .render_nerf import RenderSession
from .render_nerf import argparser as render_argparser


def spin_views(view: CameraView, num_frames: int):
    """Yaw the camera in place through a full turn."""
    plane = np.stack([view.x_axis, view.camera_direction])  # [2, 3]
    theta = 2 * np.pi * np.arange(num_frames) / num_frames
    # Rotation in the (x, z) plane: rows are the rotated x and z axes.
    rot = np.stack(
        [np.cos(theta), np.sin(theta), -np.sin(theta), np.cos(theta)], axis=-1
    ).reshape(num_frames, 2, 2)
    axes = rot @ plane  # [F, 2, 3]
    for x_axis, direction in axes:
        yield CameraView(
            camera_direction=tuple(direction.tolist()),
            camera_origin=view.camera_origin,
            x_axis=tuple(x_axis.tolist()),
            y_axis=view.y_axis,
            x_fov=view.x_fov,
            y_fov=view.y_fov,
        )


def argparser():
    parser = render_argparser()
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("view_json", type=str)
    parser.add_argument("output_png", type=str)
    return parser


def main(argv=None):
    args = argparser().parse_args(argv)
    session = RenderSession(args)
    start = CameraView.from_json(args.view_json)
    for view in progress(spin_views(start, args.frames), desc="frames", total=args.frames):
        session.render_view(view)
    session.save(args.output_png)


if __name__ == "__main__":
    main()
