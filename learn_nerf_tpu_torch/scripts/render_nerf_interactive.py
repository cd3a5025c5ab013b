"""Interactive WASD-style fly-through of a trained NeRF (the CLI of
``learn_nerf_tpu.scripts.render_nerf_interactive``).

Commands mutate the camera and each step renders a frame, saved as a
numbered PNG (``ffmpeg -i frame_%05d.png out.mp4`` makes a video of the
session).  Commands: ``r``/``l`` yaw right/left, ``u``/``d`` pitch up/down,
``f``/``b`` move forward/back, ``o`` orbit toward the scene center, ``q``
quit; a count in front repeats one (``3f``).  Commands are read from
standard input, or from ``input_stream`` when :func:`main` is given one.
Renders on the CUDA card unless given ``--device cpu``.
"""

import math
import os
import sys

import numpy as np

from ..data.camera import CameraView
from .render_nerf import RenderSession
from .render_nerf import argparser as render_argparser


def rotate(view: CameraView, axis: np.ndarray, angle: float) -> None:
    """Rotate the camera direction (and x axis) about ``axis``."""

    def rot(v):
        v = np.asarray(v)
        c, s = math.cos(angle), math.sin(angle)
        return v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c)

    view.camera_direction = tuple(rot(view.camera_direction).tolist())
    view.x_axis = tuple(rot(view.x_axis).tolist())
    view.y_axis = tuple(np.cross(view.camera_direction, view.x_axis).tolist())


def apply_command(view: CameraView, cmd: str, move: float, turn: float) -> bool:
    """Mutate the view; returns False for unknown commands."""
    z = np.asarray(view.camera_direction)
    y = np.asarray(view.y_axis)
    x = np.asarray(view.x_axis)
    origin = np.asarray(view.camera_origin)
    if cmd == "r":
        rotate(view, -y, turn)
    elif cmd == "l":
        rotate(view, y, turn)
    elif cmd == "u":
        rotate(view, -x, turn)
    elif cmd == "d":
        rotate(view, x, turn)
    elif cmd == "f":
        view.camera_origin = tuple((origin + z * move).tolist())
    elif cmd == "b":
        view.camera_origin = tuple((origin - z * move).tolist())
    elif cmd == "o":
        # Orbit: move sideways, then face the origin again.
        new_origin = origin + x * move
        view.camera_origin = tuple(new_origin.tolist())
        new_z = -new_origin / (np.linalg.norm(new_origin) + 1e-9)
        # The repo's frame convention: y = cross(z, x), so x = cross(y, z).
        new_x = np.cross(y, new_z)
        new_x /= np.linalg.norm(new_x) + 1e-9
        view.camera_direction = tuple(new_z.tolist())
        view.x_axis = tuple(new_x.tolist())
        view.y_axis = tuple(np.cross(new_z, new_x).tolist())
    else:
        return False
    return True


def argparser():
    parser = render_argparser()
    parser.add_argument("--move_step", type=float, default=0.1)
    parser.add_argument("--turn_step", type=float, default=0.1)
    parser.add_argument("view_json", type=str)
    parser.add_argument("output_dir", type=str)
    return parser


def main(argv=None, input_stream=None):
    args = argparser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    session = RenderSession(args)
    view = CameraView.from_json(args.view_json)
    stream = input_stream if input_stream is not None else sys.stdin

    frame = 0

    def render():
        nonlocal frame
        image = session.render_view(view)
        session.images.clear()  # keep no reel in memory
        from PIL import Image

        Image.fromarray(image).save(os.path.join(args.output_dir, f"frame_{frame:05d}.png"))
        print(f"rendered frame {frame}", flush=True)
        frame += 1

    render()
    print("commands: [count]r/l/u/d/f/b/o, q to quit", flush=True)
    for line in stream:
        line = line.strip()
        if not line:
            continue
        if line == "q":
            break
        digits = ""
        cmd = line
        while cmd and cmd[0].isdigit():
            digits += cmd[0]
            cmd = cmd[1:]
        count = int(digits) if digits else 1
        ok = True
        for _ in range(count):
            ok = apply_command(view, cmd, args.move_step, args.turn_step)
            if not ok:
                print(f"unknown command: {line}", flush=True)
                break
        if ok:
            render()
    print(f"wrote {frame} frames to {args.output_dir}", flush=True)


if __name__ == "__main__":
    main()
