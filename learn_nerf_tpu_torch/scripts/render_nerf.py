"""Render one or more views with a trained vanilla NeRF model.

The CLI of ``learn_nerf_tpu.scripts.render_nerf``: positional
``metadata_json view_json... output_png``, the same flags, frames
concatenated horizontally, u8 encoding ``(x + 1) * 127.5``.  Runs on the
CUDA card when there is one; ``--bf16`` then routes the MLPs through the
fused Hopper kernels.
"""

import argparse
from typing import Optional

import numpy as np
import torch

from ..checkpoint import checkpoint_from_flax, load_params_pickle
from ..data.camera import CameraView
from ..data.dataset import ModelMetadata
from ..occ_render import OccupancyFrameSession
from ..render import Renderer, render_frame
from .common import (
    add_baked_args,
    add_model_args,
    add_occupancy_args,
    build_occupancy_renderer,
    check_ported,
    create_model,
    default_device,
    seeded_generator,
    to_u8_image,
)


def base_argparser() -> argparse.ArgumentParser:
    """Render flags shared by all render-family CLIs (no positionals)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=1024, help="rays per render tile")
    parser.add_argument("--coarse_samples", type=int, default=64, help="samples per coarse ray")
    parser.add_argument(
        "--fine_samples",
        type=int,
        default=128,
        help="samples per fine ray (not including coarse samples)",
    )
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--model_path", type=str, default="nerf.pkl")
    add_model_args(parser)
    add_occupancy_args(parser)
    add_baked_args(parser)
    return parser


def argparser() -> argparse.ArgumentParser:
    parser = base_argparser()
    parser.add_argument("metadata_json", type=str)
    return parser


class RenderSession:
    """A loaded model on its device + whole-frame rendering."""

    def __init__(self, args: argparse.Namespace, device: Optional[torch.device] = None):
        check_ported(args)
        self.device = device if device is not None else default_device()
        print("loading metadata...")
        self.metadata = ModelMetadata.from_json(args.metadata_json)

        print("loading model...")
        coarse, fine = create_model(args, self.metadata)
        params = load_params_pickle(args.model_path)
        ckpt = checkpoint_from_flax(params, coarse.num_input_layers, coarse.num_mid_layers)
        coarse.load_state_dict(ckpt["coarse"])
        fine.load_state_dict(ckpt["fine"])
        self.coarse = coarse.to(self.device).eval()
        self.fine = fine.to(self.device).eval()
        self.background = torch.as_tensor(
            np.asarray(params["background"], dtype=np.float32), device=self.device
        )
        self.generator = seeded_generator(args.seed, self.device)
        self.args = args
        self.images = []

        if getattr(args, "occupancy", False):
            self.renderer, self.grid_state = build_occupancy_renderer(
                args, self.metadata, self.fine, params, self.device
            )
            self._frames = OccupancyFrameSession(
                self.renderer,
                self.background,
                self.grid_state,
                tile_size=args.batch_size,
                transmittance_eps=getattr(args, "occ_t_eps", 0.0),
            )
            self._render = lambda rays: self._frames.render(rays, self.generator)["outputs"]
        else:
            self.renderer = Renderer(
                coarse=self.coarse,
                fine=self.fine,
                bbox_min=tuple(self.metadata.bbox_min),
                bbox_max=tuple(self.metadata.bbox_max),
                coarse_ts=args.coarse_samples,
                fine_ts=args.fine_samples,
            )
            self._render = lambda rays: render_frame(
                self.renderer,
                rays,
                self.background,
                tile_size=args.batch_size,
                generator=self.generator,
            )["outputs"]

    def render_view(self, view: CameraView, width=None, height=None) -> np.ndarray:
        """Render one view, optionally at an explicit resolution."""
        width = width if width is not None else self.args.width
        height = height if height is not None else self.args.height
        rays = torch.from_numpy(view.bare_rays(width, height)).to(self.device)
        with torch.inference_mode():
            colors = self._render(rays)
        image = to_u8_image(colors, height, width)
        self.images.append(image)
        return image

    def save(self, output_path: str) -> None:
        from PIL import Image

        Image.fromarray(np.concatenate(self.images, axis=1)).save(output_path)


def main(argv=None):
    parser = argparser()
    parser.add_argument("view_json", type=str, nargs="+")
    parser.add_argument("output_png", type=str)
    args = parser.parse_args(argv)
    session = RenderSession(args)
    for view_json in args.view_json:
        session.render_view(CameraView.from_json(view_json))
    session.save(args.output_png)


if __name__ == "__main__":
    main()
