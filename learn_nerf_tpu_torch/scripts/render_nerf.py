"""Render one or more views with a trained NeRF model (vanilla, or
Instant-NGP with ``--instant_ngp``).

The CLI of ``learn_nerf_tpu.scripts.render_nerf``: positional
``metadata_json view_json... output_png``, the same flags, frames
concatenated horizontally, u8 encoding ``(x + 1) * 127.5``.  Runs on the
CUDA card, and raises without one unless given ``--device cpu`` (a flag of
this port only).  On the card the vanilla model's ``--bf16`` routes
its MLPs through the fused Hopper kernels, every hash-grid lookup of an
Instant-NGP model runs through the encode kernel, and with ``--baked``
(under ``--occupancy``) every sample's lookup in the baked grid through the
baked-lookup kernel.  With several visible cards a frame's tiles spread
over all of them (the JAX CLI's mesh of every device), each card holding a
replica of the models.
"""

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint import checkpoint_from_flax, load_params_pickle
from ..data.camera import CameraView
from ..data.dataset import ModelMetadata
from ..frame_graph import frame_graphs
from ..occ_render import OccupancyFrameSession
from ..parallel.mesh import Mesh, replicate
from ..render import Renderer, render_frame
from .common import (
    add_baked_args,
    add_device_arg,
    add_model_args,
    add_occupancy_args,
    apply_baking,
    build_occupancy_renderer,
    create_model,
    frame_mesh,
    require_occupancy_for_baking,
    resolve_device,
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
    add_device_arg(parser)
    parser.add_argument("metadata_json", type=str)
    return parser


class RenderSession:
    """A loaded model on its device + whole-frame rendering.

    The device is ``device`` when given, else the one ``args.device``
    names (the card by default, which raises when there is none).  Frames
    spread their tiles over ``mesh``'s devices when it has several (the
    models, background and grid replicated once, here): by default, with
    neither ``device`` nor ``mesh`` given, every visible card when there
    are several (:func:`~.common.frame_mesh`).  The occupancy path serves
    the checkpoint's fine model or, with ``--baked``, its bake, with the
    selection levers the flags set.  ``include_depth_outputs`` adds
    ``alphas`` and ``coords`` to what :meth:`render_arrays` returns
    (dataset distillation).  On one card each tile of a frame is a
    CUDA-graph replay: ``graphs`` (:class:`~..frame_graph.FrameGraphs`,
    None on the CPU and over a mesh, and set to None for the eager route).
    """

    def __init__(
        self,
        args: argparse.Namespace,
        device: Optional[torch.device] = None,
        include_depth_outputs: bool = False,
        mesh: Optional[Mesh] = None,
    ):
        require_occupancy_for_baking(args)
        if mesh is None and device is None:
            mesh = frame_mesh(args.device)
        self.mesh = mesh if mesh is not None and len(mesh.devices) > 1 else None
        if mesh is not None:
            device = mesh.devices[0]
        self.device = device if device is not None else resolve_device(args.device)
        print("loading metadata...")
        self.metadata = ModelMetadata.from_json(args.metadata_json)

        print("loading model...")
        coarse, fine, _ = create_model(args, self.metadata)
        params = load_params_pickle(args.model_path)
        ckpt = checkpoint_from_flax(params, **coarse.flax_layout())
        # The occupancy train loop saves no coarse model, and the occupancy
        # path reads none.
        if "coarse" in ckpt or not getattr(args, "occupancy", False):
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
            self.field = apply_baking(args, self.fine)
            self.renderer, self.grid_state = build_occupancy_renderer(
                args, self.metadata, self.field, params, self.device
            )
            self.frames = OccupancyFrameSession(
                self.renderer,
                self.background,
                self.grid_state,
                tile_size=args.batch_size,
                transmittance_eps=getattr(args, "occ_t_eps", 0.0),
                budget_cfg=getattr(args, "occ_budget_per_ray", None),
                include_depth_outputs=include_depth_outputs,
                mesh=self.mesh,
            )
            self.graphs = self.frames.graphs
            self._render = self._render_occupancy
            return
        self.renderer = Renderer(
            coarse=self.coarse,
            fine=self.fine,
            bbox_min=tuple(self.metadata.bbox_min),
            bbox_max=tuple(self.metadata.bbox_max),
            coarse_ts=args.coarse_samples,
            fine_ts=args.fine_samples,
        )
        self.graphs = frame_graphs(self.device, self.mesh)
        replicas = replicate((self.renderer, self.background), self.mesh.devices) if self.mesh else None
        self._render = lambda rays: render_frame(
            self.renderer,
            rays,
            self.background,
            tile_size=args.batch_size,
            generator=self.generator,
            include_depth_outputs=include_depth_outputs,
            mesh=self.mesh,
            replicas=replicas,
            graphs=self.graphs,
        )

    def _render_occupancy(self, rays: torch.Tensor) -> Dict[str, torch.Tensor]:
        self.frames.graphs = self.graphs  # the session's one switch: None renders eagerly
        return self.frames.render(rays, self.generator)

    def render_arrays(self, view: CameraView, width: int, height: int) -> Dict[str, np.ndarray]:
        """One view's frame outputs on the host, ``[width * height, C]``
        each: ``outputs``, and ``alphas`` and ``coords`` with
        ``include_depth_outputs``."""
        rays = torch.from_numpy(view.bare_rays(width, height)).to(self.device)
        with torch.inference_mode():
            out = self._render(rays)
        return {k: out[k].cpu().numpy() for k in ("outputs", "alphas", "coords") if k in out}

    def render_view(self, view: CameraView, width=None, height=None) -> np.ndarray:
        """Render one view, optionally at an explicit resolution."""
        width = width if width is not None else self.args.width
        height = height if height is not None else self.args.height
        image = to_u8_image(self.render_arrays(view, width, height)["outputs"], height, width)
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
