"""Shared CLI helpers: flag groups, device, model factory and renderers.

The flag groups carry the same names and defaults as
``learn_nerf_tpu.scripts.common``, so a command line written for the JAX
package means the same here.  Flags of paths that are not ported yet are
accepted by the parser and refused by :func:`check_ported` with
``SystemExit``, never ignored.
"""

import argparse
import random
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..acceleration import OccupancyGrid, OccupancyGridState
from ..data.dataset import ModelMetadata
from ..models import NeRFModel
from ..occ_render import OccupancyRenderer


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--instant_ngp", action="store_true")
    parser.add_argument("--ref_nerf", action="store_true")
    parser.add_argument(
        "--bf16",
        action="store_true",
        help="run the model MLPs in bfloat16 (params stay f32); on a CUDA "
        "device the fused Hopper kernels",
    )


def add_occupancy_args(parser: argparse.ArgumentParser) -> None:
    """Flags for the occupancy-grid fast path."""
    parser.add_argument(
        "--occupancy",
        action="store_true",
        help="use occupancy-grid accelerated sampling (single field model)",
    )
    parser.add_argument(
        "--occ_candidates",
        type=int,
        default=192,
        help="cheap candidate samples per ray before occupancy culling",
    )
    parser.add_argument(
        "--occ_samples", type=int, default=32, help="field-model samples per ray after culling"
    )
    parser.add_argument(
        "--occ_grid", type=int, default=128, help="occupancy grid resolution per axis"
    )
    parser.add_argument(
        "--occ_threshold",
        type=float,
        default=0.01,
        help="density above which a grid cell counts as occupied",
    )
    parser.add_argument(
        "--occ_budget_per_ray",
        type=lambda v: v if v == "auto" else float(v),
        default=None,
        help="pooled inference (not ported yet)",
    )
    parser.add_argument(
        "--occ_train_budget",
        type=lambda v: v if v == "auto" else float(v),
        default=None,
        help="training only: pooled training budget",
    )
    parser.add_argument(
        "--occ_train_budget_start",
        type=int,
        default=512,
        help="training only: step at which pooled training kicks in",
    )
    parser.add_argument(
        "--occ_train_t_eps",
        type=float,
        default=0.0,
        help="training only: pooled-training transmittance prune",
    )
    parser.add_argument(
        "--occ_refresh_samples",
        type=int,
        default=1,
        help="training only: jittered model samples per refreshed grid cell",
    )
    parser.add_argument(
        "--occ_freeze_grid_after",
        type=int,
        default=None,
        help="training only: stop grid refreshes after this step",
    )
    parser.add_argument(
        "--occ_warmup",
        type=int,
        default=16,
        help="training only: grid updates during which every cell tests occupied",
    )
    parser.add_argument(
        "--occ_t_eps",
        type=float,
        default=0.0,
        help="inference only: drop samples once the occupancy grid's "
        "approximate transmittance falls below this",
    )
    parser.add_argument(
        "--occ_span_candidates",
        type=int,
        default=0,
        help="two-phase span selection (not ported yet)",
    )
    parser.add_argument(
        "--occ_span_pool_factor",
        type=int,
        default=8,
        help="supergrid pooling factor for --occ_span_candidates",
    )
    parser.add_argument(
        "--occ_block_gather",
        type=int,
        default=0,
        help="packed block-word occupancy gathers (not ported yet)",
    )
    parser.add_argument(
        "--occ_span_block_gather",
        type=int,
        default=0,
        help="block-word span probes (not ported yet)",
    )


def add_baked_args(parser: argparse.ArgumentParser) -> None:
    """Baked Instant-NGP flags (not ported yet)."""
    parser.add_argument("--baked", type=int, default=None, metavar="RESOLUTION")
    parser.add_argument(
        "--baked_dtype", type=str, default="bfloat16", choices=("bfloat16", "float32")
    )
    parser.add_argument("--baked_cache", action="store_true")
    parser.add_argument("--baked_pack", type=int, default=1, choices=(1, 2, 4, 8))


def check_ported(args: argparse.Namespace) -> None:
    """Refuse, with ``SystemExit``, every flag whose path is not ported."""
    refused = [
        (getattr(args, "instant_ngp", False), "--instant_ngp (Instant-NGP)"),
        (getattr(args, "ref_nerf", False), "--ref_nerf (Ref-NeRF)"),
        (getattr(args, "baked", None) is not None, "--baked (baked NGP field)"),
        (getattr(args, "occ_budget_per_ray", None) is not None, "--occ_budget_per_ray (pooled inference)"),
        (getattr(args, "occ_span_candidates", 0), "--occ_span_candidates (two-phase span)"),
        (getattr(args, "occ_block_gather", 0), "--occ_block_gather (block-word gathers)"),
        (getattr(args, "occ_span_block_gather", 0), "--occ_span_block_gather (block-word span)"),
    ]
    for is_set, flag in refused:
        if is_set:
            raise SystemExit(
                f"{flag} is not ported to learn_nerf_tpu_torch yet; this "
                "package serves the vanilla NeRF (see ROADMAP.md)"
            )
    if torch.cuda.device_count() > 1:
        raise SystemExit(
            "multi-GPU frame sharding is not ported yet; expose one card "
            "(CUDA_VISIBLE_DEVICES=0)"
        )


def default_device() -> torch.device:
    """The CUDA card when there is one, else the CPU.

    Turns TF32 off for matmuls and cuDNN: the f32 encodings and the f32
    model must not round their products to TF32's 10-bit mantissa.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def create_model(args: argparse.Namespace, metadata: ModelMetadata) -> Tuple[NeRFModel, NeRFModel]:
    """The (coarse, fine) vanilla pair; ``--bf16`` selects the fused route.
    Callers refuse unported model flags first (:func:`check_ported`)."""
    compute_dtype = "bfloat16" if getattr(args, "bf16", False) else "float32"
    return NeRFModel(compute_dtype=compute_dtype), NeRFModel(compute_dtype=compute_dtype)


def build_occupancy_renderer(
    args: argparse.Namespace,
    metadata: ModelMetadata,
    fine: NeRFModel,
    params: Dict[str, Any],
    device: torch.device,
) -> Tuple[OccupancyRenderer, OccupancyGridState]:
    """Occupancy renderer + grid state from CLI args and a checkpoint.  The
    checkpointed ``occupancy_resolution`` wins over ``--occ_grid``."""
    bbox = dict(bbox_min=tuple(metadata.bbox_min), bbox_max=tuple(metadata.bbox_max))
    grid = OccupancyGrid(
        resolution=int(params.get("occupancy_resolution", args.occ_grid)),
        threshold=getattr(args, "occ_threshold", 0.01),
        **bbox,
    )
    grid_state = grid.state_from_checkpoint(params, device)
    renderer = OccupancyRenderer(
        model=fine,
        grid=grid,
        candidates=args.occ_candidates,
        samples=args.occ_samples,
        span_candidates=getattr(args, "occ_span_candidates", 0),
        block_gather_stride=getattr(args, "occ_block_gather", 0),
        span_block_gather=getattr(args, "occ_span_block_gather", 0),
        **bbox,
    )
    return renderer, grid_state


def seeded_generator(seed: Optional[int], device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (random when None)."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed if seed is not None else random.randint(0, 2**32 - 1))
    return generator


def to_u8_image(colors, height: int, width: int) -> np.ndarray:
    """[-1, 1] model colors -> HxWx3 uint8, clipped (out-of-range colors
    would otherwise wrap around in the uint8 cast)."""
    if isinstance(colors, torch.Tensor):
        colors = colors.detach().cpu().numpy()
    arr = np.asarray(colors).reshape(height, width, 3)
    return np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
