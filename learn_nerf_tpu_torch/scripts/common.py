"""Shared CLI helpers: flag groups, device, model factory and renderers.

The flag groups carry the same names and defaults as
``learn_nerf_tpu.scripts.common``, so a command line written for the JAX
package means the same here.  Flags of paths that are not ported yet are
accepted by the parser and refused by :func:`check_ported` with
``SystemExit``, never ignored.
"""

import argparse
import hashlib
import os
import random
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..acceleration import OccupancyGrid, OccupancyGridState
from ..baked import (
    GRID_DTYPES,
    bake_instant_ngp,
    baked_like,
    baked_state_arrays,
    baked_state_from_arrays,
    check_bakeable,
)
from ..data.dataset import ModelMetadata
from ..models import FieldModel, InstantNGPModel, NeRFModel
from ..models.base import reset_parameters_like_flax
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
        help="inference only: pool all surviving samples of a render tile "
        "into one buffer of tile_size * this many slots (average-case "
        "model cost instead of the per-ray worst case); 'auto' sizes it "
        "losslessly from each frame's measured demand",
    )
    parser.add_argument(
        "--occ_train_budget",
        type=lambda v: v if v == "auto" else float(v),
        default=None,
        help="training: after --occ_train_budget_start steps, pool each "
        "batch's surviving samples into batch * this many slots (the field "
        "model runs on actual survivor counts, not N*K padding); 'auto' "
        "sizes the pool from measured demand, measured again every 256 steps",
    )
    parser.add_argument(
        "--occ_train_budget_start",
        type=int,
        default=512,
        help="step at which pooled training kicks in (the grid must have "
        "started culling or the pool would overflow)",
    )
    parser.add_argument(
        "--occ_train_t_eps",
        type=float,
        default=0.0,
        help="pooled training only: prune candidates whose grid-estimated "
        "transmittance falls below this before pooling. MEASURED HARMFUL "
        "while the grid is still training (fog feedback: the EMA "
        "overestimates young-model fog, pruning robs the surface behind "
        "it of gradient; loss diverged 10x on the compound scene); keep "
        "0 unless resuming with a converged grid",
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
        help="supergrid pooling factor for --occ_span_candidates (not ported yet: "
        "only the default is accepted)",
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
    """Inference-only flags for the baked NGP field (:mod:`..baked`;
    render-family CLIs only)."""
    parser.add_argument(
        "--baked",
        type=int,
        default=None,
        metavar="RESOLUTION",
        help="bake the trained Instant-NGP spatial field onto a dense "
        "RESOLUTION^3 grid at startup and render from it (one trilinear "
        "lookup per sample instead of the full hash stack; requires "
        "--instant_ngp --occupancy; the JAX package's README serves 384)",
    )
    parser.add_argument(
        "--baked_dtype",
        type=str,
        default="bfloat16",
        choices=("bfloat16", "float32"),
        help="baked grid storage dtype (bfloat16 halves device memory)",
    )
    parser.add_argument(
        "--baked_cache",
        action="store_true",
        help="cache the baked grid to <model_path>.baked<R>.<dtype>[.p<PACK>]"
        ".<bbox>.logical.npz and reuse it while it is newer than the "
        "checkpoint (skips the bake sweep on later sessions)",
    )
    parser.add_argument(
        "--baked_pack",
        type=int,
        default=1,
        choices=(1, 2, 4, 8),
        help="corners stored per baked-grid row: PACKx the grid memory "
        "for 8/PACK row reads per sample, identical output",
    )


def check_ported(args: argparse.Namespace) -> None:
    """Refuse, with ``SystemExit``, every flag whose path is not ported, and
    ``--baked`` without ``--occupancy`` (as the JAX package does)."""
    refused = [
        (getattr(args, "ref_nerf", False), "--ref_nerf (Ref-NeRF)"),
        (getattr(args, "occ_span_candidates", 0), "--occ_span_candidates (two-phase span)"),
        (getattr(args, "occ_span_pool_factor", 8) != 8,
         "--occ_span_pool_factor (the span path's supergrid)"),
        (getattr(args, "occ_block_gather", 0), "--occ_block_gather (block-word gathers)"),
        (getattr(args, "occ_span_block_gather", 0), "--occ_span_block_gather (block-word span)"),
    ]
    for is_set, flag in refused:
        if is_set:
            raise SystemExit(
                f"{flag} is not ported to learn_nerf_tpu_torch yet; this "
                "package serves the vanilla NeRF and Instant-NGP, with the "
                "hierarchy, fixed-K occupancy and pooled inference and baked "
                "Instant-NGP serving (--baked under --occupancy), and trains the "
                "hierarchy and the occupancy path, fixed-K or pooled (see ROADMAP.md)"
            )
    require_occupancy_for_baking(args)
    if torch.cuda.device_count() > 1:
        raise SystemExit(
            "multi-GPU frame sharding is not ported yet; expose one card "
            "(CUDA_VISIBLE_DEVICES=0)"
        )


def require_occupancy_for_baking(args: argparse.Namespace) -> None:
    if getattr(args, "baked", None) is not None and not getattr(args, "occupancy", False):
        raise SystemExit("--baked requires --occupancy")


def baked_cache_path(args: argparse.Namespace, fine: InstantNGPModel) -> str:
    """``<model_path>.baked<R>.<dtype>[.p<pack>].<bbox md5>.logical.npz``.

    The bbox is part of the identity: the grid is sampled on this bbox's
    lattice, so the same checkpoint under another metadata.json bakes anew.
    ``.logical`` names the port's layout (rows ``[r^3, pack * F]``); the
    JAX package writes its 128-lane layout as ``.seg128``, so neither
    package reads the other's file.
    """
    pack = getattr(args, "baked_pack", 1)
    pack_tag = f".p{pack}" if pack != 1 else ""
    bbox = (tuple(fine.encoding.bbox_min), tuple(fine.encoding.bbox_max))
    bbox_tag = hashlib.md5(repr(bbox).encode()).hexdigest()[:8]
    return f"{args.model_path}.baked{args.baked}.{args.baked_dtype}{pack_tag}.{bbox_tag}.logical.npz"


def apply_baking(args: argparse.Namespace, fine: FieldModel) -> FieldModel:
    """The field the occupancy renderer serves: ``fine`` itself, or with
    ``--baked`` its bake on ``fine``'s device (from ``--baked_cache`` when
    that file is newer than the checkpoint)."""
    if getattr(args, "baked", None) is None:
        return fine
    require_occupancy_for_baking(args)
    check_bakeable(fine)
    pack = getattr(args, "baked_pack", 1)
    dtype = GRID_DTYPES[args.baked_dtype]
    cache_path = baked_cache_path(args, fine) if getattr(args, "baked_cache", False) else None
    if (
        cache_path is not None
        and os.path.exists(cache_path)
        and os.path.getmtime(cache_path) >= os.path.getmtime(args.model_path)
    ):
        with np.load(cache_path) as data:
            state = baked_state_from_arrays(data, dtype)
        baked = baked_like(fine, state["grid"], args.baked, pack)
        baked.load_state_dict(state)
        print(f"loaded baked grid cache: {cache_path}", flush=True)
        return baked.to(fine.rgb.weight.device).eval()

    baked = bake_instant_ngp(fine, args.baked, dtype=dtype, pack=pack)
    if cache_path is not None:
        # Atomic (tmp + rename): a kill mid-write would leave a truncated
        # file whose mtime still passes the freshness check.
        tmp = cache_path + ".tmp.npz"
        np.savez(tmp, **baked_state_arrays(baked))
        os.replace(tmp, cache_path)
        print(f"wrote baked grid cache: {cache_path}", flush=True)
    return baked


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    """``--device``: the port's entry points run on the card unless asked
    for the CPU (a flag of this port only; the JAX CLI has none)."""
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where to run: the CUDA card (default; raises without one) or the CPU",
    )


def default_device() -> torch.device:
    """The CUDA card; raises when there is none (no fallback to the CPU:
    pass ``--device cpu`` to an entry point to render there).

    Turns TF32 off for matmuls and cuDNN: the f32 encodings and the f32
    model must not round their products to TF32's 10-bit mantissa.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def resolve_device(name: str) -> torch.device:
    """The device ``--device`` names: :func:`default_device` for ``cuda``."""
    return default_device() if name == "cuda" else torch.device(name)


def create_model(
    args: argparse.Namespace, metadata: ModelMetadata
) -> Tuple[FieldModel, FieldModel, Dict[str, Any]]:
    """The (coarse, fine) pair, with the JAX package's shapes, plus the
    train loop's extra keyword arguments (Instant-NGP's Adam: ``eps=1e-15,
    b1=0.9, b2=0.99``).  Fresh models are initialized as flax initializes
    them (:func:`~..models.base.reset_parameters_like_flax`); a checkpoint
    overwrites that.

    ``--instant_ngp``: 6 coarse and 16 fine hash-grid levels of ``2^18``
    rows, lattices ``2^(4 + i//2)``, over the metadata's bbox; ``--bf16``
    runs their MLPs in bf16.  Otherwise the vanilla pair, where ``--bf16``
    serves through the fused route (the train loops select the
    flax-rounded one).  Callers refuse unported model flags first
    (:func:`check_ported`).
    """
    compute_dtype = "bfloat16" if getattr(args, "bf16", False) else "float32"
    if getattr(args, "instant_ngp", False):
        bbox = dict(bbox_min=tuple(metadata.bbox_min), bbox_max=tuple(metadata.bbox_max))
        coarse, fine = (
            InstantNGPModel(
                table_sizes=[2**18] * levels,
                grid_sizes=[2 ** (4 + i // 2) for i in range(levels)],
                compute_dtype=compute_dtype,
                **bbox,
            )
            for levels in (6, 16)
        )
        train_kwargs = dict(adam_eps=1e-15, adam_b1=0.9, adam_b2=0.99)
    else:
        coarse, fine = NeRFModel(compute_dtype=compute_dtype), NeRFModel(compute_dtype=compute_dtype)
        train_kwargs = dict()
    for model in (coarse, fine):
        reset_parameters_like_flax(model)
    return coarse, fine, train_kwargs


def build_occupancy_renderer(
    args: argparse.Namespace,
    metadata: ModelMetadata,
    fine: FieldModel,
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
