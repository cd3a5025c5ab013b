"""Extract a mesh from a trained NeRF by iso-surface extraction (the CLI of
``learn_nerf_tpu.scripts.marching_cubes``).

The fine model's occupancy ``1 - exp(-density)`` on a lattice over the
bbox, swept in tiles of ``--batch_size`` points on the CUDA card (unless
given ``--device cpu``; over every visible card when there are several):
Instant-NGP's lookups through the encode kernel, a
``--bf16`` vanilla model's MLP through the fused MLP kernel.  Surfaced at
``--threshold`` (:func:`~..mesh.marching_tetrahedra`), x and z swapped,
rescaled to world units and centred, written as OBJ, or STL for an
``.stl`` path.
"""

import argparse
from typing import Optional

import numpy as np
import torch

from ..checkpoint import checkpoint_from_flax, load_params_pickle
from ..data.dataset import ModelMetadata
from ..mesh import marching_tetrahedra, write_obj, write_stl
from ..models.base import FieldModel
from ..parallel.mesh import Mesh, replicate
from ..render import tile_devices
from .common import add_device_arg, add_model_args, create_model, frame_mesh, resolve_device


def argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch_size", type=int, default=8192, help="points per tile")
    parser.add_argument("--resolution", type=int, default=32, help="steps along each direction")
    parser.add_argument("--threshold", type=float, default=0.9)
    parser.add_argument("--model_path", type=str, default="nerf.pkl")
    add_model_args(parser)
    add_device_arg(parser)
    parser.add_argument("metadata_json", type=str)
    parser.add_argument("output_obj", type=str)
    return parser


def grid_coordinates(bbox_min, bbox_max, grid_size: int) -> np.ndarray:
    """``[G, G, G, 3]`` lattice spanning the bbox."""
    axes = [np.linspace(lo, hi, num=grid_size, dtype=np.float32) for lo, hi in zip(bbox_min, bbox_max)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def load_fine(args: argparse.Namespace, metadata: ModelMetadata, device: torch.device) -> FieldModel:
    """The checkpoint's fine model on ``device``, in eval mode."""
    _, fine, _ = create_model(args, metadata)
    ckpt = checkpoint_from_flax(load_params_pickle(args.model_path), **fine.flax_layout())
    fine.load_state_dict(ckpt["fine"])
    return fine.to(device).eval()


def occupancy_volume(fine: FieldModel, coords: np.ndarray, batch_size: int, device: torch.device,
                     mesh: Optional[Mesh] = None) -> np.ndarray:
    """``1 - exp(-density)`` of ``fine`` at ``[n, 3]`` points (zero view
    directions), in tiles of ``batch_size`` points; ``[n]`` on the host.
    With ``mesh`` the tiles spread over its devices as a frame's do
    (:func:`~..render.tile_devices`), each with a replica of ``fine``."""
    n = coords.shape[0]
    n_dev = len(mesh.devices) if mesh is not None else 1
    num_tiles = -(-n // (n_dev * batch_size)) * n_dev
    pts = torch.from_numpy(np.pad(coords, ((0, num_tiles * batch_size - n), (0, 0)))).to(device)
    models = replicate(fine, mesh.devices) if mesh is not None else [fine]
    parts = []
    with torch.no_grad():
        for tile, d in zip(pts.split(batch_size), tile_devices(num_tiles, mesh)):
            tile = tile.to(mesh.devices[d]) if mesh is not None else tile
            density = models[d](tile, torch.zeros_like(tile))[0][..., 0].float()
            parts.append((1.0 - torch.exp(-density)).to(device))
    return torch.cat(parts)[:n].cpu().numpy()


def main(argv=None):
    args = argparser().parse_args(argv)
    mesh = frame_mesh(args.device)
    device = mesh.devices[0] if mesh is not None else resolve_device(args.device)
    print("loading metadata...")
    metadata = ModelMetadata.from_json(args.metadata_json)
    print("loading model...")
    fine = load_fine(args, metadata, device)

    coords = grid_coordinates(metadata.bbox_min, metadata.bbox_max, args.resolution).reshape(-1, 3)
    print("computing densities...")
    occ = occupancy_volume(fine, coords, min(args.batch_size, coords.shape[0]), device, mesh)
    volume = np.pad(occ.reshape([args.resolution] * 3), 1, mode="constant", constant_values=0)

    print("extracting mesh...")
    verts, faces = marching_tetrahedra(volume, args.threshold)
    if len(verts) == 0:
        raise SystemExit("no surface found at this threshold")

    # Swap x and z, rescale to world units, centre.  The swap is a
    # reflection, so the face winding reverses with it (outward normals).
    verts = np.stack([verts[..., 2], verts[..., 1], verts[..., 0]], axis=-1)
    faces = faces[:, ::-1]
    size = np.asarray(metadata.bbox_max) - np.asarray(metadata.bbox_min)
    verts *= size / args.resolution
    verts -= (verts.max(axis=0) + verts.min(axis=0)) / 2

    if args.output_obj.endswith(".stl"):
        write_stl(args.output_obj, verts, faces)
    else:
        write_obj(args.output_obj, verts, faces)
    print(f"wrote {len(verts)} vertices / {len(faces)} faces to {args.output_obj}")


if __name__ == "__main__":
    main()
