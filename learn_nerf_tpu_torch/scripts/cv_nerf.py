"""K-fold cross-validation to flag views with bad camera poses (the CLI of
``learn_nerf_tpu.scripts.cv_nerf``): per fold, train the coarse/fine
hierarchy (:class:`~..train.TrainLoop`) on the remaining views for
``--train_iters`` steps, then print each held-out view's mean fine loss
and its image path (a high loss suggests a wrong pose).  Runs on the CUDA
card unless given ``--device cpu`` (a flag of this port only).

The fold shuffle is a permutation from a NumPy generator seeded with
``--seed`` (the JAX CLI permutes with threefry), and every fold starts from
the same initial weights and draws, as there.
"""

import argparse
import tempfile
from typing import Iterator, List, Set

import numpy as np
import torch

from ..data.dataset import NeRFDataset, load_dataset
from ..data.prefetch import prefetch_to_device
from ..train import TrainLoop
from ..utils.progress import progress
from .common import add_device_arg, add_model_args, create_model, resolve_device


def chunk_indices(num_chunks: int, indices: List[int]) -> Iterator[Set[int]]:
    chunk_size = len(indices) // num_chunks
    extra = len(indices) % num_chunks
    offset = 0
    for i in range(num_chunks):
        size = chunk_size + 1 if i < extra else chunk_size
        if not size:
            return
        yield set(indices[offset : offset + size])
        offset += size
    if offset != len(indices):
        raise AssertionError(f"the folds cover {offset} of {len(indices)} views")


def validation_losses(generator: torch.Generator, loop: TrainLoop, data: NeRFDataset, batch_size: int):
    """Each view's fine loss, the mean over its rays (in batches)."""
    for view in data.views:
        rays = view.rays()
        total_loss = 0.0
        for i in range(0, rays.shape[0], batch_size):
            sub = rays[i : i + batch_size]
            losses = loop.eval_losses(sub, generator=generator)
            total_loss += float(losses["fine"]) * len(sub)
        yield total_loss / rays.shape[0]


def argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--folds", type=int, default=10)
    parser.add_argument("--coarse_samples", type=int, default=64)
    parser.add_argument("--fine_samples", type=int, default=128)
    parser.add_argument("--train_iters", type=int, default=1500)
    add_model_args(parser)
    add_device_arg(parser)
    parser.add_argument("data_dir", type=str)
    return parser


def main(argv=None):
    """Cross-validate as the flags say; returns ``[(loss, view name), ...]``
    in the printed order."""
    args = argparser().parse_args(argv)
    device = resolve_device(args.device)

    print("loading dataset...")
    data = load_dataset(args.data_dir)

    rng = np.random.Generator(np.random.Philox(args.seed))
    shuffle_indices = rng.permutation(len(data.views)).tolist()
    data_seed, base_seed, valid_seed = (int(v) for v in rng.integers(0, 2**31 - 1, size=3))

    results = []
    for fold, valid_indices in enumerate(chunk_indices(args.folds, shuffle_indices)):
        print(f"performing cross validation for fold {fold}...")
        train_data = NeRFDataset(
            metadata=data.metadata,
            views=[v for i, v in enumerate(data.views) if i not in valid_indices],
        )
        valid_data = NeRFDataset(
            metadata=data.metadata,
            views=[v for i, v in enumerate(data.views) if i in valid_indices],
        )
        torch.manual_seed(args.seed)  # every fold starts from the same weights
        coarse, fine, train_kwargs = create_model(args, data.metadata)
        loop = TrainLoop(
            coarse,
            fine,
            lr=args.lr,
            coarse_ts=args.coarse_samples,
            fine_ts=args.fine_samples,
            bbox_min=data.metadata.bbox_min,
            bbox_max=data.metadata.bbox_max,
            device=device,
            **train_kwargs,
        )
        with tempfile.TemporaryDirectory() as tmp_dir:
            # Hot loop like train_nerf: seeds from the step counter and
            # double-buffered uploads.
            batches = prefetch_to_device(train_data.iterate_batches(tmp_dir, data_seed, args.batch_size), loop.device)
            for step, batch in enumerate(progress(batches, desc=f"fold {fold}", total=args.train_iters)):
                if step >= args.train_iters:
                    break
                loop.step_auto(base_seed, batch)
        generator = torch.Generator(device=loop.device).manual_seed(valid_seed)
        for view, loss in zip(valid_data.views, validation_losses(generator, loop, valid_data, args.batch_size)):
            name = getattr(view, "image_path", repr(view))
            print(loss, name)
            results.append((loss, name))
    return results


if __name__ == "__main__":
    main()
