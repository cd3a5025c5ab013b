"""Train a NeRF model on a scene: the coarse/fine hierarchy (vanilla, or
Instant-NGP with ``--instant_ngp``; ``--bf16`` runs the MLPs in bf16;
``--ref_nerf`` puts the Ref-NeRF head on either, in f32), or one field
model with occupancy-grid sampling (``--occupancy``).

The CLI of ``learn_nerf_tpu.scripts.train_nerf``: the same flags and
defaults, auto-resume from ``--save_path`` (or from ``--full_state_path``
when that file exists), optional per-step test losses, the ``step i: k=v
...`` line with a rays/sec counter, and a checkpoint in the pickle contract
that both packages render.  Runs on the CUDA card, and raises without one
unless given ``--device cpu`` (a flag of this port only).  On the card
every step runs the composite kernels (once a pass of the hierarchy), and
with ``--instant_ngp`` the hash-grid encode kernel and its table-gradient
kernel (once a model); with ``--instant_ngp --ref_nerf`` also the kernel of
the encoding's gradient in the points and its backward kernel (once a
model: the normal and its loss).

Pooled training, the JAX package's flagship recipe, runs as there:
``--occ_train_budget auto`` (or a number of samples a ray) from step
``--occ_train_budget_start`` on, ``--occ_train_t_eps`` its prune; on the
card a pooled step runs the composite kernels in the pool's layout, and its
log line adds ``fine_pool_dropped``.

``--full_state_path`` checkpoints the full train state (Adam's moments, the
step counters, the average, the grid) at the JAX CLI's save points, in the
port's own format (:func:`~..checkpoint.save_train_state`; the JAX
package's msgpack is refused).  A run resumed from it skips the batches the
saved run consumed (the JAX CLI starts its batch stream again), so it
continues the uninterrupted run step for step; with ``--lr_schedule
cosine`` the restored optimizer count carries the schedule on.

Data parallelism: launched in several processes (``torchrun
--nproc_per_node N -m learn_nerf_tpu_torch.scripts.train_nerf ...``, or the
JAX CLI's ``--coordinator_address host:port --num_processes N --process_id
i`` in each), every rank trains on its own ``--batch_size`` rays of each
global batch of ``N * --batch_size`` on its own card (NCCL; gloo with
``--device cpu``), all-reduces the gradients and logs the global values;
rank 0 writes the checkpoints (:mod:`..parallel.mesh`, the loops' ``mesh=``).
``--profile_dir`` captures a ``torch.profiler`` trace of the hot loop
there (:func:`~..utils.profiling.profile_trace`).

``--steps_per_dispatch k`` runs k plain steps per log line; a last chunk of fewer than k batches is dropped unless
``--steps`` cuts it (:func:`dispatch_chunks`), and checkpoints are written at
the steps the JAX CLI writes them (:func:`save_due`).

Examples (the flagship recipe; the vanilla hierarchy, resumable):
  python -m learn_nerf_tpu_torch.scripts.train_nerf --instant_ngp \\
      --occupancy --occ_train_budget auto --steps_per_dispatch 8 \\
      --lr_schedule cosine --lr 1e-2 --steps 2000 --save_path ngp.pkl data/scene
  python -m learn_nerf_tpu_torch.scripts.train_nerf --lr 5e-4 --steps 20000 \\
      --save_path nerf.pkl --full_state_path nerf_state.pt data/scene
"""

import argparse
import contextlib
import itertools
import os
import random
from typing import Optional

import numpy as np
import torch

from ..checkpoint import load_params_pickle, peek_train_state_step
from ..parallel.mesh import Mesh, broadcast_object, default_mesh, init_distributed
from ..data.dataset import load_dataset
from ..data.prefetch import prefetch_to_device
from ..train import OccupancyTrainLoop, TrainLoop, cosine_decay_schedule
from ..utils.logging import MetricLogger
from ..utils.profiling import profile_trace
from .common import add_device_arg, add_model_args, add_occupancy_args, create_model, resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument(
        "--lr_schedule",
        choices=("constant", "cosine"),
        default="constant",
        help="constant, or cosine decay from --lr to --lr * --lr_final_frac "
        "over --steps (constant-lr Adam keeps oscillating near convergence; "
        "cosine decay pins the endpoint quality)",
    )
    parser.add_argument(
        "--lr_final_frac", type=float, default=0.1,
        help="cosine schedule floor as a fraction of --lr",
    )
    parser.add_argument(
        "--ema", type=float, default=None,
        help="Polyak-average the weights with this decay (e.g. 0.99) and "
        "checkpoint/render the average",
    )
    parser.add_argument("--batch_size", type=int, default=4096, help="rays per batch")
    parser.add_argument("--test_batch_size", type=int, default=None, help="rays per test batch")
    parser.add_argument("--coarse_samples", type=int, default=64, help="samples per coarse ray")
    parser.add_argument(
        "--fine_samples", type=int, default=128,
        help="samples per fine ray (not including coarse samples)",
    )
    parser.add_argument(
        "--density_penalty", type=float, default=None,
        help="penalty coefficient for density at random points",
    )
    parser.add_argument(
        "--density_penalty_batch_size", type=int, default=128,
        help="batch size for computing density penalty",
    )
    parser.add_argument("--save_interval", type=int, default=1000)
    parser.add_argument("--save_path", type=str, default="nerf.pkl")
    parser.add_argument(
        "--full_state_path", type=str, default=None,
        help="also checkpoint the full train state (Adam moments, step counters, grid) here, "
        "and resume from it when it exists",
    )
    parser.add_argument("--one_view", action="store_true")
    parser.add_argument("--test_data_dir", type=str, default=None)
    parser.add_argument("--steps", type=int, default=None, help="stop after this many steps")
    parser.add_argument(
        "--profile_dir", type=str, default=None, help="capture a profiler trace here"
    )
    parser.add_argument(
        "--steps_per_dispatch", type=int, default=1,
        help="run this many plain training steps (plus their grid-refresh "
        "cadence) per log line; identical numerics to one step per line "
        "(incompatible with --test_data_dir)",
    )
    # Data parallelism in several processes (torch.distributed; each
    # process reads its own rays, see data.shuffle and parallel.mesh).
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    add_model_args(parser)
    add_occupancy_args(parser)
    add_device_arg(parser)
    parser.add_argument("data_dir", type=str)
    return parser


def check_train_flags(args: argparse.Namespace) -> None:
    """Refuse, with ``SystemExit``, the occupancy renderer's selection levers
    (pure flag checks, before any dataset or checkpoint is read)."""
    levers = [flag for flag, is_set in (
        ("--occ_span_candidates", args.occ_span_candidates), ("--occ_span_pool_factor", args.occ_span_pool_factor != 8),
        ("--occ_block_gather", args.occ_block_gather), ("--occ_span_block_gather", args.occ_span_block_gather),
    ) if is_set]
    if levers:
        # The JAX CLI parses these and its train loop ignores them; this
        # package accepts nothing it would ignore.
        raise SystemExit(
            f"{', '.join(levers)}: inference levers of render_nerf, serve_nerf, eval_psnr and "
            "render_new_dataset; training does not read them (see ROADMAP.md, Queue 3)"
        )


def resume_step_of(save_path: str, full_state_path=None) -> int:
    """The train-state step a run would resume from: the full state's when
    that file exists, else the params pickle's (0 without either)."""
    if full_state_path is not None and os.path.exists(full_state_path):
        return peek_train_state_step(full_state_path)
    if not os.path.exists(save_path):
        return 0
    payload = load_params_pickle(save_path)
    return int(payload.get("occupancy_host_step", payload.get("train_host_step", 0)))


def make_loop(args: argparse.Namespace, metadata, lr, device: torch.device, mesh: Optional[Mesh] = None):
    """The train loop the flags describe, on ``device`` (``mesh``'s card
    when given): the occupancy loop with ``--occupancy``, else the
    hierarchy's."""
    coarse, fine, train_kwargs = create_model(args, metadata)
    common = dict(
        lr=lr,
        bbox_min=metadata.bbox_min,
        bbox_max=metadata.bbox_max,
        density_penalty=args.density_penalty,
        density_penalty_batch_size=args.density_penalty_batch_size,
        ema_decay=args.ema,
        device=device,
        mesh=mesh,
        **train_kwargs,
    )
    if not args.occupancy:
        return TrainLoop(coarse, fine, coarse_ts=args.coarse_samples, fine_ts=args.fine_samples, **common)
    return OccupancyTrainLoop(
        fine,
        candidates=args.occ_candidates,
        samples=args.occ_samples,
        grid_resolution=args.occ_grid,
        grid_threshold=args.occ_threshold,
        pool_budget_per_ray=args.occ_train_budget,
        pool_start_step=args.occ_train_budget_start,
        pool_t_eps=args.occ_train_t_eps,
        grid_warmup_updates=args.occ_warmup,
        grid_refresh_samples=args.occ_refresh_samples,
        grid_freeze_after=args.occ_freeze_grid_after,
        **common,
    )


def dispatch_chunks(batches, k: int, steps=None):
    """The batches of each dispatch, as the JAX CLI forms them: lists of
    ``k`` batches; the chunk that reaches ``steps`` is cut to the exact
    remainder; without ``steps`` a trailing chunk shorter than ``k`` (a
    finite iterator running out) is dropped."""
    done = 0
    while steps is None or done < steps:
        chunk = list(itertools.islice(batches, k))
        if len(chunk) < k:
            return
        if steps is not None:
            chunk = chunk[: steps - done]
        yield chunk
        done += len(chunk)


def save_due(step: int, save_interval: int, k: int) -> bool:
    """Whether the JAX CLI checkpoints after the dispatch that ends with step
    index ``step`` (``step + 1`` steps done): at ``k = 1`` after every step
    index that is a positive multiple of ``save_interval``, at ``k > 1``
    after the dispatch in which the step count passes such a multiple."""
    if k == 1:
        return bool(step) and step % save_interval == 0
    return bool(step) and (step + 1) % save_interval < k


def main(argv=None, on_step=None):
    """Train as the flags say and return the loop.

    :param on_step: optional ``on_step(steps_done, loop)``, called after
        every logged chunk of steps (for callers that time the run).
    """
    args = build_parser().parse_args(argv)
    if args.steps_per_dispatch > 1 and args.test_data_dir is not None:
        raise SystemExit(
            "--steps_per_dispatch > 1 is incompatible with --test_data_dir "
            "(the per-step test-loss path keeps one step per line)"
        )
    check_train_flags(args)
    if args.test_batch_size is None:
        args.test_batch_size = args.batch_size
    distributed = init_distributed(args.coordinator_address, args.num_processes, args.process_id,
                                   device_type=args.device)
    device = resolve_device(args.device)
    mesh = None
    if distributed:
        mesh = default_mesh([device])
        print(f"process group: {torch.distributed.get_backend(mesh.group)}, rank {mesh.process_index} "
              f"of {mesh.process_count}, on {mesh.devices[0]}", flush=True)

    print("loading dataset...")
    data = load_dataset(args.data_dir)
    if args.one_view:
        data.views = data.views[:1]
    test_data = None
    if args.test_data_dir is not None:
        print("loading test dataset...")
        test_data = load_dataset(args.test_data_dir)
        if args.one_view:
            test_data.views = test_data.views[:1]

    seed = args.seed if args.seed is not None else random.randint(0, 2**32 - 1)
    if mesh is not None:
        seed = broadcast_object(seed, mesh)  # one seed: the same draws on every rank
    torch.manual_seed(seed)  # the model's initial parameters
    rng = np.random.Generator(np.random.Philox(seed))

    print("creating model and train loop...")
    full_resume = args.full_state_path is not None and os.path.exists(args.full_state_path)
    if args.lr_schedule == "cosine":
        if args.steps is None:
            raise SystemExit("--lr_schedule cosine needs --steps (the decay span)")
        # The optimizer's own step count drives the schedule.  A full-state
        # resume restores it, so the decay continues as it was; a params
        # pickle resumes with a fresh optimizer (count 0), and without an
        # offset the schedule would restart at the peak lr on
        # near-converged params.  --steps is the TOTAL decay span, so a
        # resumed run trains only the remaining steps.
        base_schedule = cosine_decay_schedule(args.lr, args.steps, args.lr_final_frac)
        resume_step = resume_step_of(args.save_path, args.full_state_path)
        lr = base_schedule
        if resume_step:
            remaining = max(args.steps - resume_step, 0)
            print(
                f"cosine schedule resumes at step {resume_step}; "
                f"{remaining} of {args.steps} total steps remain"
            )
            if remaining == 0:
                print("nothing to do: the checkpoint already covers --steps")
                return None
            args.steps = remaining
            if not full_resume:
                lr = lambda count: base_schedule(count + resume_step)  # noqa: E731
    else:
        lr = args.lr
        if args.steps is not None and args.steps >= 1000:
            print(
                "note: constant lr leaves end-of-run PSNR stop-step "
                "dependent; for a pinned endpoint use --lr_schedule cosine "
                "(+ --occ_freeze_grid_after, --ema)"
            )
    loop = make_loop(args, data.metadata, lr, device, mesh)
    device = loop.device  # the mesh's indexed card under a process group
    skip = 0
    if full_resume:
        print(f"loading full train state: {args.full_state_path}")
        loop.load_full(args.full_state_path)
        skip = loop.step_count
        print(f"skipping the {skip} batches the saved run consumed")
    elif os.path.exists(args.save_path):
        print(f"loading from checkpoint: {args.save_path}")
        loop.load(args.save_path)

    def save():
        loop.save(args.save_path)
        if args.full_state_path is not None:
            loop.save_full(args.full_state_path)

    # On a card outside a process group step_auto replays a CUDA graph of
    # each step after the first (both loops); --test_data_dir steps eagerly.
    replays = loop._graphs is not None and args.test_data_dir is None
    print("training... (" + ("steps after the first replay CUDA graphs" if replays else "eager steps") + ")")
    seed_base = int(rng.integers(0, 2**31 - 1))
    data_seed, test_seed, base_seed = seed_base, seed_base + 1, seed_base + 2
    shuffle_dir = os.path.join(args.data_dir, "shuffled")
    test_iterator = None
    if test_data is not None:
        test_iterator = prefetch_to_device(
            test_data.iterate_batches(
                os.path.join(args.test_data_dir, "shuffled"), test_seed, args.test_batch_size
            ),
            device,
        )
        test_generator = torch.Generator(device=device).manual_seed(test_seed)
        step_generator = torch.Generator(device=device).manual_seed(base_seed)

    k = args.steps_per_dispatch
    logger = MetricLogger(rays_per_step=args.batch_size * k)
    # Hot loop: batches double-buffer onto the device while the previous
    # step computes, each step's draws come from a generator seeded from the
    # step counter (loop.step_auto), and the logger reads a step's metrics
    # one step late, so nothing here waits for the card.  The per-step
    # test-loss path keeps explicit generators.
    batches = prefetch_to_device(
        itertools.islice(data.iterate_batches(shuffle_dir, data_seed, args.batch_size), skip, None), device
    )
    done = 0
    profiling = profile_trace(args.profile_dir) if args.profile_dir else contextlib.nullcontext()
    with profiling:
        try:
            for chunk in dispatch_chunks(batches, k, args.steps):
                if test_iterator is None:
                    losses = loop.step_auto_many(base_seed, chunk)
                else:
                    losses = loop.step(chunk[0], generator=step_generator)
                    test_losses = loop.eval_losses(next(test_iterator), generator=test_generator)
                    losses = dict(losses, **{f"test_{name}": v for name, v in test_losses.items()})
                done += len(chunk)
                logger.log_step(done - 1, losses)
                if on_step is not None:
                    on_step(done, loop)
                if save_due(done - 1, args.save_interval, k):
                    save()
        finally:
            logger.flush()
    save()
    return loop


if __name__ == "__main__":
    main()
