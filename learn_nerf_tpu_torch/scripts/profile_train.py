"""Time and profile train steps (the train CLI's model and loop flags all
apply): the occupancy loop's with ``--occupancy``, the hierarchy's without
it or with ``--hierarchy``.

Takes ``train_nerf``'s flags and its ``data_dir`` and prints one JSON line:

* ``step_ms``: the host-clock time of each of ``--repeats`` steps of the
  loop's ``step_auto`` (each synchronised at its end), after
  ``--warmup_steps`` untimed ones; ``median_ms`` their median, and
  ``refresh_step_ms`` those of them that began with a grid refresh;
* ``host_ms``: the host's own time of each of those steps, until
  ``step_auto`` returned (what it takes to enqueue the step), and
  ``host_median_ms`` their median;
* ``graph_replays`` and ``captures``: the loop's step graphs over the
  whole run (on the card ``step_auto`` replays a captured graph,
  ``learn_nerf_tpu_torch.step_graph``; 0 on the CPU), and ``graph_pool_bytes``
  the card's memory in the loop's graphs' pool (0 without graphs),
  ``reserved_bytes`` all the caching allocator holds, after the timed
  steps, and ``peak_bytes`` the most the loop's tensors held at once from
  its first step to then (``torch.cuda.max_memory_allocated``) (``null`` on
  the CPU);
* ``rays_per_s``: the batch size over the median step;
* ``profiled_ms``, ``device_ms``, ``idle_share``, ``top``,
  ``port_kernels``, ``port_calls``, ``kernels_launched``, ``host_launches``, ``memsets``,
  ``host_top``: one more step (on the occupancy path one without a grid
  refresh) under ``torch.profiler``, as :mod:`.profile_render` reports a
  render (``host_launches``: the launches the host made, a graph's
  replay one);
* ``composite_host_us``: the composite kernels' wrappers' own host time a
  call (forward, backward; the pool layout's on a pooled step), on the
  host's clock around each call over the timed steps: their checks,
  allocations and ctypes call, which in a host-bound step delay every
  launch after them (``null`` when the timed steps were graph replays,
  which call no wrapper);
* ``matmul_flops``, ``tflops``, ``mfu``: one more step's matrix-product
  FLOPs (:func:`~..utils.flops.traced_flops`, forward and backward, on an
  eager ``step()``: a replay dispatches no operator to count) over
  the median step, against the H100's peak for the models' GEMM dtype
  (the JAX package's ``bench.py`` roofline; ``null`` on the CPU).

``--pooled`` profiles the JAX package's ``bench_pooled`` cell instead: a
stand-in for a converged grid (5 % of the cells occupied, drawn from
``RandomState(3)``, past warmup and never refreshed), on which the same
weights take the dense step and then the pooled step
(``pool_budget_per_ray="auto"`` from step 0) in one process; the line is
``{"dense": {...}, "pooled": {...}}``, the pooled half with the resolved
``pool_budget`` and the last step's ``fine_pool_dropped``.

``--hierarchy`` profiles the coarse/fine hierarchy's step (``TrainLoop``, as
``train_nerf`` trains it without ``--occupancy``) on the same model flags:
the flags' ``--occupancy`` is dropped, so one flag list serves both.

With ``--device cpu`` the device fields are ``null``; without it the
profiler runs on the card and raises when there is none.

Examples:
  python -m learn_nerf_tpu_torch.scripts.profile_train --instant_ngp \\
      --occupancy --lr 1e-2 data/scene
  python -m learn_nerf_tpu_torch.scripts.profile_train --instant_ngp \\
      --occupancy --lr 1e-2 --pooled data/scene
  python -m learn_nerf_tpu_torch.scripts.profile_train --hierarchy data/scene
"""

import argparse
import contextlib
import json
import os
import statistics
import time

import numpy as np
import torch

from ..acceleration import OccupancyGridState
from ..data.dataset import load_dataset
from ..kernels import composite as kc
from ..data.prefetch import prefetch_to_device
from ..train import OccupancyTrainLoop
from ..utils.flops import roofline, traced_flops
from .common import resolve_device
from .profile_render import _sync, profile_call
from .train_nerf import build_parser, check_train_flags, make_loop


def argparser():
    parser = build_parser()
    parser.add_argument("--repeats", type=int, default=16, help="timed steps before the profiled one")
    parser.add_argument("--warmup_steps", type=int, default=3, help="untimed steps before the timed ones")
    parser.add_argument("--pooled", action="store_true",
                        help="the dense and the pooled step on bench_pooled's frozen 5 %% grid")
    parser.add_argument("--hierarchy", action="store_true",
                        help="the coarse/fine hierarchy's step (drops --occupancy)")
    return parser


def freeze_pooled_grid(loop: OccupancyTrainLoop) -> None:
    """``bench_pooled``'s stand-in for a converged grid: 5 % of the cells
    occupied (``RandomState(3)``), past warmup, and no refresh after (a
    refresh would max in the untrained model's densities)."""
    cells = loop.grid.resolution**3
    occupied = (np.random.RandomState(3).rand(cells) < 0.05).astype(np.float32)
    loop.grid_state = OccupancyGridState(
        densities=torch.from_numpy(occupied).to(loop.device), step=loop.grid.warmup_updates)
    loop.grid_freeze_after = 0


@contextlib.contextmanager
def timed_launchers(module, names):
    """Inside, each function ``module.<name>`` adds its host time to
    ``totals[name] = [seconds, calls]``, which the context yields."""
    saved = {name: getattr(module, name) for name in names}
    totals = {name: [0.0, 0] for name in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            totals[name][0] += time.perf_counter() - t0
            totals[name][1] += 1
            return out
        return call

    for name, fn in saved.items():
        setattr(module, name, timed(name, fn))
    try:
        yield totals
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def graph_pool_bytes(loop) -> int:
    """The card's memory in the segments of ``loop``'s step graphs' pool
    (0 where the loop has none)."""
    pool = getattr(getattr(loop, "_graphs", None), "_pool", None)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if pool is not None and tuple(s.get("segment_pool_id", ())) == tuple(pool))


def profile_steps(loop, batches, base_seed: int = 0, repeats: int = 16, warmup_steps: int = 3) -> dict:
    """Step times and one profiled step of ``loop`` (either train loop)
    over ``batches`` (an iterator of ``[N, 3, 3]`` batches on the loop's
    device)."""
    device = loop.device
    refreshed, dropped, enqueued = [], [], []
    refresh_due = getattr(loop, "_refresh_due", lambda: False)  # the hierarchy has no grid

    def step():
        batch = next(batches)
        refreshed.append(refresh_due())
        _sync(device)
        t0 = time.perf_counter()
        values = loop.step_auto(base_seed, batch)
        enqueued.append((time.perf_counter() - t0) * 1e3)
        _sync(device)
        if "fine_pool_dropped" in values:
            dropped.append(values["fine_pool_dropped"])
        return (time.perf_counter() - t0) * 1e3

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(warmup_steps):  # first-use costs stay out of the numbers
        step()
    del refreshed[:], enqueued[:]
    # The dense pair's launchers and, where the checkout has them, the pool
    # layout's (scripts/profile_trees.py runs this function in others).
    launchers = [name for name in ("_forward_launcher", "_backward_launcher", "_pooled_forward_launcher",
                                   "_pooled_backward_launcher") if hasattr(kc, name)]
    with timed_launchers(kc, launchers) as host:
        times = [step() for _ in range(repeats)]
    host_ms = enqueued[:repeats]
    pool_bytes = reserved = peak = None
    if device.type == "cuda":
        reserved, peak = torch.cuda.memory_reserved(device), torch.cuda.max_memory_allocated(device)
        pool_bytes = graph_pool_bytes(loop)
    with_refresh = [ms for ms, due in zip(times, refreshed) if due]
    while refresh_due():  # profile a step without a grid refresh
        step()
    median = statistics.median(times)
    batch_size = next(batches).shape[0]

    def per_call(kind):  # a step calls the dense or the pooled pair
        seconds, calls = (sum(v[i] for name, v in host.items() if kind in name) for i in (0, 1))
        return seconds / calls * 1e6 if calls else None

    result = dict(
        step_ms=times, median_ms=median, refresh_step_ms=with_refresh, host_ms=host_ms,
        host_median_ms=statistics.median(host_ms), graph_pool_bytes=pool_bytes, reserved_bytes=reserved,
        peak_bytes=peak,
        rays_per_s=batch_size / median * 1e3, batch_size=batch_size,
        composite_host_us=dict(forward=per_call("forward"), backward=per_call("backward")),
        **profile_call(step, device),
    )
    # One more step under the FLOP counter, eager: its matmul FLOPs over the
    # median step, against the peak of the models' GEMM dtype.
    while refresh_due():
        step()
    generator = torch.Generator(device=device).manual_seed(base_seed)
    cost = traced_flops(lambda: loop.step(next(batches), generator=generator))
    bf16 = any(getattr(m, "compute_dtype", "float32") == "bfloat16" for m in loop._models.values())
    rates = roofline(cost, median / 1e3, dtype="bfloat16" if bf16 else "float32") if device.type == "cuda" else {}
    result.update(matmul_flops=cost and cost["flops"], tflops=rates.get("tflops"), mfu=rates.get("mfu"))
    if dropped:
        result["fine_pool_dropped"] = max(int(v) for v in dropped)
    result.update(graph_replays=getattr(loop, "graph_replays", 0), captures=getattr(loop, "captures", 0))
    return result


def profile_args(args) -> dict:
    """The result for parsed flags: a fresh loop on the dataset's batches
    (with ``--pooled``, a dense and a pooled one on the frozen grid)."""
    if args.hierarchy:
        if args.pooled:
            raise SystemExit("--hierarchy and --pooled profile different loops; pick one")
        args.occupancy = False
    check_train_flags(args)
    device = resolve_device(args.device)
    data = load_dataset(args.data_dir)

    def run(flags) -> dict:
        torch.manual_seed(flags.seed if flags.seed is not None else 0)
        loop = make_loop(flags, data.metadata, flags.lr, device)
        if flags.pooled:
            freeze_pooled_grid(loop)
        batches = prefetch_to_device(
            data.iterate_batches(os.path.join(flags.data_dir, "shuffled"), flags.seed or 0, flags.batch_size),
            device,
        )
        result = profile_steps(loop, batches, repeats=flags.repeats, warmup_steps=flags.warmup_steps)
        if flags.occ_train_budget is not None:
            result["pool_budget"] = loop._auto_per_ray or flags.occ_train_budget
        return result

    if not args.pooled:
        return run(args)
    dense = run(argparse.Namespace(**dict(vars(args), occ_train_budget=None)))
    pooled = run(argparse.Namespace(**dict(vars(args), occ_train_budget="auto", occ_train_budget_start=0)))
    return dict(dense=dense, pooled=pooled)


def main(argv=None):
    print(json.dumps(profile_args(argparser().parse_args(argv))))


if __name__ == "__main__":
    main()
