"""Time and profile occupancy train steps (the train CLI's model and loop
flags all apply).

Takes ``train_nerf``'s flags and its ``data_dir`` and prints one JSON line:

* ``step_ms``: the host-clock time of each of ``--repeats`` steps of
  ``OccupancyTrainLoop.step_auto`` (each synchronised at its end), after
  ``--warmup_steps`` untimed ones; ``median_ms`` their median, and
  ``refresh_step_ms`` those of them that began with a grid refresh;
* ``rays_per_s``: the batch size over the median step;
* ``profiled_ms``, ``device_ms``, ``idle_share``, ``top``,
  ``port_kernels``, ``kernels_launched``, ``memsets``, ``host_top``: one
  more step (one without a grid refresh) under ``torch.profiler``, as
  :mod:`.profile_render` reports a render;
* ``composite_host_us``: the composite kernels' wrappers' own host time a
  call (forward, backward), on the host's clock around each call over the
  timed steps: their checks, allocations and ctypes call, which in a
  host-bound step delay every launch after them.

With ``--device cpu`` the device fields are ``null``; without it the
profiler runs on the card and raises when there is none.

Example:
  python -m learn_nerf_tpu_torch.scripts.profile_train --instant_ngp \\
      --occupancy --lr 1e-2 data/scene
"""

import contextlib
import json
import os
import statistics
import time

import torch

from ..data.dataset import load_dataset
from ..kernels import composite as kc
from ..data.prefetch import prefetch_to_device
from ..train import OccupancyTrainLoop
from .common import resolve_device
from .profile_render import _sync, profile_call
from .train_nerf import build_parser, check_train_ported, make_loop


def argparser():
    parser = build_parser()
    parser.add_argument("--repeats", type=int, default=16, help="timed steps before the profiled one")
    parser.add_argument("--warmup_steps", type=int, default=3, help="untimed steps before the timed ones")
    return parser


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


def profile_steps(loop: OccupancyTrainLoop, batches, base_seed: int = 0, repeats: int = 16,
                  warmup_steps: int = 3) -> dict:
    """Step times and one profiled step of ``loop`` over ``batches`` (an
    iterator of ``[N, 3, 3]`` batches on the loop's device)."""
    device = loop.device
    refreshed = []

    def step():
        batch = next(batches)
        refreshed.append(loop._refresh_due())
        _sync(device)
        t0 = time.perf_counter()
        loop.step_auto(base_seed, batch)
        _sync(device)
        return (time.perf_counter() - t0) * 1e3

    for _ in range(warmup_steps):  # first-use costs stay out of the numbers
        step()
    del refreshed[:]
    with timed_launchers(kc, ("_forward_launcher", "_backward_launcher")) as host:
        times = [step() for _ in range(repeats)]
    with_refresh = [ms for ms, due in zip(times, refreshed) if due]
    while loop._refresh_due():  # profile a step without a grid refresh
        step()
    median = statistics.median(times)
    batch_size = next(batches).shape[0]
    return dict(
        step_ms=times, median_ms=median, refresh_step_ms=with_refresh,
        rays_per_s=batch_size / median * 1e3, batch_size=batch_size,
        composite_host_us={kind: seconds / max(calls, 1) * 1e6 for kind, (seconds, calls)
                           in zip(("forward", "backward"), host.values())},
        **profile_call(step, device),
    )


def profile_args(args) -> dict:
    """The result for parsed flags: a fresh loop on the dataset's batches."""
    check_train_ported(args)
    device = resolve_device(args.device)
    data = load_dataset(args.data_dir)
    torch.manual_seed(args.seed if args.seed is not None else 0)
    loop = make_loop(args, data.metadata, args.lr, device)
    batches = prefetch_to_device(
        data.iterate_batches(os.path.join(args.data_dir, "shuffled"), args.seed or 0, args.batch_size),
        device,
    )
    return profile_steps(loop, batches, repeats=args.repeats, warmup_steps=args.warmup_steps)


def main(argv=None):
    print(json.dumps(profile_args(argparser().parse_args(argv))))


if __name__ == "__main__":
    main()
