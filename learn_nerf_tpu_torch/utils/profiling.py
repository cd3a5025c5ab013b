"""torch.profiler integration (port of ``learn_nerf_tpu.utils.profiling``)."""

import contextlib
import os

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host
    activity, and the card's kernels and copies where there is one) into
    ``log_dir``: a Chrome trace (``<host>_<pid>.<time>.pt.trace.json``,
    one a process) that Perfetto and TensorBoard's profiler plugin read.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
