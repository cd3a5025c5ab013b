"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
steady part of the window, reduced to what the per-layer metrics and the
result's ``breakdown`` read.

The port's kernels are matched by the names their CUDA functions carry
(a frozen copy of ``scripts/profile_render``'s ``PORT_KERNELS`` and
``KERNEL_ALIASES``: the benchmark keeps its own).  A reader of a kernel
that the frozen list does not name finds it by its stem with
:func:`kernel_totals`.
"""

import heapq
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATEGORIES = ("cuda_runtime", "cuda_driver")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaMemsetAsync", "cudaMemcpyAsync")
HOST_CATEGORIES = ("user_annotation", "cpu_op", *HOST_API_CATEGORIES)
PORT_KERNELS = ("fused_mlp", "fused_render", "table_gather", "hashgrid_corners", "hashgrid_encode",
                "hashgrid_backward", "hashgrid_dx", "hashgrid_dx_backward", "composite_forward",
                "composite_backward", "composite_pooled_forward", "composite_pooled_backward", "baked_lookup",
                "select_strided", "pool_pack")
KERNEL_ALIASES = {"hashgrid_dx_points": "hashgrid_dx"}
TOP = 10


def port_kernel_of(name: str):
    """The port kernel that the CUDA function ``name`` runs for, or None."""
    for stem in (*PORT_KERNELS, *KERNEL_ALIASES):
        if f"{stem}_kernel" in name:
            return KERNEL_ALIASES.get(stem, stem)
    return None


def kernel_totals(summary: dict, stem: str) -> list:
    """``[seconds, runs]`` of the CUDA functions in ``summary``'s
    ``kernels`` whose names carry ``<stem>_kernel``, as
    :func:`port_kernel_of` matches a stem."""
    totals = [0.0, 0]
    for name, (seconds, runs) in summary["kernels"].items():
        if f"{stem}_kernel" in name:
            totals = [totals[0] + seconds, totals[1] + runs]
    return totals


class Traced:
    """``with Traced(device) as t: ...`` profiles the block; afterwards
    ``t.events`` holds the trace's events and ``t.window_s`` the block's
    length on the host's clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.events: List[dict] = []
        self.window_s = 0.0

    def __enter__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        return False


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _host_at_gaps(events: List[dict], spans: List[Tuple[float, float]]):
    """Yields ``(name, seconds)`` for each gap between the device's busy
    spans: the innermost host event (the shortest) that covers the gap's
    midpoint, or ``host idle``."""
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") in HOST_CATEGORIES)
    active: List[Tuple[float, float, str]] = []  # heap by end
    i = 0
    for (_, end), (start, _) in zip(spans, spans[1:]):
        mid = (end + start) / 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(active, (host[i][1], host[i][1] - host[i][0], host[i][2]))
            i += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        yield (min(active, key=lambda a: a[1])[2] if active else "host idle"), (start - end) / 1e6


def summary(events: List[dict]) -> dict:
    """``busy_s`` (the union of the device's operations), ``kernels``
    (name -> [seconds, runs]), ``port`` (port kernel -> [seconds, runs]),
    ``host_launches`` (launch calls the host made: a graph replay is one),
    ``device_ops`` and ``idle_gaps`` (the breakdown's lists)."""
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    spans = _merged((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    kernels: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    port: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in device:
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        kernels[name][0] += float(e["dur"]) / 1e6
        kernels[name][1] += 1
        kernel = port_kernel_of(e["name"]) if e["cat"] == "kernel" else None
        if kernel is not None:
            port[kernel][0] += float(e["dur"]) / 1e6
            port[kernel][1] += 1
    gaps: Dict[str, float] = defaultdict(float)
    for name, seconds in _host_at_gaps(events, spans):
        gaps[name] += seconds
    return dict(
        busy_s=sum(b - a for a, b in spans) / 1e6,
        kernels=dict(kernels),
        port=dict(port),
        host_launches=sum(1 for e in events if e.get("cat") in HOST_API_CATEGORIES and e["name"] in LAUNCH_CALLS),
        device_ops=[[name[:120], v[0]] for name, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]],
        idle_gaps=[[name[:120], s] for name, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    )
