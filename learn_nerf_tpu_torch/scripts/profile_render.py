"""Time and profile whole-frame renders of a trained NeRF model (vanilla or
Instant-NGP: the render CLI's model and mode flags all apply).

Takes the render CLI's flags and positionals (``metadata_json view_json``)
and prints one JSON line for the view:

* ``median_ms``: the median host-clock latency of ``--repeats`` calls of
  ``RenderSession.render_view`` (each ends in a copy of the frame to the
  host, so it is synchronised), after one untimed warm-up call;
* ``profiled_ms``: the host-clock latency of one more call, made under
  ``torch.profiler``;
* ``device_ms``: the time the card was busy in that profiled call (the
  union of its kernel, memcpy and memset intervals in the trace), and
  ``idle_share = 1 - device_ms / profiled_ms`` of that same call;
* ``top``: the kernels with the most device time in that call, and
  ``gemm_ms`` the device time of all its matrix products (the kernels
  whose name holds ``gemm``: cuBLAS's and CUTLASS's);
* ``port_kernels``: device time and share of each of the port's own
  kernels (``csrc/``) that ran in that call, and ``port_calls`` how many
  times each ran (a CUDA graph's replay runs its kernels one by one in
  the trace), ``port_graph_calls`` how many of those a graph's replay
  launched (the kernels whose correlation id is a ``cudaGraphLaunch``'s);
* ``graph_launch_kernels``: the kernels each graph launch of that call ran,
  in launch order, ``graph_launch_port_calls`` the port's kernels each ran,
  and ``launches_without_kernel`` its kernel launch calls outside graphs
  with no kernel record (:func:`launch_records`);
* ``kernels_launched``: the number of kernels the card ran in that call,
  and ``memsets`` the number of memsets;
* ``host_launches``: the launch calls the host made in that call (kernels,
  memsets, copies; a CUDA graph's replay counts one);
* ``host_top``: the host ops with the most self time in that call (on the
  host's clock: where an idle card waits), with their call counts.

With ``--device cpu`` the device fields are ``null``; without it the
profiler runs on the card and raises when there is none.

Examples:
  python -m learn_nerf_tpu_torch.scripts.profile_render --bf16 \\
      --model_path nerf.pkl data/metadata.json data/0000.json
  python -m learn_nerf_tpu_torch.scripts.profile_render --instant_ngp \\
      --occupancy --occ_budget_per_ray auto --occ_t_eps 1e-2 \\
      --model_path ngp.pkl data/metadata.json data/0000.json
"""

import json
import os
import statistics
import tempfile
import time
from collections import defaultdict

import torch

from ..data.camera import CameraView
from .render_nerf import RenderSession, argparser as render_argparser

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# The host's launch calls in a trace (the CUDA runtime's and the lower API's):
# a kernel, a memset or copy enqueued, or a CUDA graph's replay (one call).
HOST_API_CATEGORIES = ("cuda_runtime", "cuda_driver")
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
LAUNCH_CALLS = (*KERNEL_LAUNCH_CALLS, "cudaGraphLaunch", "cuGraphLaunch", "cudaMemsetAsync", "cudaMemcpyAsync")
# The port's hand-written kernels, by the name their CUDA function carries.
PORT_KERNELS = ("fused_mlp", "fused_render", "table_gather", "hashgrid_corners", "hashgrid_encode",
                "hashgrid_backward", "hashgrid_dx", "hashgrid_dx_backward", "composite_forward",
                "composite_backward", "composite_pooled_forward", "composite_pooled_backward", "baked_lookup",
                "select_strided", "pool_pack", "ngp_mlp")
# CUDA functions that run for a port kernel under a name of their own: the
# dx wrapper launches hashgrid_dx_points_kernel where no level hashes (the
# Ref-NeRF hybrid's coarse model).
KERNEL_ALIASES = {"hashgrid_dx_points": "hashgrid_dx"}


def argparser():
    parser = render_argparser()
    parser.add_argument("--repeats", type=int, default=5, help="timed renders before the profiled one")
    parser.add_argument("view_json", type=str)
    return parser


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _busy_ms(intervals):
    """Length of the union of ``(start, end)`` intervals in microseconds, in ms."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def device_summary(trace_events, top=3):
    """``(busy ms, [(kernel name, ms), ...], {port kernel: ms})`` of a
    Chrome trace's device events."""
    spans, per_kernel = [], defaultdict(float)
    for e in trace_events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if e["cat"] == "kernel":
                per_kernel[e["name"]] += float(e["dur"]) / 1e3
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    ours = defaultdict(float)
    for name, ms in per_kernel.items():
        kernel = port_kernel_of(name)
        if kernel is not None:
            ours[kernel] += ms
    return _busy_ms(spans), ranked, dict(ours)


def port_kernel_of(name: str):
    """The port kernel (of PORT_KERNELS) that the CUDA function ``name``
    runs for, or None."""
    for stem in (*PORT_KERNELS, *KERNEL_ALIASES):
        if f"{stem}_kernel" in name:
            return KERNEL_ALIASES.get(stem, stem)
    return None


def port_kernel_calls(trace_events, correlations=None) -> dict:
    """``{port kernel: runs}`` of a Chrome trace's kernels (matched as
    :func:`device_summary` matches them); with ``correlations``, only of
    the kernels whose launch carries one of those correlation ids."""
    calls = defaultdict(int)
    for e in trace_events:
        if e.get("ph") == "X" and e.get("cat") == "kernel" and (
                correlations is None or e.get("args", {}).get("correlation") in correlations):
            kernel = port_kernel_of(e["name"])
            if kernel is not None:
                calls[kernel] += 1
    return dict(calls)


def launch_records(trace_events) -> dict:
    """What a Chrome trace shows of its launch calls' device records:
    ``graph``, the correlation ids of its CUDA graph launches in launch
    order (a kernel that carries one ran in that launch's replay);
    ``graph_kernels``, the kernels each of those ran, and
    ``graph_port_calls`` the port's kernels each ran (as
    :func:`port_kernel_calls` counts them); ``without_kernel``, its kernel
    launch calls outside graphs whose correlation id no kernel carries
    (device records the profiler lost)."""
    kernels = defaultdict(int)
    for e in trace_events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            kernels[e.get("args", {}).get("correlation")] += 1
    calls = sorted((float(e["ts"]), e["name"], e["args"]["correlation"]) for e in trace_events
                   if e.get("ph") == "X" and e.get("cat") in HOST_API_CATEGORIES and "correlation" in e.get("args", {}))
    graph = [c for _, name, c in calls if "GraphLaunch" in name]
    return dict(graph=graph, graph_kernels=[kernels[c] for c in graph],
                graph_port_calls=[port_kernel_calls(trace_events, {c}) for c in graph],
                without_kernel=sum(1 for _, name, c in calls if name in KERNEL_LAUNCH_CALLS and not kernels[c]))


def host_summary(averages, top=5):
    """``[{name, self_ms, calls}]`` of the host ops with the most self time."""
    ranked = sorted(averages, key=lambda a: -a.self_cpu_time_total)[:top]
    return [dict(name=a.key[:80], self_ms=a.self_cpu_time_total / 1e3, calls=a.count) for a in ranked]


def profile_view(session: RenderSession, view: CameraView, repeats: int = 5) -> dict:
    """Latencies and one profiled render of ``view`` (see the module doc)."""
    device = session.device

    def render():
        _sync(device)
        t0 = time.perf_counter()
        session.render_view(view)
        session.images.clear()
        return (time.perf_counter() - t0) * 1e3

    render()  # warm-up: first-use costs stay out of the numbers
    latencies = [render() for _ in range(repeats)]

    return dict(
        latencies_ms=latencies, median_ms=statistics.median(latencies), **profile_call(render, device)
    )


def profile_call(call, device: torch.device) -> dict:
    """One call of ``call`` (which returns its own host-clock latency in ms)
    under ``torch.profiler``: ``profiled_ms``, ``device_ms``,
    ``idle_share``, ``top``, ``port_kernels``, ``port_calls`` (and
    ``port_graph_calls``, those of them in graph replays),
    ``graph_launch_kernels``, ``graph_launch_port_calls``,
    ``launches_without_kernel``, ``kernels_launched``,
    ``host_launches``, ``memsets`` and ``host_top`` as the module doc
    describes them."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        profiled = call()
    result = dict(
        profiled_ms=profiled,
        device_ms=None,
        idle_share=None,
        top=None,
        gemm_ms=None,
        port_kernels=None,
        port_calls=None,
        port_graph_calls=None,
        graph_launch_kernels=None,
        graph_launch_port_calls=None,
        launches_without_kernel=None,
        kernels_launched=None,
        host_launches=None,
        memsets=None,
        host_top=host_summary(prof.key_averages()),
    )
    if device.type == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        busy, ranked, ours = device_summary(events)
        records = launch_records(events)
        result.update(
            kernels_launched=sum(
                1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"
            ),
            host_launches=sum(1 for e in events if e.get("ph") == "X" and e.get("cat") in HOST_API_CATEGORIES
                              and e.get("name") in LAUNCH_CALLS),
            memsets=sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_memset"),
            device_ms=busy,
            idle_share=1.0 - busy / profiled,
            top=[dict(name=name[:80], ms=ms, share=ms / busy) for name, ms in ranked],
            gemm_ms=sum(float(e["dur"]) / 1e3 for e in events
                        if e.get("ph") == "X" and e.get("cat") == "kernel" and "gemm" in e["name"]),
            port_kernels={name: dict(ms=ms, share=ms / busy) for name, ms in ours.items()},
            port_calls=port_kernel_calls(events),
            port_graph_calls=port_kernel_calls(events, set(records["graph"])),
            graph_launch_kernels=records["graph_kernels"],
            graph_launch_port_calls=records["graph_port_calls"],
            launches_without_kernel=records["without_kernel"],
        )
    return result


def main(argv=None):
    args = argparser().parse_args(argv)
    session = RenderSession(args)
    result = profile_view(session, CameraView.from_json(args.view_json), args.repeats)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
