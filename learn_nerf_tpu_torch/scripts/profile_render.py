"""Time and profile whole-frame renders of a trained vanilla NeRF model.

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
* ``top``: the kernels with the most device time in that call.

On a host with no card, the device fields are ``null``.

Example:
  python -m learn_nerf_tpu_torch.scripts.profile_render --bf16 \\
      --model_path nerf.pkl data/metadata.json data/0000.json
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
    """``(busy ms, [(kernel name, ms), ...])`` of a Chrome trace's device events."""
    spans, per_kernel = [], defaultdict(float)
    for e in trace_events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            if e["cat"] == "kernel":
                per_kernel[e["name"]] += float(e["dur"]) / 1e3
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return _busy_ms(spans), ranked


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

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        profiled = render()
    result = dict(
        latencies_ms=latencies,
        median_ms=statistics.median(latencies),
        profiled_ms=profiled,
        device_ms=None,
        idle_share=None,
        top=None,
    )
    if device.type == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        busy, ranked = device_summary(events)
        result.update(
            device_ms=busy,
            idle_share=1.0 - busy / profiled,
            top=[dict(name=name[:80], ms=ms, share=ms / busy) for name, ms in ranked],
        )
    return result


def main(argv=None):
    args = argparser().parse_args(argv)
    session = RenderSession(args)
    result = profile_view(session, CameraView.from_json(args.view_json), args.repeats)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
