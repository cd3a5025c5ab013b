"""Device time per call on the card, by CUDA events: the one pair of timers
that ``chip_smoke.py`` and the ablation scripts share."""

import torch


def cuda_ms(fn, reps=20):
    """Device time per call of ``fn``: one warm-up call, then ``reps``
    back-to-back eager calls between two events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=50):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so no host work sits between the launches (for
    kernels of a few microseconds, where back-to-back eager calls time the
    host's enqueue instead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps
