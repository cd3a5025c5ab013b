"""The occupancy loop's train step as CUDA-graph replays (the port's
counterpart of the JAX package's jitted ``step_auto`` and scanned
``step_auto_scan``, ``learn_nerf_tpu/train.py:664-765``).

A step splits into a host prologue (the grid refresh, the step's draws
into static buffers, the batch copied into its buffer:
:meth:`~.train.OccupancyTrainLoop._hot_step`), a body on those buffers (the
loss, its gradients and the norms: :func:`~.train.grad_body`) and the
optimizer (Adam and the EMA, eager on every route: :func:`~.train.grad_step`).
:class:`StepGraphs` runs the body: eagerly at the run's first step, then
captured once per key into a CUDA graph and replayed.  A key is ``(rays,
pool budget or None, grid in warmup)``: the selection kernel takes the
warmup rule by value, and a pooled step's shapes follow its budget.

Adam stays out of the graph: a graph needs Adam's ``capturable`` or
``fused`` form (step counts on the device, the bias corrections device
ops), and either one widened the run-to-run spread of the pooled run's
held-out PSNR against the dense run's on chip_smoke's train scene 2-3×
(``scripts/adam_ablations.py --pairs``); eager after the replay it is the
Adam of every other route, and its host work overlaps the replay.

What the graphs rely on:

- everything a graph reads or writes from one replay to the next lives
  outside the graphs' memory pool and is never freed while a graph may
  replay: the parameters (loads copy into them in place), the static
  inputs, and the composite backward's ticket (zeroed once, reset by every
  launch inside the graph: launches share it in stream order) and its
  per-block slots (kept when a larger launch outgrows them:
  ``kernels/composite._retired``).  Each capture follows one eager run of
  the body at its key, so a capture makes no such scratch (the composite
  wrapper raises if it would); any graph may replay after any other;
- a graph's outputs are read right after its replay, before the next one
  writes the same addresses: the logging dict is cloned, and the
  gradients it wrote become the leaves' ``.grad`` for the optimizer (an
  eager step in between makes its own);
- a capture records without executing, so host-side effects of the body
  are undone after it and repeated at each replay: the kernels' launch
  counters (:data:`~.kernels.build.COUNTERS`); the step counters advance
  outside the body.

All graphs share one memory pool and capture on one side stream.  A
failure to capture or to replay raises; nothing falls back to eager.
"""

from typing import Callable, Dict, Hashable, List, Optional

import torch

from .kernels import build

Tensor = torch.Tensor
Body = Callable[[], Dict[str, Tensor]]


class StepGraphs:
    """One CUDA graph of the step body per key, on one card.

    ``captures`` and ``replays`` count what ran (a run of n steps that
    holds one key takes 1 capture and n - 1 replays)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.captures = 0
        self.replays = 0
        self._graphs: Dict[Hashable, tuple] = {}
        self._warm = False
        self._pool = None
        self._stream = None

    def run(self, key: Hashable, body: Body, leaves: List[Tensor]) -> Dict[str, Tensor]:
        """``body()``'s logging dict: eager at the first call, else from the
        replay of ``key``'s graph, captured at the key's first use after one
        eager run of the body whose results are dropped (what the body
        allocates on first use at a new size, such as the composite
        backward's scratch, is then made outside the pool); the dict is the
        caller's own (cloned), and the gradients the replay wrote are
        ``leaves``' ``.grad``."""
        if not self._warm:
            self._warm = True
            return body()
        entry = self._graphs.get(key)
        if entry is None:
            _uncounted(body)
            entry = self._graphs[key] = self._captured(lambda: (_packed(body()), [p.grad for p in leaves]))
        graph, (values, grads), moved = entry
        self._replay(graph, moved)
        for p, grad in zip(leaves, grads):
            p.grad = grad
        return _unpacked(values)

    def _captured(self, body: Callable) -> tuple:
        """``(graph, body's outputs, the launch counters it moved)``:
        ``body`` captured, its launches uncounted (each replay counts
        them)."""
        (graph, outputs), moved = _uncounted(lambda: self._capture(body))
        self.captures += 1
        return graph, outputs, moved

    def _replay(self, graph, moved) -> None:
        """One replay of ``graph``, counted, and the launch counters moved
        as its capture moved them."""
        graph.replay()
        self.replays += 1
        for c, launches, plain in moved:
            c.launches += launches
            c.plain_calls += plain

    def _capture(self, body: Callable):
        """``(graph, body's outputs)``: ``body`` captured into a CUDA graph
        on the side stream and the shared pool."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            outputs = body()
        return graph, outputs


def _uncounted(call: Callable):
    """``(call(), [(counter, launches, plain calls) it moved])``, with every
    launch counter put back as it was."""
    before = [(c.launches, c.plain_calls) for c in build.COUNTERS]
    result = call()
    moved = []
    for c, (launches, plain) in zip(build.COUNTERS, before):
        if (c.launches, c.plain_calls) != (launches, plain):
            moved.append((c, c.launches - launches, c.plain_calls - plain))
            c.launches, c.plain_calls = launches, plain
    return result, moved


def _packed(values: Dict[str, Tensor]):
    """A logging dict of 0-dim tensors as one stacked tensor per dtype, so
    that a replay's values leave the graph's outputs in one clone each:
    ``(keys, {dtype: (stacked, keys of its rows)})``."""
    groups: Dict[torch.dtype, list] = {}
    for key, value in values.items():
        groups.setdefault(value.dtype, []).append(key)
    return list(values), {dtype: (torch.stack([values[k] for k in keys]), keys) for dtype, keys in groups.items()}


def _unpacked(outputs) -> Dict[str, Tensor]:
    """The replay's logging dict, in the body's key order, as views of one
    clone per dtype (the next replay writes the graph's outputs again)."""
    order, groups = outputs
    values = {}
    for stacked, keys in groups.values():
        copy = stacked.clone()
        values.update((key, copy[i]) for i, key in enumerate(keys))
    return {key: values[key] for key in order}


def step_graphs(device: torch.device, process_group) -> Optional[StepGraphs]:
    """The occupancy loop's step graphs: on a card, outside a process group
    (a gloo all-reduce cannot be captured; NCCL capture is later work);
    None elsewhere, where the body runs eagerly."""
    if device.type != "cuda" or process_group is not None:
        return None
    return StepGraphs(device)
