"""Frames as CUDA-graph replays: each tile of a frame is one replay (the
port's counterpart of the JAX package's frame programs, ``lax.map`` over
tiles jitted once a session: ``learn_nerf_tpu/occ_render.py:873-983`` and
``learn_nerf_tpu/render.py:187-251``).

A tile splits into a host prologue (its rays copied into a static ``[S, 2,
3]`` buffer, its uniforms drawn into static buffers from the frame's
generator in the order the eager tile draws them), a body on those buffers
(the tile's selection, field model and composite:
:func:`~.occ_render.render_frame_occupancy` and
:func:`~.render.render_frame` define it) and an epilogue (the body's
outputs copied into the frame's before the next tile overwrites them).
:class:`FrameGraphs` runs the body: at a key's first use eagerly once, then
captured into a CUDA graph; at every tile after that as one replay.  A key
holds the renderer (a frozen dataclass, so its identity stands for its
lever settings), the mode, the tile size, the pool budget or None, the
grid's warmup flag, the transmittance eps and ``include_depth_outputs``:
everything the body reads on the host.

What the graphs rely on, beyond what :mod:`.step_graph` sets out:

- what a graph reads lives as long as the graph: the parameters and
  buffers of the field models, the vanilla model's packed operands, the
  background, the grid's densities and the selection tables (which the
  sessions build once, not once a frame).  :meth:`FrameGraphs.follow`
  records the identity and ``_version`` of each before a frame and drops
  every graph when one of them moved (a stale words table selects wrong
  samples with no error; a freed one is read after free).  An inference
  tensor keeps no version: only its identity is recorded, so such a tensor
  must be replaced, not changed in place;
- one graph never replays in two threads at once: ``serve_nerf`` renders
  under a lock.

On the CPU and over a mesh of several devices (:func:`frame_graphs` gives
None) the frames run eagerly through the same prologue, body and
epilogue.  A failure to capture or to replay raises; nothing falls back to
eager.
"""

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from .acceleration import tensor_stamp
from .models.vanilla import NeRFModel
from .step_graph import Body, StepGraphs, _uncounted

Tensor = torch.Tensor


class TileBuffers:
    """A frame's static tile inputs, one tensor per (name, shape, dtype,
    device), made at first use and kept."""

    def __init__(self):
        self._tensors: Dict[Hashable, Tensor] = {}

    def get(self, name: str, shape: Tuple[int, ...], dtype: torch.dtype, device: torch.device) -> Tensor:
        key = (name, tuple(shape), dtype, torch.device(device))
        buf = self._tensors.get(key)
        if buf is None:
            buf = self._tensors[key] = torch.empty(shape, dtype=dtype, device=device)
        return buf


class TileOutputs:
    """A frame's outputs, ``[num_tiles, ...]`` tensors filled tile by tile:
    :meth:`add` copies a tile's outputs in right after the tile ran, before
    the next replay writes the graph's outputs again."""

    def __init__(self, num_tiles: int, device: torch.device):
        self.num_tiles, self.device = num_tiles, device
        self.tensors: Dict[str, Tensor] = {}

    def add(self, i: int, out: Dict[str, Tensor]) -> None:
        for k, v in out.items():
            if k not in self.tensors:
                self.tensors[k] = torch.empty((self.num_tiles, *v.shape), dtype=v.dtype, device=self.device)
            self.tensors[k][i].copy_(v)


class FrameGraphs(StepGraphs):
    """One CUDA graph of a frame's tile body per key, on one card, in a
    memory pool of their own (not a train step's).

    ``captures`` and ``replays`` count what ran, ``drops`` the graphs
    dropped because something they read moved; ``buffers`` holds the static
    tile inputs the graphs read."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self.drops = 0
        self.buffers = TileBuffers()
        self._stamp: Optional[tuple] = None
        self._reads: Tuple[Tensor, ...] = ()

    def follow(self, reads: Sequence[Tensor]) -> None:
        """Before a frame: ``reads`` are what its graphs read.  When one of
        them is another tensor, or moved its ``_version``, since the graphs
        were captured, every graph is dropped.  The tensors are kept alive
        with the graphs."""
        stamp = tuple(tensor_stamp(t) for t in reads)
        if stamp != self._stamp:
            self.drops += len(self._graphs)
            self._graphs.clear()
            # A pool whose graphs are all gone cannot take another capture
            # (the caching allocator asserts): the next capture makes one.
            self._pool = None
            self._stamp, self._reads = stamp, tuple(reads)

    def run(self, key: Hashable, body: Body) -> Dict[str, Tensor]:
        """``body()``'s outputs from the replay of ``key``'s graph, captured
        at the key's first use after one eager run of the body whose results
        are dropped.  The outputs are the graph's own: copy them out before
        the next replay."""
        entry = self._graphs.get(key)
        if entry is None:
            _uncounted(body)
            entry = self._graphs[key] = self._captured(body)
        graph, outputs, moved = entry
        self._replay(graph, moved)
        return outputs


def field_reads(model: torch.nn.Module) -> List[Tensor]:
    """What a frame graph reads of a field model: its parameters and
    buffers, and a ``--bf16`` vanilla model's packed operands
    (:meth:`~.models.vanilla.NeRFModel.packed`, repacked into new tensors
    when a parameter changes)."""
    reads = [*model.parameters(), *model.buffers()]
    if isinstance(model, NeRFModel) and model.compute_dtype == "bfloat16" and model.bf16_route == "fused":
        packed = model.packed()
        reads += [v for v in vars(packed).values() if isinstance(v, Tensor)]
    return reads


def draw_uniforms(buf: Tensor, generator: Optional[torch.Generator]) -> Tensor:
    """``buf`` filled with ``[0, 1)`` f32 draws from ``generator`` (the
    device's default one when None), as ``ops.sampling.uniform`` draws
    them; through the generator's device when it lies elsewhere."""
    if generator is None or generator.device == buf.device:
        return torch.rand(buf.shape, generator=generator, out=buf)
    return buf.copy_(torch.rand(buf.shape, generator=generator, device=generator.device))


def frame_graphs(device: torch.device, mesh=None) -> Optional[FrameGraphs]:
    """A session's frame graphs: on a card, without a mesh (a session makes
    one only for several devices); None elsewhere, where the tiles run
    eagerly."""
    if torch.device(device).type != "cuda" or mesh is not None:
        return None
    return FrameGraphs(torch.device(device))
