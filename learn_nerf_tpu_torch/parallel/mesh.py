"""Data parallelism over cards (port of ``learn_nerf_tpu.parallel.mesh``).

Rays are i.i.d., so the one axis is data parallelism: every process holds a
replica of the (small) parameters and trains on its own rows of the global
batch, and one all-reduce of the gradients a step keeps the replicas equal
(the JAX package's GSPMD ``psum``).  Where the JAX mesh spans every device
of every process, a :class:`Mesh` here holds the cards of THIS process and
the process group that joins the processes:

* training: one card a process (``torchrun --nproc_per_node N``, or the JAX
  CLI's ``--coordinator_address/--num_processes/--process_id``), NCCL
  between cards, gloo between CPU processes;
* frames: one process, its tiles spread over the mesh's devices.

Call :func:`init_distributed` before touching a device; each rank then
trains on its local rows (:func:`shard_batch`).
"""

import copy
import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# The environment of a torchrun launch (torch.distributed's env://).
LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group of a run in several processes; returns
    whether one is initialized.

    The JAX package's rules: a no-op for one process; explicit flags
    initialize exactly as asked (``tcp://<coordinator_address>``, the
    world size, the rank); with NO flags it still initializes when the
    environment carries a launcher's coordinates (torchrun's
    ``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK``), so a run launched in
    several processes never trains independent models that race on one
    checkpoint path.

    :param device_type: ``"cuda"`` (NCCL; each rank takes ``cuda:<local
        rank>`` and makes it current) or ``"cpu"`` (gloo).
    :param backend: names the backend instead (gloo between ranks that
        share one card).  Nothing falls back: a backend that fails to
        initialize raises.
    """
    if dist.is_initialized():
        return True
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on the CPU over gloo")
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("--num_processes > 1 needs --coordinator_address and --process_id")
        init_method, world, rank = f"tcp://{coordinator_address}", num_processes, process_id
    elif num_processes is None and all(os.environ.get(var) for var in LAUNCHER_ENV):
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    if device_type == "cuda":
        torch.cuda.set_device(local_device(rank))
    dist.init_process_group(backend or ("nccl" if device_type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank)
    return True


def local_device(rank: int) -> torch.device:
    """This rank's card: ``cuda:<LOCAL_RANK>`` under torchrun, else the
    rank modulo the visible cards (ranks that share a card share it)."""
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


@dataclass(frozen=True)
class Mesh:
    """The devices of this process and the process group that joins the
    processes of a run (None for one process)."""

    devices: Sequence[torch.device]
    group: Any = None

    @property
    def process_index(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def process_count(self) -> int:
        return dist.get_world_size(self.group) if self.group is not None else 1


def default_mesh(devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A mesh of ``devices``, or by default: in a process group, this
    rank's card (or the CPU without one) and the group; in one process,
    every visible card (or the CPU)."""
    group = dist.group.WORLD if dist.is_initialized() else None
    if devices is None:
        if not torch.cuda.is_available():
            devices = [torch.device("cpu")]
        elif group is not None:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices=tuple(indexed(torch.device(d)) for d in devices), group=group)


def indexed(device: torch.device) -> torch.device:
    """``device`` with its index (the current card for a bare ``cuda``)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_batch(mesh: Mesh, local_batch) -> torch.Tensor:
    """This rank's rows of the global batch (a tensor, or an array made
    f32), on this rank's card (the JAX package's
    ``global_batch_from_local``: no rank sees the global batch)."""
    if not isinstance(local_batch, torch.Tensor):
        local_batch = torch.from_numpy(np.asarray(local_batch, dtype=np.float32))
    return local_batch.to(mesh.devices[0], non_blocking=True)


# -- collectives of the data-parallel step ------------------------------------


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflatten_into(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def broadcast_(tensors: Iterable[torch.Tensor], mesh: Mesh, src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s, in one collective."""
    tensors = list(tensors)
    flat = _flat(tensors)
    dist.broadcast(flat, src=src, group=mesh.group)
    _unflatten_into(flat, tensors)


def all_reduce_mean_(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    coalesced all-reduce (a sum, then a division: gloo has no average)."""
    tensors = list(tensors)
    flat = _flat(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat /= mesh.process_count
    _unflatten_into(flat, tensors)


def reduce_values(values: Dict[str, torch.Tensor], mesh: Mesh, summed: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """The logged scalars over the ranks, in one collective: the names in
    ``summed`` summed, every other one averaged (in f64, back to its
    dtype)."""
    names = list(values)
    flat = torch.stack([values[k].detach().to(torch.float64).reshape(()) for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    return {k: (flat[i] if k in summed else flat[i] / mesh.process_count).to(values[k].dtype)
            for i, k in enumerate(names)}


def barrier(mesh: Mesh) -> None:
    dist.barrier(group=mesh.group)


def broadcast_object(value: Any, mesh: Mesh, src: int = 0) -> Any:
    """Rank ``src``'s ``value`` (any picklable object) on every rank."""
    box = [value]
    dist.broadcast_object_list(box, src=src, group=mesh.group)
    return box[0]


# -- replicas for frames over several devices ---------------------------------


def replicate(value: Any, devices: Sequence[torch.device]) -> List[Any]:
    """One copy of ``value`` a device: modules (copied, then moved),
    tensors, and dataclasses, tuples, lists and dicts of them.  A module or
    tensor that already lies on a device is shared, not copied, so a mesh
    that names one card twice holds one replica."""
    return [_to_device(value, torch.device(d), {}) for d in devices]


def _module_device(module: nn.Module) -> Optional[torch.device]:
    for tensor in (*module.parameters(), *module.buffers()):
        return tensor.device
    return None


def _to_device(value: Any, device: torch.device, memo: Dict[int, Any]) -> Any:
    if id(value) in memo:
        return memo[id(value)]
    if isinstance(value, nn.Module):
        out = value if _module_device(value) in (None, device) else copy.deepcopy(value).to(device)
    elif isinstance(value, torch.Tensor):
        out = value.to(device)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        fields = {f.name: _to_device(getattr(value, f.name), device, memo)
                  for f in dataclasses.fields(value) if f.init}
        out = dataclasses.replace(value, **fields)
    elif isinstance(value, (tuple, list)):
        out = type(value)(_to_device(v, device, memo) for v in value)
    elif isinstance(value, dict):
        out = {k: _to_device(v, device, memo) for k, v in value.items()}
    else:
        out = value
    memo[id(value)] = out
    return out
