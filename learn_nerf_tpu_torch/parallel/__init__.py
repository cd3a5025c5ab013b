"""Data parallelism over cards and processes (port of
``learn_nerf_tpu.parallel``)."""

from .mesh import Mesh, default_mesh, init_distributed, shard_batch

__all__ = ["Mesh", "default_mesh", "init_distributed", "shard_batch"]
