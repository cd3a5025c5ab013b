"""learn_nerf_tpu_torch: the PyTorch + CUDA port of learn_nerf_tpu.

The JAX package (``learn_nerf_tpu``) stays the reference; this package
mirrors its layout and names and is held to it by ``tests/test_torch_*``.
It imports ``torch`` and never ``jax``.  Plain tensor code is PyTorch; the
two Pallas kernels on the vanilla-NeRF serving path are hand-written CUDA
for Hopper (``csrc/``), built with ``nvcc`` at first use and bound through
``ctypes`` (``kernels/``).

Ported so far: vanilla NeRF serving, in both render modes of the CLI
(coarse/fine hierarchy, and the occupancy-grid fixed-K frame path).
"""

__version__ = "0.1.0"
