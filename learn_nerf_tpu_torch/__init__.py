"""learn_nerf_tpu_torch: the PyTorch + CUDA port of learn_nerf_tpu.

The JAX package (``learn_nerf_tpu``) stays the reference; this package
mirrors its layout and names and is held to it by ``tests/test_torch_*``.
It imports ``torch`` and never ``jax``.  Plain tensor code is PyTorch;
every Pallas kernel of the JAX package, and the main path's hash-grid
encoding (forward and table gradients) and compositing (forward and
backward), is hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at first
use and bound through ``ctypes`` (``kernels/``).

Everything the JAX package does is ported: serving and training of the
vanilla NeRF, Instant-NGP and both Ref-NeRF models (the coarse/fine
hierarchy, the occupancy-grid fixed-K and pooled paths, the selection
levers, baking), data parallelism over cards (``parallel.mesh``), the
render-family, dataset and utility CLIs, and the checkpoints both packages
render.
"""

__version__ = "0.1.0"
