"""learn_nerf_tpu_torch: the PyTorch + CUDA port of learn_nerf_tpu.

The JAX package (``learn_nerf_tpu``) stays the reference; this package
mirrors its layout and names and is held to it by ``tests/test_torch_*``.
It imports ``torch`` and never ``jax``.  Plain tensor code is PyTorch;
every Pallas kernel of the JAX package, and the main path's hash-grid
encoding (forward and table gradients) and compositing (forward and
backward), is hand-written CUDA for Hopper (``csrc/``), built with ``nvcc`` at first
use and bound through ``ctypes`` (``kernels/``).

Ported so far: serving of the vanilla NeRF and of Instant-NGP, in every
render mode of the CLI but the span and block-word levers: the coarse/fine
hierarchy, the occupancy-grid fixed-K frame path, and pooled inference
(``--occ_budget_per_ray``); and training on the occupancy-grid path
(``scripts.train_nerf --occupancy``, :class:`~.train.OccupancyTrainLoop`),
which writes the checkpoints both packages render.
"""

__version__ = "0.1.0"
