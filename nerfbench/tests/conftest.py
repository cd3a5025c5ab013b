"""Small sizes of the benchmark's cells for runs on the CPU: the same
drivers, traffic kinds and checks, at a handful of rays.  The NGP levels
keep both index modes (4^3 rows fit the 64-row tables, 8^3 hash)."""

import pytest
import torch

TINY_NGP = dict(grid_sizes=[4, 4, 8, 8], table_sizes=[64] * 4, grid_resolution=16)
TINY_NERF = dict(netwidth=32, view_width=16)
TINY = {
    "ngp_train_dense": dict(config=TINY_NGP, traffic=dict(
        views=2, image_size=16, rays=64, candidates=16, samples=4, steps_per_dispatch=2, warmup_dispatches=1,
        trace_dispatches=1)),
    "vanilla_train": dict(config=TINY_NERF, traffic=dict(
        views=2, image_size=16, rays=64, steps_per_dispatch=2, warmup_dispatches=1, trace_dispatches=1)),
    "ngp_frame_800": dict(config=TINY_NGP, traffic=dict(
        image_size=24, poses=4, tile=128, candidates=16, samples=4, warmup_frames=4, checked_frames=2,
        trace_frames=2)),
    "vanilla_frame_half": dict(config=TINY_NERF, traffic=dict(
        image_size=16, poses=4, tile=64, warmup_frames=1, checked_frames=2, trace_frames=1)),
}
CELLS = list(TINY)
SEED = 2**31 + 11


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
