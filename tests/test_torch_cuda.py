"""The CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they need an NVIDIA Hopper card, ``nvcc`` and a CUDA build
of PyTorch, and skip elsewhere.  Run on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda``.  The same inputs go
through the kernel and its plain version on the card; they differ only in
the order of f32 sums, which can flip a bf16 rounding: atol 2e-3 at these
small sizes (chip_smoke.py holds the full-size runs).
"""

import numpy as np
import pytest
import torch

from learn_nerf_tpu_torch.kernels import fused_mlp as fm
from learn_nerf_tpu_torch.kernels import fused_render as fr
from learn_nerf_tpu_torch.scripts.common import default_device

from .torch_helpers import points_and_dirs, port_model, random_flax_tree, t

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return default_device()


@pytest.mark.parametrize(
    "layers,n", [(dict(input_layers=2, mid_layers=2, hidden=40, color=20), 1000), (dict(), 3000)]
)
def test_fused_mlp_kernel_matches_plain_version(cuda, layers, n):
    tree = random_flax_tree(0, **layers)
    counts = {k: layers[k] for k in ("input_layers", "mid_layers") if k in layers}
    packed = port_model(tree, "bfloat16", **counts).to(cuda).packed()
    x, d = points_and_dirs(1, n)
    x, d = t(x).to(cuda), t(d).to(cuda)
    launches = fm.counter.launches
    out = fm.fused_mlp_cuda(packed, x, d)
    torch.cuda.synchronize()
    assert fm.counter.launches == launches + 1
    torch.testing.assert_close(out, fm.fused_mlp_reference(packed, x, d), rtol=0, atol=2e-3)


@pytest.mark.parametrize("k", [1, 24, 32, 64])
def test_fused_render_kernel_matches_plain_version(cuda, k):
    packed = port_model(random_flax_tree(2), "bfloat16").to(cuda).packed()
    rng = np.random.RandomState(k)
    n = 97
    points = t(rng.uniform(-1, 1, (n, k, 3)).astype(np.float32)).to(cuda)
    dirs = t(points_and_dirs(3, n)[1]).to(cuda)
    deltas = t((rng.rand(n, k) * 0.1 * (rng.rand(n, k) < 0.8)).astype(np.float32)).to(cuda)
    out = fr.fused_render_cuda(packed, points, dirs, deltas)
    torch.cuda.synchronize()
    ref = fr.fused_render_reference(packed, points, dirs, deltas)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-3)


def test_kernel_refuses_what_it_cannot_take(cuda):
    packed = port_model(random_flax_tree(4), "bfloat16").to(cuda).packed()
    points = torch.zeros((3, 65, 3), device=cuda)
    with pytest.raises(ValueError, match="K <= 64"):
        fr.fused_render_cuda(
            packed, points, torch.zeros((3, 3), device=cuda), torch.zeros((3, 65), device=cuda)
        )
    with pytest.raises(ValueError, match="float32"):
        fm.fused_mlp_cuda(packed, torch.zeros((4, 3), device=cuda, dtype=torch.float64),
                          torch.zeros((4, 3), device=cuda))
