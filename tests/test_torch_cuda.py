"""The CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they need an NVIDIA Hopper card, ``nvcc`` and a CUDA build
of PyTorch, and skip elsewhere.  Run on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda``.  The same inputs go
through the kernel and its plain version on the card.  The two MLP kernels
differ from theirs only in the order of f32 sums, which can flip a bf16
rounding: atol 2e-3 at these small sizes, and chip_smoke.py's full-size
bounds (5e-3, 5e-4) where a run covers many tiles of the persistent grid.
Their edge cases are the ragged last tile (M around the 128-row tile) and
rays that do not fill the last tile.  The hash-grid kernels: table_gather
equals ``index_select`` exactly (NaN rows included); the corner kernel's
indices and weights equal its plain version's; the all-level encode kernel
sums the 8 weighted corners in another order than the plain version, so
it is held to 1e-6 (chip_smoke.py's bound) with F = 1, 2, 4, dense and
hashed levels, plain and smooth mode, tables without whole row pairs, and
at the edges of its thread grid (N = 0 launches nothing).
"""

import numpy as np
import pytest
import torch

from learn_nerf_tpu_torch.kernels import fused_mlp as fm
from learn_nerf_tpu_torch.kernels import fused_render as fr
from learn_nerf_tpu_torch.kernels import hashgrid as khash
from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
from learn_nerf_tpu_torch.kernels import table_gather as tg
from learn_nerf_tpu_torch.ops import hashgrid
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


@pytest.mark.parametrize("m", [1, 127, 128, 129, (1 << 20) - 37])
def test_fused_mlp_kernel_at_tile_edges(cuda, m):
    packed = port_model(random_flax_tree(3), "bfloat16").to(cuda).packed()
    rng = np.random.RandomState(m % 1000)
    x = t(rng.uniform(-0.7, 0.7, (m, 3)).astype(np.float32)).to(cuda)
    d = t(points_and_dirs(4, m)[1]).to(cuda)
    out = fm.fused_mlp_cuda(packed, x, d)
    torch.cuda.synchronize()
    ref = fm.fused_mlp_reference(packed, x, d)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-3 if m < 4096 else 5e-3)


@pytest.mark.parametrize("k", [1, 24, 32, 64])
def test_fused_render_kernel_over_many_tiles(cuda, k):
    packed = port_model(random_flax_tree(5), "bfloat16").to(cuda).packed()
    rng = np.random.RandomState(k + 1)
    n = 128 // k * 300 + 1  # 300 full tiles of whole rays, then one ray
    points = t(rng.uniform(-0.7, 0.7, (n, k, 3)).astype(np.float32)).to(cuda)
    dirs = t(points_and_dirs(6, n)[1]).to(cuda)
    deltas = t((rng.rand(n, k) * 0.25 * (rng.rand(n, k) < 0.8)).astype(np.float32)).to(cuda)
    out = fr.fused_render_cuda(packed, points, dirs, deltas)
    torch.cuda.synchronize()
    ref = fr.fused_render_reference(packed, points, dirs, deltas)
    torch.testing.assert_close(out, ref, rtol=0, atol=5e-4)


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
    deep = dict(input_layers=10, mid_layers=7)  # 17 > the kernel's bias table of 16
    deep_packed = port_model(random_flax_tree(4, **deep), "bfloat16", **deep).to(cuda).packed()
    with pytest.raises(ValueError, match="input and mid layers"):
        fm.fused_mlp_cuda(deep_packed, torch.zeros((4, 3), device=cuda), torch.zeros((4, 3), device=cuda))


@pytest.mark.parametrize("columns", [1, 2, 3, 4])
def test_table_gather_equals_index_select(cuda, columns):
    rng = np.random.RandomState(columns)
    rows = 2**18
    table = t(rng.uniform(-1, 1, (rows, columns)).astype(np.float32)).to(cuda)
    idx = rng.randint(0, rows, 100_003).astype(np.int32)
    idx[:4] = [rows, -1, -rows - 1, rows - 1]  # NaN, wrap, NaN, last
    idx = t(idx).to(cuda)
    launches = tg.counter.launches
    out = tg.table_gather(table, idx)
    torch.cuda.synchronize()
    assert tg.counter.launches == launches + 1
    ref = tg.table_gather_reference(table, idx)
    torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(out[4:], table.index_select(0, idx[4:].long()), rtol=0, atol=0)
    assert torch.isnan(out[[0, 2]]).all() and torch.equal(out[1], table[-1])


@pytest.mark.parametrize("smooth", [False, True])
def test_hashgrid_corners_kernel_equals_plain_version(cuda, smooth):
    levels = 16
    grids = [2 ** (4 + i // 2) for i in range(levels)] + [2048]
    tables = [2**18] * (levels + 1)
    rng = np.random.RandomState(5)
    bmin, bmax = (-0.7, -0.4, -1.1), (0.7, 1.0, 0.2)
    x = rng.uniform(-1.3, 1.3, (50_000, 3)).astype(np.float32)
    k = rng.randint(0, 128, (5_000, 3))  # points on the 128-lattice's faces
    face = np.asarray(bmin, np.float32) + (np.float32(1.4), np.float32(1.4), np.float32(1.3)) * (k / 127)
    x = t(np.concatenate([x, face.astype(np.float32)])).to(cuda)
    launches = khash.counter.launches
    idx, w = khash.hashgrid_corners(x, grids, tables, bmin, bmax, smooth)
    torch.cuda.synchronize()
    assert khash.counter.launches == launches + 1
    ref_idx, ref_w = khash.hashgrid_corners_reference(x, grids, tables, bmin, bmax, smooth)
    assert torch.equal(idx, ref_idx)
    torch.testing.assert_close(w, ref_w, rtol=0, atol=0)


def test_hash_grid_encode_kernel_route_matches_plain(cuda):
    grids = [2 ** (4 + i // 2) for i in range(16)]
    tables = [2**18] * 16
    rng = np.random.RandomState(6)
    values = [t(rng.uniform(-1, 1, (hashgrid.dense_level_rows(g, s), 2)).astype(np.float32)).to(cuda)
              for g, s in zip(grids, tables)]
    x = t(rng.uniform(-1, 1, (4096, 3)).astype(np.float32)).to(cuda)
    out = hashgrid.hash_grid_encode(values, x, grids, tables, (-1.0,) * 3, (1.0,) * 3)
    ref = hashgrid.hash_grid_encode_reference(values, x, grids, tables, (-1.0,) * 3, (1.0,) * 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


ENCODE_GRIDS = [16, 16, 32, 32, 64, 64, 128, 128, 512, 512, 2048, 2048]  # dense, then hashed
BMIN, BMAX = (-0.7, -0.4, -1.1), (0.7, 1.0, 0.2)


def _encode_inputs(cuda, grids, sizes, features, n, seed):
    rng = np.random.RandomState(seed)
    values = [t(rng.uniform(-1, 1, (hashgrid.dense_level_rows(g, s), features)).astype(np.float32)).to(cuda)
              for g, s in zip(grids, sizes)]
    x = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)  # some outside the bbox
    return values, t(x).to(cuda)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("features", [1, 2, 4])
def test_hashgrid_encode_kernel_matches_plain_version(cuda, features, smooth):
    sizes = [2**18] * len(ENCODE_GRIDS)
    values, x = _encode_inputs(cuda, ENCODE_GRIDS, sizes, features, 20_000, features)
    launches = ke.counter.launches
    out = ke.hashgrid_encode(values, x, ENCODE_GRIDS, sizes, BMIN, BMAX, smooth)
    torch.cuda.synchronize()
    assert ke.counter.launches == launches + 1
    ref = hashgrid.hash_grid_encode_reference(values, x, ENCODE_GRIDS, sizes, BMIN, BMAX, smooth)
    assert out.shape == (20_000, len(ENCODE_GRIDS) * features)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 4099])
def test_hashgrid_encode_kernel_at_the_edges_of_its_grid(cuda, n):
    grids = [2 ** (4 + i // 2) for i in range(16)]
    sizes = [2**18] * 16
    values, x = _encode_inputs(cuda, grids, sizes, 2, n, n)
    launches = ke.counter.launches
    out = ke.hashgrid_encode_cuda(values, x, grids, sizes, BMIN, BMAX, False)
    torch.cuda.synchronize()
    assert out.shape == (n, 32) and ke.counter.launches == launches + (n > 0)
    if n:
        ref = hashgrid.hash_grid_encode_reference(values, x, grids, sizes, BMIN, BMAX)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("features", [1, 2])
def test_hashgrid_encode_kernel_on_tables_without_row_pairs(cuda, features):
    # 5^3 = 125 dense rows and a hashed table of 1001 rows (odd counts: no
    # pair read as one vector), then a level of whole pairs; a mixed run.
    grids, sizes = [5, 64, 64, 64], [4096, 1001, 2**18, 2**18]
    values, x = _encode_inputs(cuda, grids, sizes, features, 5000, 7)
    out = ke.hashgrid_encode_cuda(values, x, grids, sizes, BMIN, BMAX, False)
    torch.cuda.synchronize()
    ref = hashgrid.hash_grid_encode_reference(values, x, grids, sizes, BMIN, BMAX)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("m", [1, 3, 5, 7, 1001])
def test_table_gather_at_lengths_and_offsets_of_every_kind(cuda, m):
    rng = np.random.RandomState(m)
    rows = 2**12
    table = t(rng.uniform(-1, 1, (rows, 2)).astype(np.float32)).to(cuda)
    raw = rng.randint(0, rows, m + 1).astype(np.int32)
    raw[1: min(m, 3) + 1] = [-1, rows, -rows - 1][: min(m, 3)]
    idx = t(raw).to(cuda)[1:]  # a view 4 bytes into its storage
    out = tg.table_gather(table, idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tg.table_gather_reference(table, idx), rtol=0, atol=0, equal_nan=True)


def test_hash_grid_wrappers_refuse_what_their_kernels_do_not_take(cuda):
    grids, sizes = [16, 16], [2**18] * 2
    values, x = _encode_inputs(cuda, grids, sizes, 2, 10, 0)
    with pytest.raises(ValueError, match="1 <= F <= 4"):
        ke.hashgrid_encode_cuda([torch.zeros((4096, 5), device=cuda)] * 2, x, grids, sizes, BMIN, BMAX, False)
    with pytest.raises(ValueError, match="f32 table"):
        ke.hashgrid_encode_cuda([values[0], values[1].double()], x, grids, sizes, BMIN, BMAX, False)
    misaligned = torch.zeros(4096 * 2 + 2, device=cuda)[2:].view(4096, 2)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        ke.hashgrid_encode_cuda([values[0], misaligned], x, grids, sizes, BMIN, BMAX, False)
    with pytest.raises(ValueError, match="1 to 32 levels"):
        ke.hashgrid_encode_cuda([values[0]] * 33, x, [16] * 33, [2**18] * 33, BMIN, BMAX, False)
    with pytest.raises(ValueError, match="contiguous f32 points"):
        ke.hashgrid_encode_cuda(values, x.double(), grids, sizes, BMIN, BMAX, False)
    with pytest.raises(ValueError, match="CUDA device"):
        ke.hashgrid_encode_cuda(values, x.cpu(), grids, sizes, BMIN, BMAX, False)
    with pytest.raises(ValueError, match="1 <= C <= 4"):
        tg.table_gather_cuda(torch.zeros((8, 5), device=cuda), torch.zeros(3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="int32 indices"):
        tg.table_gather_cuda(values[0], torch.zeros(3, dtype=torch.int64, device=cuda))


def test_hashgrid_encode_checks_a_new_table_at_a_cached_address(cuda):
    # An f32 table packs and caches its argument; an f64 table of the same
    # shape at the same address must be checked again, not read as f32.
    grids, sizes = [16, 16], [2**18] * 2
    values, x = _encode_inputs(cuda, grids, sizes, 2, 10, 0)
    storage = torch.zeros(4096 * 2, dtype=torch.float64, device=cuda)
    as_f32 = storage.view(torch.float32)[: 4096 * 2].view(4096, 2)
    as_f64 = storage.view(4096, 2)
    assert as_f32.data_ptr() == as_f64.data_ptr()
    ke.hashgrid_encode_cuda([values[0], as_f32], x, grids, sizes, BMIN, BMAX, False)
    with pytest.raises(ValueError, match="f32 table"):
        ke.hashgrid_encode_cuda([values[0], as_f64], x, grids, sizes, BMIN, BMAX, False)
