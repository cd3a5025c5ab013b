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
equals ``index_select`` exactly (NaN rows included), on each of its two
routes (block, L2) and on the cluster kernel the wrapper picks for no table
(csrc/ablations/table_gather_cluster.cu) at C = 1 to 4, at 1 to 100,003
indices with the edge indices first, from offset views, on every cluster
size, and the kernel it replaced (csrc/ablations/table_gather_parent.cu);
the corner kernel's
indices and weights equal its plain version's; the all-level encode kernel
sums the 8 weighted corners in another order than the plain version, so
it is held to 1e-6 (chip_smoke.py's bound) with F = 1, 2, 4, dense and
hashed levels, plain and smooth mode, tables without whole row pairs, and
at the edges of its thread grid (N = 0 launches nothing).  The table
gradients (hashgrid_backward) sum with f32 atomics in an order that changes
from run to run, and so does the plain version's ``index_add_``: held to
5e-6 of each level's largest gradient (at 20,000 points some 2,500 terms
meet on each of the 64 rows of the 4^3 level: measured 2.2e-6 there on an
H100, 2e-7 to 7e-7 in the other levels), through ``HashGridEncode`` and on their own, and to finite differences
of the encoding on a tiny case.  Both hash-grid kernels give a warp 32
consecutive points, so they are also held on the runs of equal cells that
rays make (32 lanes in one cell, a run that ends at lane 31 and resumes in
the next warp, two rays of 16 in one warp, a part-full last tile, one point
repeated 4096 times), and two runs of the table gradients on points along
rays to 4e-6.  The composite kernels: forward within 1e-6,
backward within 5e-6 of each gradient's max against autograd through
``ops/volume``, at K = 1, 24, 32, 33, 64 (registers) and 65, 191, 192
(the chunk loop) with a last block that is part full, with one bin width
per ray or one per sample, with 0, 3 and 5 extras; finite differences on a
tiny case within 2e-2 (f32 differences of step 1e-2); the background's
gradient bit-equal across runs; the refusal of more than 8 extras.  The
pool layout's kernels to the same bounds, at every rays-a-warp (a warp a
ray, or a group of 2-32 rays a warp) and at the wrappers' own rule, with
zero gradients on the pool's tail, a pool that cuts the trailing rays, K =
1, 32, 33, 64, every ray one row, rays of 0 and 64 rows, runs of 31, 33, 1
rows across chunks and groups, rays counts no rays-a-warp divides; held to
the pair they replaced (csrc/ablations/composite_pooled_parent.cu, built on
its own) within the same bounds; their background's gradient bit-equal
across runs.  The baked
lookup: within 1e-6 of its plain version (8 weighted unit-scale corners
summed in another order) in bf16 and f32, at packs 1, 2, 4 and 8, with r =
2, 3, 17 and 33, at 1, 31, 32, 33 and 5000 points on and outside the bbox's
and the cells' faces, every pack bit-equal to pack 1; and at r = 2, 3 and
384 (the served table) and 1, 31, 32, 33, 999 and 2^16 points bit-equal to
the kernel it replaced (one thread a point, built from csrc/ablations); the
baked model on the card against the CPU (1e-5); the wrapper's refusals.
The Ref-NeRF kernels: hashgrid_dx and its backward within chip_smoke.py's
bounds (2e-6, 5e-6 of each tensor's largest value) at F = 1 to 4, plain and
smooth mode, points on a face of the bbox and the edges of their thread
grids; dx and grad_g bit-equal to the pair as first designed
(csrc/ablations/hashgrid_dx_parent.cu, built on its own) at F = 1 to 4,
plain and smooth mode, on both sides of the forward's blocks (51, 32 or 85
whole points where a level hashes, 256 points a thread each where none
does) and the backward's tiles of 32, and its table gradients
within 5e-6 of that pair's; through HashGridDx against autograd of the
plain points-VJP; both
Ref-NeRF models on the card against the CPU (1e-4: the card's f32 matmuls
and the CPU's sum in other orders).
"""

import contextlib

import numpy as np
import pytest
import torch

from learn_nerf_tpu_torch import baked
from learn_nerf_tpu_torch.kernels import baked as kbaked
from learn_nerf_tpu_torch.kernels import fused_mlp as fm
from learn_nerf_tpu_torch.kernels import fused_render as fr
from learn_nerf_tpu_torch.kernels import composite as kc
from learn_nerf_tpu_torch.kernels import hashgrid as khash
from learn_nerf_tpu_torch.kernels import hashgrid_backward as kb
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


@pytest.fixture(scope="module")
def gather_libs():
    """table_gather as it was before the block route
    (csrc/ablations/table_gather_parent.cu) and the cluster kernel the
    wrapper picks for no table (csrc/ablations/table_gather_cluster.cu),
    each built on its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from learn_nerf_tpu_torch.scripts.hashgrid_ablations import build_gather_libraries

    return build_gather_libraries(["gather parent", "gather cluster 16"])


def _gather_route(kind, columns, libs):
    """A table's rows, a gather ``(table, idx, route) -> rows`` and its
    route of ``kind``: a 16^3 dense level (block), 100,003 rows (no cluster
    size divides it; the cluster kernel), one row past what a cluster of 16
    holds (L2)."""
    from learn_nerf_tpu_torch.scripts import hashgrid_ablations as ha

    most = 1 << ((ha.SLICE_BYTES // (4 * columns)).bit_length() - 1)
    rows = {"block": 4096, "cluster": 100_003, "l2": ha.LARGEST_CLUSTER * most + 1}[kind]
    if kind == "cluster":
        route = ha.cluster_route(rows, columns)
        return rows, ha.gather_with(libs["gather cluster 16"]), route
    assert tg.gather_route(rows, columns) == kind
    return rows, ha.gather_with(None), kind


def _gather_indices(rng, rows, m):
    """m indices, the edges first: in range at both ends, wrapped at both
    ends, out of range at both ends."""
    idx = rng.randint(0, rows, m).astype(np.int32)
    edges = np.array([0, rows - 1, -1, -rows, rows, -rows - 1], np.int32)
    idx[: min(m, 6)] = edges[: min(m, 6)]
    return idx


@pytest.mark.parametrize("m", [1, 3, 5, 1001, 100_003])
@pytest.mark.parametrize("columns", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["block", "cluster", "l2"])
def test_table_gather_on_each_route(cuda, gather_libs, kind, columns, m):
    rng = np.random.RandomState(columns * m)
    rows, gather, route = _gather_route(kind, columns, gather_libs)
    table = t(rng.uniform(-1, 1, (rows, columns)).astype(np.float32)).to(cuda)
    idx = t(_gather_indices(rng, rows, m)).to(cuda)
    launches = tg.counter.launches
    out = tg.table_gather(table, idx) if kind != "cluster" else gather(table, idx, route)
    torch.cuda.synchronize()
    assert tg.counter.launches == launches + (kind != "cluster")
    torch.testing.assert_close(out, tg.table_gather_reference(table, idx), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("columns", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["block", "cluster", "l2"])
def test_table_gather_on_each_route_from_offset_views(cuda, gather_libs, kind, columns):
    # The table one row into its storage (4-16 bytes: its 16-byte vector
    # copies lose their alignment), the indices one element into theirs.
    rng = np.random.RandomState(columns)
    rows, gather, route = _gather_route(kind, columns, gather_libs)
    table = t(rng.uniform(-1, 1, (rows + 1, columns)).astype(np.float32)).to(cuda)[1:]
    idx = t(_gather_indices(rng, rows, 20_001)).to(cuda)[1:]
    out = gather(table, idx, route)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tg.table_gather_reference(table, idx), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("cluster", range(2, 17))
def test_table_gather_places_every_cluster_size(cuda, gather_libs, cluster):
    from learn_nerf_tpu_torch.scripts import hashgrid_ablations as ha

    rows = cluster * (1 << 14) - 5
    route = ha.cluster_route(rows, 2)
    assert route.cluster == cluster
    lib = gather_libs["gather cluster 16"]
    assert ha.cluster_placement(lib, rows, 2, route) > 0
    rng = np.random.RandomState(cluster)
    table = t(rng.uniform(-1, 1, (rows, 2)).astype(np.float32)).to(cuda)
    idx = t(_gather_indices(rng, rows, 65_537)).to(cuda)
    out = ha.gather_with(lib)(table, idx, route)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tg.table_gather_reference(table, idx), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", ["block", "cluster", "l2"])
def test_table_gather_equals_the_kernel_it_replaced(cuda, gather_libs, kind):
    from learn_nerf_tpu_torch.scripts.hashgrid_ablations import gather_with

    rng = np.random.RandomState(3)
    rows, gather, route = _gather_route(kind, 2, gather_libs)
    table = t(rng.uniform(-1, 1, (rows, 2)).astype(np.float32)).to(cuda)
    idx = t(_gather_indices(rng, rows, 999_424)).to(cuda)
    out = gather(table, idx, route)
    want = gather_with(gather_libs["gather parent"])(table, idx, route)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True)


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


BACKWARD_BOUND = 5e-6  # of each level's largest gradient


def _levels(cuda, seed, features, n, sizes=None):
    rng = np.random.RandomState(seed)
    grids = [4, 8, 16, 16, 32, 64]
    sizes = sizes or [2**12] * 6  # dense up to 16^3, hashed above
    tables = [t(rng.uniform(-1, 1, (hashgrid.dense_level_rows(g, s), features)).astype(np.float32)).to(cuda)
              for g, s in zip(grids, sizes)]
    x = t(rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)).to(cuda)
    g = t(rng.uniform(-1, 1, (n, 6 * features)).astype(np.float32)).to(cuda)
    return tables, x, g, grids, sizes


def _relative_errors(got, want):
    return [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(got, want)]


@pytest.mark.parametrize("features", [1, 2, 3, 4])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 20000])
def test_hashgrid_backward_kernel_matches_plain_version(cuda, features, smooth, n):
    tables, x, g, grids, sizes = _levels(cuda, n + features, features, n)
    lo, hi = (-1.0,) * 3, (1.0,) * 3
    launches = kb.counter.launches
    got = kb.hashgrid_backward(tables, x, g, grids, sizes, lo, hi, smooth)
    torch.cuda.synchronize()
    assert kb.counter.launches == launches + 1 and kb.counter.plain_calls == 0
    want = kb.hashgrid_backward_reference(tables, x, g, grids, sizes, lo, hi, smooth)
    assert [tuple(a.shape) for a in got] == [tuple(tb.shape) for tb in tables]
    assert max(_relative_errors(got, want)) <= BACKWARD_BOUND


def test_hashgrid_backward_with_no_points_launches_nothing(cuda):
    tables, x, g, grids, sizes = _levels(cuda, 0, 2, 4)
    launches = kb.counter.launches
    got = kb.hashgrid_backward(tables, x[:0], g[:0], grids, sizes, (-1.0,) * 3, (1.0,) * 3, False)
    assert kb.counter.launches == launches and all(a.abs().max() == 0 for a in got)


def test_encode_function_trains_tables_on_the_card(cuda):
    """The trap this function closes: a kernel result detached from tables
    that require grad.  Every table gets the plain route's gradient, and
    points that require grad raise."""
    tables, x, g, grids, sizes = _levels(cuda, 7, 2, 5000)
    lo, hi = (-1.0,) * 3, (1.0,) * 3
    params = [torch.nn.Parameter(tb) for tb in tables]
    before = (ke.counter.launches, kb.counter.launches)
    out = hashgrid.hash_grid_encode(params, x, grids, sizes, lo, hi)
    assert out.grad_fn is not None
    (out * g).sum().backward()
    assert (ke.counter.launches, kb.counter.launches) == (before[0] + 1, before[1] + 1)
    got = [p.grad.clone() for p in params]
    assert all(a.abs().max() > 0 for a in got)
    for p in params:
        p.grad = None
    (hashgrid.hash_grid_encode_reference(params, x, grids, sizes, lo, hi) * g).sum().backward()
    assert max(_relative_errors(got, [p.grad for p in params])) <= BACKWARD_BOUND
    with pytest.raises(NotImplementedError, match="Ref-NeRF"):
        hashgrid.hash_grid_encode(params, x.clone().requires_grad_(), grids, sizes, lo, hi)
    with torch.no_grad():  # serving: a direct launch, nothing saved
        assert hashgrid.hash_grid_encode(params, x, grids, sizes, lo, hi).grad_fn is None
    # The gradient in the points that the refusal names: hashgrid_dx, held
    # to its plain version (the JAX package's derivative) on the card.
    dx = hashgrid.hash_grid_encode_dx(params, x, g, grids, sizes, lo, hi)
    want = hashgrid.hash_grid_encode_dx_reference(params, x, g, grids, sizes, lo, hi)
    assert max(_relative_errors([dx], [want])) <= DX_BOUND


# hashgrid_dx and its backward against their plain versions: relative to
# each tensor's largest value, the bounds chip_smoke.py holds them to.
DX_BOUND, DX_BACKWARD_BOUND = 2e-6, 5e-6


@pytest.mark.parametrize("features", [1, 2, 3, 4])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 257, 5000])
def test_hashgrid_dx_kernels_match_plain_versions(cuda, features, smooth, n):
    from learn_nerf_tpu_torch.kernels import hashgrid_dx as kd

    tables, x, g, grids, sizes = _levels(cuda, 40 + n, features, n)
    h = t(np.random.RandomState(n).uniform(-1, 1, (n, 3)).astype(np.float32)).to(cuda)
    lo, hi = (-1.0,) * 3, (1.0,) * 3
    x[: n // 4, 0] = -1.0  # on a face: half the slope, as in JAX
    args = ke.encode_args(tables, x.device, grids, sizes, lo, hi, smooth)
    launches = (kd.counter.launches, kd.backward_counter.launches)
    dx = kd.launch_dx(args, x, g)
    grad_g, grad_tables = kd.launch_dx_backward(args, x, g, h)
    torch.cuda.synchronize()
    assert (kd.counter.launches, kd.backward_counter.launches) == (launches[0] + 1, launches[1] + 1)
    want = hashgrid.hash_grid_encode_dx_reference(tables, x, g, grids, sizes, lo, hi, smooth)
    want_g, want_tables = hashgrid.hash_grid_encode_dx_backward_reference(tables, x, g, h, grids, sizes, lo, hi, smooth)
    assert max(_relative_errors([dx], [want])) <= DX_BOUND
    assert max(_relative_errors([grad_g, *grad_tables], [want_g, *want_tables])) <= DX_BACKWARD_BOUND


@pytest.fixture(scope="module")
def dx_parent():
    """The dx pair as first designed (csrc/ablations/hashgrid_dx_parent.cu,
    built on its own): its forward and backward entry points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from learn_nerf_tpu_torch.scripts.hashgrid_ablations import build_dx_libraries

    return build_dx_libraries(["dx parent"])["dx parent"]


@pytest.mark.parametrize("features", [1, 2, 3, 4])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("levels,size,n", [(6, 2**12, 1), (6, 2**12, 51), (6, 2**12, 52), (6, 2**12, 5000),
                                          (16, 2**18, 33), (16, 2**18, 4097), (5, 2**12, 86), (6, 2**18, 257)])
def test_hashgrid_dx_kernels_equal_the_first_design(cuda, dx_parent, features, smooth, levels, size, n):
    # dx and grad_g sum in the first design's order: bit for bit; the table
    # gradients are f32 atomics in another order.  Schedules with a hashed
    # level take the forward's grid: _levels' 6 levels make 5 work items
    # (51 points a block), the fine schedule's 16 make 8 (32), its first 5
    # at 2^12 rows make 3 (85), one of a single level; the coarse model's 6
    # dense levels take a thread a point (blocks of 256).
    from learn_nerf_tpu_torch.kernels import hashgrid_dx as kd

    rng = np.random.RandomState(levels * n + features)
    if levels == 6 and size == 2**12:
        tables, x, g, grids, sizes = _levels(cuda, n + features, features, n)
        lo, hi = (-1.0,) * 3, (1.0,) * 3
    else:
        grids, sizes = FINE_GRIDS[:levels], [size] * levels
        tables = [t(rng.uniform(-1, 1, (hashgrid.dense_level_rows(g_, s), features)).astype(np.float32)).to(cuda)
                  for g_, s in zip(grids, sizes)]
        x = t(_ray_points(rng, -(-n // 32), 32, 2e-2)[:n]).to(cuda)
        g = t(rng.uniform(-1, 1, (n, levels * features)).astype(np.float32)).to(cuda)
        lo, hi = (-0.7,) * 3, (0.7,) * 3
    h = t(rng.uniform(-1, 1, (n, 3)).astype(np.float32)).to(cuda)
    args = ke.encode_args(tables, x.device, grids, sizes, lo, hi, smooth)
    dx, (grad_g, grad_tables) = kd.launch_dx(args, x, g), kd.launch_dx_backward(args, x, g, h)
    was_dx = kd.run_dx(dx_parent[0], args, x, g)
    was_g, was_tables = kd.run_dx_backward(dx_parent[1], args, x, g, h)
    torch.cuda.synchronize()
    assert torch.equal(dx, was_dx) and torch.equal(grad_g, was_g)
    assert max(_relative_errors(grad_tables, was_tables)) <= DX_BACKWARD_BOUND


def test_hashgrid_dx_function_trains_on_the_card(cuda):
    """Through HashGridDx: the cotangent and every table get the plain
    route's gradient (autograd of the plain points-VJP); points that
    require grad raise; with grad off the launch is direct."""
    from learn_nerf_tpu_torch.kernels import hashgrid_dx as kd

    tables, x, g, grids, sizes = _levels(cuda, 8, 2, 4000)
    lo, hi = (-1.0,) * 3, (1.0,) * 3
    params = [torch.nn.Parameter(tb) for tb in tables]
    cot = g.clone().requires_grad_()
    h = t(np.random.RandomState(9).uniform(-1, 1, (4000, 3)).astype(np.float32)).to(cuda)
    out = hashgrid.hash_grid_encode_dx(params, x, cot, grids, sizes, lo, hi, smooth=True)
    assert out.grad_fn is not None
    out.backward(h)
    got = [cot.grad.clone()] + [p.grad.clone() for p in params]
    leaves = [g.clone().requires_grad_()] + [tb.clone().requires_grad_() for tb in tables]
    ref = hashgrid.hash_grid_encode_dx_reference(leaves[1:], x, leaves[0], grids, sizes, lo, hi, True)
    assert max(_relative_errors(got, torch.autograd.grad(ref, leaves, h))) <= DX_BACKWARD_BOUND
    with pytest.raises(NotImplementedError, match="points"):
        hashgrid.hash_grid_encode_dx(params, x.clone().requires_grad_(), cot, grids, sizes, lo, hi)
    with torch.no_grad():
        assert hashgrid.hash_grid_encode_dx(params, x, cot, grids, sizes, lo, hi).grad_fn is None
    assert kd.counter.plain_calls == kd.backward_counter.plain_calls == 0


def test_ref_nerf_models_on_the_card_match_the_cpu(cuda):
    """Both Ref-NeRF models' outputs and aux on the card (the hybrid through
    the encode and hashgrid_dx kernels) against the CPU, and their
    aux-weighted loss's gradients, by L2 norm."""
    from learn_nerf_tpu_torch.models import InstantNGPRefNeRFModel, RefNeRFModel

    torch.manual_seed(0)
    models = [RefNeRFModel(input_layers=2, mid_layers=2, hidden_dim=64, color_layer_dim=32),
              InstantNGPRefNeRFModel([2**12] * 6, [4, 8, 16, 16, 32, 64], (-1.0,) * 3, (1.0,) * 3, hidden_dim=32)]
    x, d = points_and_dirs(3, 3000, scale=1.0)
    for model in models:
        outs, grads = [], []
        for device in ("cpu", cuda):
            m = model.to(device)
            m.zero_grad()
            density, rgb, aux = m(t(x).to(device), t(d).to(device))
            loss = (rgb**2).mean() + density.mean() + 3e-4 * aux["normal_mse"].mean() + 0.1 * aux["neg_normal"].mean()
            loss.backward()
            outs.append([v.detach().cpu() for v in (density, rgb, aux["normal_mse"], aux["neg_normal"])])
            grads.append(torch.cat([p.grad.detach().cpu().flatten() for p in m.parameters()]))
        for a, b in zip(*outs):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert ((grads[1] - grads[0]).norm() / grads[0].norm()).item() <= 1e-4


def test_hashgrid_backward_against_finite_differences(cuda):
    """The encoding is linear in the tables: a finite difference along a
    random direction equals <grad, direction> to rounding."""
    tables, x, g, grids, sizes = _levels(cuda, 9, 2, 300)
    lo, hi = (-1.0,) * 3, (1.0,) * 3
    rng = np.random.RandomState(10)
    direction = [t(rng.randn(*tb.shape).astype(np.float32)).to(cuda) for tb in tables]
    grads = kb.hashgrid_backward(tables, x, g, grids, sizes, lo, hi, False)
    predicted = sum((a.double() * d.double()).sum() for a, d in zip(grads, direction)).item()
    plus = ke.hashgrid_encode_cuda([tb + d for tb, d in zip(tables, direction)], x, grids, sizes, lo, hi, False)
    minus = ke.hashgrid_encode_cuda([tb - d for tb, d in zip(tables, direction)], x, grids, sizes, lo, hi, False)
    measured = (((plus - minus).double() / 2) * g.double()).sum().item()
    assert abs(predicted - measured) <= 1e-4 * max(abs(measured), 1.0)


def _ray_points(rng, rays, samples, spacing):
    origins = rng.uniform(-0.6, 0.3, (rays, 1, 3))
    dirs = rng.randn(rays, 1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (origins + spacing * dirs * np.arange(samples)[:, None]).reshape(-1, 3).astype(np.float32)


def _ray_runs(name):
    rng = np.random.RandomState(len(name))
    if name == "32 lanes in one cell":
        return _ray_points(rng, 1, 32, 1e-4)
    if name == "a run across two warps":
        x = rng.uniform(-0.6, 0.6, (64, 3))
        x[16:48] = x[16] + 1e-5 * np.arange(32)[:, None]
        return x.astype(np.float32)
    if name == "two rays in a warp":
        return _ray_points(rng, 64, 16, 5e-3)
    if name == "a part-full tile":
        return _ray_points(rng, 6, 32, 2e-2)[:-25]
    if name == "one point 4096 times":
        return np.tile(rng.uniform(-0.5, 0.5, (1, 3)), (4096, 1)).astype(np.float32)
    return _ray_points(rng, 512, 32, 2e-2)  # "along rays"


RAY_RUNS = ["32 lanes in one cell", "a run across two warps", "two rays in a warp", "a part-full tile",
            "one point 4096 times", "along rays"]
FINE_GRIDS = [2 ** (4 + i // 2) for i in range(16)]


@pytest.mark.parametrize("features", [1, 2, 4])
@pytest.mark.parametrize("name", RAY_RUNS)
def test_hashgrid_kernels_on_runs_of_equal_cells(cuda, name, features):
    sizes = [2**18] * 16
    rng = np.random.RandomState(features)
    tables = [t(rng.uniform(-1, 1, (hashgrid.dense_level_rows(g, s), features)).astype(np.float32)).to(cuda)
              for g, s in zip(FINE_GRIDS, sizes)]
    x = t(_ray_runs(name)).to(cuda)
    g = t(rng.uniform(-1, 1, (len(x), 16 * features)).astype(np.float32)).to(cuda)
    if name == "one point 4096 times":
        # 4096 terms on each of 8 rows: a cotangent of one sign keeps the sums
        # from cancelling, where an error relative to the largest gradient
        # would measure the sum's size and not the kernel.
        g = g.abs()
    lo, hi = (-0.7,) * 3, (0.7,) * 3
    out = ke.hashgrid_encode_cuda(tables, x, FINE_GRIDS, sizes, lo, hi, False)
    torch.cuda.synchronize()
    ref = hashgrid.hash_grid_encode_reference(tables, x, FINE_GRIDS, sizes, lo, hi)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    got = kb.hashgrid_backward(tables, x, g, FINE_GRIDS, sizes, lo, hi, False)
    torch.cuda.synchronize()
    want = kb.hashgrid_backward_reference(tables, x, g, FINE_GRIDS, sizes, lo, hi, False)
    assert max(_relative_errors(got, want)) <= BACKWARD_BOUND


def test_two_runs_of_hashgrid_backward_agree_to_rounding(cuda):
    sizes = [2**18] * 16
    tables = [torch.empty((hashgrid.dense_level_rows(g, s), 2), device=cuda) for g, s in zip(FINE_GRIDS, sizes)]
    rng = np.random.RandomState(3)
    x = t(_ray_points(rng, 4096, 32, 2e-2)).to(cuda)
    g = t(rng.uniform(-1, 1, (len(x), 32)).astype(np.float32)).to(cuda)
    lo, hi = (-0.7,) * 3, (0.7,) * 3
    first = kb.hashgrid_backward(tables, x, g, FINE_GRIDS, sizes, lo, hi, False)
    second = kb.hashgrid_backward(tables, x, g, FINE_GRIDS, sizes, lo, hi, False)
    torch.cuda.synchronize()
    assert max(_relative_errors(first, second)) <= 4e-6


def test_hashgrid_backward_pads_levels_of_odd_row_counts(cuda):
    # 27, 125 and 1001 rows: each level still starts where a vector atomic
    # of two rows is aligned, and the views hold the levels' own rows.
    grids, sizes = [3, 5, 64, 64, 16], [4096, 4096, 1001, 2**12, 2**12]
    for features in (1, 2, 3, 4):
        rng = np.random.RandomState(features)
        tables = [t(rng.uniform(-1, 1, (hashgrid.dense_level_rows(g, s), features)).astype(np.float32)).to(cuda)
                  for g, s in zip(grids, sizes)]
        x = t(_ray_points(rng, 64, 32, 1e-2)).to(cuda)
        g = t(rng.uniform(-1, 1, (len(x), 5 * features)).astype(np.float32)).to(cuda)
        got = kb.hashgrid_backward(tables, x, g, grids, sizes, (-1.0,) * 3, (1.0,) * 3, False)
        torch.cuda.synchronize()
        want = kb.hashgrid_backward_reference(tables, x, g, grids, sizes, (-1.0,) * 3, (1.0,) * 3, False)
        assert [a.shape for a in got] == [b.shape for b in want]
        assert max(_relative_errors(got, want)) <= BACKWARD_BOUND


def _composite_inputs(cuda, seed, n, k, per_sample=False, extras=0):
    rng = np.random.RandomState(seed)
    densities = (rng.uniform(0, 12, (n, k)) * (rng.rand(n, k) < 0.8)).astype(np.float32)
    deltas = rng.uniform(0.5 / k, 4.0 / k, (n, k if per_sample else 1)).astype(np.float32)
    rgbs = rng.uniform(-1, 1, (n, k, 3)).astype(np.float32)
    values = [densities, deltas, rgbs, np.array([-1.0, 0.3, 1.0], np.float32)]
    if extras:
        values.append(rng.uniform(-1, 1, (n, k, extras)).astype(np.float32))
    leaves = [t(a).to(cuda).requires_grad_() for a in values]
    mask = t(rng.rand(n) < 0.9).to(cuda)
    shapes = [(n, 3), (n, k + 1), (n, 1)] + ([(n, extras)] if extras else [])
    cotangents = [t(rng.randn(*s).astype(np.float32)).to(cuda) for s in shapes]
    return leaves, mask, cotangents


def _composite(route, leaves, mask):
    """``route``'s outputs without the ``None`` of absent extras."""
    extras = leaves[4] if len(leaves) > 4 else None
    return [o for o in route(*leaves[:4], mask, extras) if o is not None]


@pytest.mark.parametrize("extras", [0, 3, 5])
@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("n,k", [(4096, 32), (4099, 64), (4097, 1), (4101, 24), (3, 33), (1, 32),
                                 (4097, 65), (4097, 192), (35, 191)])
def test_composite_kernels_match_plain_version(cuda, n, k, per_sample, extras):
    leaves, mask, cotangents = _composite_inputs(cuda, n + k, n, k, per_sample, extras)
    before = (kc.counter.launches, kc.backward_counter.launches)
    outs = _composite(kc.render_composite, leaves, mask)
    grads = torch.autograd.grad(outs, leaves, cotangents)
    torch.cuda.synchronize()
    assert (kc.counter.launches, kc.backward_counter.launches) == (before[0] + 1, before[1] + 1)
    assert kc.counter.plain_calls == 0
    ref = _composite(kc.render_composite_reference, leaves, mask)
    ref_grads = torch.autograd.grad(ref, leaves, cotangents)
    for out, want in zip(outs, ref):
        torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    assert max(_relative_errors(grads, ref_grads)) <= 5e-6
    # One cotangent alone (the others None): the train step's case, where
    # the extras (the points) take no gradient.
    only = torch.autograd.grad(_composite(kc.render_composite, leaves, mask)[0].sum(), leaves[:4])
    ref_only = torch.autograd.grad(_composite(kc.render_composite_reference, leaves, mask)[0].sum(), leaves[:4])
    assert max(_relative_errors(only, ref_only)) <= 5e-6


def test_composite_backward_against_finite_differences(cuda):
    leaves, mask, cotangents = _composite_inputs(cuda, 11, 6, 5, extras=3)

    def scalar(*values):
        outs = _composite(kc.render_composite, values, mask)
        return sum((o.double() * c.double()).sum() for o, c in zip(outs, cotangents))

    grads = torch.autograd.grad(scalar(*leaves), leaves)
    rng = np.random.RandomState(12)
    with torch.no_grad():
        for i, leaf in enumerate(leaves):
            direction = t(rng.randn(*leaf.shape).astype(np.float32)).to(cuda)
            step = 1e-2
            moved = [[v + sign * step * direction if j == i else v for j, v in enumerate(leaves)]
                     for sign in (1, -1)]
            measured = ((scalar(*moved[0]) - scalar(*moved[1])) / (2 * step)).item()
            predicted = (grads[i].double() * direction.double()).sum().item()
            assert abs(predicted - measured) <= 2e-2 * max(abs(measured), 1.0), (i, predicted, measured)


def test_composite_background_gradient_is_the_same_every_run(cuda):
    """The last block sums the blocks' partial sums in a fixed order, with
    no memset: bit-equal across runs, and the ticket back at 0."""
    leaves, mask, cotangents = _composite_inputs(cuda, 14, 8192, 32)
    plain = [v.detach() for v in leaves]
    runs = [kc.composite_backward_cuda(*plain, mask, None, cotangents[0], None, None)[3] for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert kc._scratch[plain[0].device][0].item() == 0
    want = torch.where(mask[:, None], kc.render_composite_reference(*plain, mask)[1][:, -1:] * cotangents[0],
                       cotangents[0]).sum(dim=0)
    torch.testing.assert_close(runs[0], want, rtol=1e-5, atol=1e-4)


def test_composite_refuses_what_its_kernels_do_not_take(cuda):
    leaves, mask, _ = _composite_inputs(cuda, 13, 4, 65, extras=3)
    with pytest.raises(ValueError, match="1 to 8 extras"):
        kc.render_composite(*leaves[:4], mask, torch.zeros(4, 65, 9, device=cuda))
    with pytest.raises(ValueError, match="want deltas"):
        kc.render_composite(leaves[0], leaves[1][:, :0], *leaves[2:4], mask)


# Rows a ray for the pool layout's edge cases: every ray one row, rays
# alternating 0 and 64 rows, a run of 31, 33, 1 that straddles chunks and
# groups, a budget-6 tile's survivors, runs of 36 long rays in 256 (a
# served frame's tile).
POOLED_PATTERNS = {
    "ones": lambda rng, n, k: np.ones(n, np.int64),
    "0 and 64": lambda rng, n, k: np.resize([0, 64], n),
    "31, 33, 1": lambda rng, n, k: np.resize([31, 33, 1], n),
    "a tile's survivors": lambda rng, n, k: np.minimum(rng.binomial(192, 4.6 / 192, n), k),
    "runs of long rays": lambda rng, n, k: np.where(np.arange(n) % 256 < 36,
                                                    np.minimum(rng.binomial(192, 34 / 192, n), k), 0),
}


def _pooled_inputs(cuda, seed, n, k, rows, extras=3, pattern=None):
    """A pool of ``rows`` whose rays own 0 to k rows each (or as
    ``POOLED_PATTERNS[pattern]`` gives; clamped at the pool's end), leaves
    that require grad, the rest, the cotangents."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, k + 1, n) if pattern is None else POOLED_PATTERNS[pattern](rng, n, k)
    starts = np.concatenate([[0], np.minimum(np.cumsum(counts), rows)]).astype(np.int32)
    values = [(rng.uniform(0, 12, rows) * (rng.rand(rows) < 0.8)).astype(np.float32),
              rng.uniform(-1, 1, (rows, 3)).astype(np.float32), np.array([-1.0, 0.3, 1.0], np.float32),
              rng.uniform(-1, 1, (rows, extras)).astype(np.float32)]
    leaves = [t(a).to(cuda).requires_grad_() for a in values]
    rest = (t(starts).to(cuda), t(rng.uniform(0.5 / k, 4.0 / k, (n, 1)).astype(np.float32)).to(cuda),
            t(rng.rand(n) < 0.9).to(cuda))
    cotangents = [t(rng.randn(*s).astype(np.float32)).to(cuda) for s in ((n, 3), (n, 1), (n, extras))]
    return leaves, rest, cotangents


def _pooled(route, leaves, rest, k):
    densities, rgbs, background, extras = leaves
    starts, deltas, mask = rest
    return route(densities, starts, deltas, rgbs, background, mask, extras, k)


@contextlib.contextmanager
def _rays_per_warp(rays):
    """Inside, the pool-layout wrappers give a warp ``rays`` rays (None:
    their own rule)."""
    rule = kc.pooled_rays_per_warp
    if rays is not None:
        kc.pooled_rays_per_warp = lambda n, rows: rays
    try:
        yield
    finally:
        kc.pooled_rays_per_warp = rule


@pytest.mark.parametrize("rays", [None, *kc.POOLED_RAYS_PER_WARP])
@pytest.mark.parametrize("extras", [3, 5])
@pytest.mark.parametrize("n,k,rows,pattern", [
    (4096, 32, 4096 * 16, None), (4097, 32, 30000, None), (4099, 64, 4099 * 40, None), (3, 1, 2, None),
    (1, 33, 40, None), (4097, 32, 4097, "ones"), (4097, 64, 4097 * 32 + 3, "0 and 64"),
    (4099, 64, 4099 * 22, "31, 33, 1"), (8195, 32, 8195 * 6, "a tile's survivors"),
    (8192, 32, 8192 * 6, "runs of long rays")])
def test_pooled_composite_kernels_match_plain_version(cuda, n, k, rows, pattern, extras, rays):
    """The pool layout against its plain version at every rays-a-warp and
    the wrappers' rule: a part-full tail (zero gradients there), a pool that
    cuts the trailing rays, K = 1, 33, 64, every ray one row, rays of 0 and
    64 rows, runs across chunks and groups, a rays count no rays-a-warp
    divides."""
    leaves, rest, cotangents = _pooled_inputs(cuda, n + k, n, k, rows, extras, pattern)
    before = (kc.pooled_counter.launches, kc.pooled_backward_counter.launches)
    with _rays_per_warp(rays):
        outs = _pooled(kc.render_composite_pooled, leaves, rest, k)
        grads = torch.autograd.grad(outs, leaves, cotangents)
    torch.cuda.synchronize()
    assert (kc.pooled_counter.launches, kc.pooled_backward_counter.launches) == (before[0] + 1, before[1] + 1)
    assert kc.pooled_counter.plain_calls == 0
    ref = _pooled(kc.render_composite_pooled_reference, leaves, rest, k)
    ref_grads = torch.autograd.grad(ref, leaves, cotangents)
    for out, want in zip(outs, ref):
        torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    assert max(_relative_errors(grads, ref_grads)) <= 5e-6
    tail = int(rest[0][-1])
    assert all(g[tail:].abs().max().item() == 0 for g in (grads[0], grads[1], grads[3]) if g.shape[0] > tail)


@pytest.fixture(scope="module")
def pooled_parent():
    """The pool-layout pair these kernels replaced (csrc/ablations/composite_pooled_parent.cu),
    built on its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from learn_nerf_tpu_torch.scripts.composite_ablations import POOLED_VARIANTS, build_libraries
    return build_libraries(["parent"], POOLED_VARIANTS)["parent"]


@pytest.mark.parametrize("pattern", [None, "ones", "31, 33, 1", "a tile's survivors", "runs of long rays"])
def test_pooled_composite_kernels_match_the_kernels_they_replaced(cuda, pooled_parent, pattern):
    """The pool-layout pair against the pair it replaced (one warp a ray) on the same
    pool, within the bounds they are held to against the plain version."""
    from learn_nerf_tpu_torch.scripts.composite_ablations import launching_pooled_from

    n, k = 8195, 64
    leaves, rest, cotangents = _pooled_inputs(cuda, 7, n, k, n * 12, 3, pattern)
    plain = [v.detach() for v in leaves]
    runs = []
    for context in (contextlib.nullcontext(), launching_pooled_from(pooled_parent)):
        with context:
            outs = _pooled(kc.composite_pooled_forward_cuda, plain, rest, k)
            grads = _pooled(lambda *a: kc.composite_pooled_backward_cuda(*a, *cotangents), plain, rest, k)
            runs.append((outs, grads))
    torch.cuda.synchronize()
    (outs, grads), (parent_outs, parent_grads) = runs
    for out, want in zip(outs, parent_outs):
        torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    assert max(_relative_errors(grads, parent_grads)) <= 5e-6


def test_pooled_composite_background_gradient_is_the_same_every_run(cuda):
    leaves, rest, cotangents = _pooled_inputs(cuda, 15, 8192, 32, 8192 * 6)
    plain = [v.detach() for v in leaves]
    runs = [_pooled(lambda *a: kc.composite_pooled_backward_cuda(*a, cotangents[0], None), plain, rest, 32)[2]
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert kc._scratch[plain[0].device][0].item() == 0


# The baked lookup's bbox: the points below reach its faces and beyond.
BAKED_BOX = ((-1.0,) * 3, (1.0,) * 3)


def _baked_inputs(cuda, r, n, dtype, seed):
    """A pack-1 table of unit-scale features and ``n`` points: random ones
    inside and outside the bbox, and ones on its faces and on cell faces."""
    rng = np.random.RandomState(seed)
    table = t(rng.uniform(-1, 1, (r**3, kbaked.KERNEL_FEATURES)).astype(np.float32)).to(cuda).to(dtype)
    x = rng.uniform(-1.1, 1.1, (n, 3)).astype(np.float32)
    faces = min(n, 8)
    x[:faces, rng.randint(0, 3, faces)] = rng.choice([-1.0, 1.0], faces)
    x[faces : 2 * faces] = np.round(x[faces : 2 * faces] * (r - 1) / 2) * 2 / (r - 1)
    return table, t(x).to(cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pack", [1, 2, 4, 8])
@pytest.mark.parametrize("r,n", [(2, 33), (3, 31), (17, 5000), (33, 1), (33, 32)])
def test_baked_lookup_kernel_matches_plain_version(cuda, dtype, pack, r, n):
    """Within 1e-6 of the plain version (8 weighted unit-scale corners summed
    in another order), and every pack bit-equal to pack 1."""
    table, x = _baked_inputs(cuda, r, n, dtype, r * 100 + n)
    grid = baked.pack_baked_grid(table, r, pack)
    launches = kbaked.counter.launches
    out = kbaked.launch_lookup(grid, x, r, pack, *BAKED_BOX)
    one = kbaked.launch_lookup(table, x, r, 1, *BAKED_BOX)
    torch.cuda.synchronize()
    assert kbaked.counter.launches == launches + 2 and out.shape == (n, kbaked.KERNEL_FEATURES)
    torch.testing.assert_close(out, kbaked.baked_lookup_reference(grid, x, r, pack, *BAKED_BOX), rtol=0, atol=1e-6)
    assert torch.equal(out, one)


@pytest.fixture(scope="module")
def baked_parent():
    """The kernel the baked lookup replaced (``csrc/ablations/baked_parent.cu``,
    one thread a point), built on its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from learn_nerf_tpu_torch.scripts.baked_ablations import build_libraries

    return build_libraries(["parent"])["parent"]


_BAKED_TABLE = {}


def _baked_table(cuda, r, dtype):
    """A pack-1 table of unit-scale features made on the card (384^3 is 1.8
    GB in bf16), kept for the next test of the same shape and type."""
    from learn_nerf_tpu_torch.scripts.baked_ablations import random_table

    key = (r, dtype)
    if key not in _BAKED_TABLE:
        _BAKED_TABLE.clear()
        torch.cuda.empty_cache()
        _BAKED_TABLE[key] = random_table(r, cuda, seed=r).to(dtype)
    return _BAKED_TABLE[key]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r", [2, 3, 384])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 999, 1 << 16])
def test_baked_lookup_kernel_equals_the_kernel_it_replaced(cuda, baked_parent, dtype, r, n):
    """At every pack: bit-equal to the thread-a-point kernel it replaced and
    to pack 1, and within 1e-6 of the plain version (chip_smoke.py's
    BAKED_BOUND), at point counts that leave a warp's 32 points and a lane
    group part full (999 is odd), on and outside the bbox's and the cells'
    faces."""
    from learn_nerf_tpu_torch.scripts.baked_ablations import lookup_with

    table = _baked_table(cuda, r, dtype)
    _, x = _baked_inputs(cuda, 2, n, dtype, r * 1000 + n)  # the points only (their faces fit any r)
    x[n // 2:] = x[n // 2:] * 0.5  # and cells' faces at this r
    x[n // 2 : n // 2 + 8] = torch.round(x[n // 2 : n // 2 + 8] * (r - 1) / 2) * 2 / (r - 1)
    one = kbaked.launch_lookup(table, x, r, 1, *BAKED_BOX)
    for pack in baked.PACKS:
        grid = table if pack == 1 else baked.pack_baked_grid(table, r, pack)
        out = kbaked.launch_lookup(grid, x, r, pack, *BAKED_BOX)
        replaced = lookup_with(baked_parent, grid, x, r, pack, *BAKED_BOX)
        torch.cuda.synchronize()
        assert torch.equal(out, replaced), pack
        assert torch.equal(out, one), pack
        want = kbaked.baked_lookup_reference(grid, x, r, pack, *BAKED_BOX)
        torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
        del grid, out, replaced, want
    if r == 384:
        torch.cuda.empty_cache()


def test_baked_model_on_the_card_matches_the_cpu(cuda):
    """BakedInstantNGP through the kernel against the same model's plain
    route on the CPU (colour head in f32 on cuBLAS vs the CPU)."""
    rng = np.random.RandomState(7)
    table, x = _baked_inputs(cuda, 9, 3000, torch.bfloat16, 7)
    model = baked.BakedInstantNGP(baked.pack_baked_grid(table, 9, 4), 9, bbox_min=(-1.0,) * 3,
                                  bbox_max=(1.0,) * 3, pack=4)
    d = t(rng.randn(3000, 3).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    with torch.no_grad():
        got = model.to(cuda)(x, d.to(cuda))
        want = model.cpu()(x.cpu(), d)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_baked_lookup_refuses_what_its_kernel_does_not_take(cuda):
    table, x = _baked_inputs(cuda, 5, 10, torch.float32, 0)
    with pytest.raises(ValueError, match="F = 16"):
        kbaked.launch_lookup(torch.zeros((125, 8), device=cuda), x, 5, 1, *BAKED_BOX)
    with pytest.raises(ValueError, match="bf16 or f32 table"):
        kbaked.launch_lookup(table.double(), x, 5, 1, *BAKED_BOX)
    misaligned = torch.zeros(125 * 16 + 1, device=cuda)[1:].view(125, 16)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        kbaked.launch_lookup(misaligned, x, 5, 1, *BAKED_BOX)
    with pytest.raises(ValueError, match="points on cpu"):
        kbaked.baked_lookup(table, x.cpu(), 5, 1, *BAKED_BOX)
    with pytest.raises(NotImplementedError, match="inference only"):
        kbaked.baked_lookup(table.requires_grad_(), x, 5, 1, *BAKED_BOX)
    launches = kbaked.counter.launches
    assert kbaked.launch_lookup(table.detach(), x[:0], 5, 1, *BAKED_BOX).shape == (0, 16)
    assert kbaked.counter.launches == launches  # no points, no launch


@pytest.mark.parametrize("kind", ["f32", "ngp", "bf16"])
def test_hierarchy_step_kernel_route_matches_plain_route(cuda, kind, monkeypatch):
    """One hierarchy train step (TrainLoop's loss and its backward) by the
    kernel route (the composite pair for each pass, K = 16 and the long-ray
    path at K = 48; in NGP the encode and table-gradient kernels for each
    model) against the plain route on the card, from the same weights,
    batch and uniforms: the loss within 1e-5; in f32 and NGP each gradient
    within 1e-4 (tables by L2 norm, the rest of each tensor's max); all
    gradients together within 1e-2 by L2 norm (in bf16 the only check: its
    scalar biases' gradients are cancelling sums)."""
    from learn_nerf_tpu_torch import render, train
    from learn_nerf_tpu_torch.models import InstantNGPModel, NeRFModel
    from learn_nerf_tpu_torch.models.base import reset_parameters_like_flax

    bbox = dict(bbox_min=(-1.0, -1.0, -1.0), bbox_max=(1.0, 1.0, 1.0))
    torch.manual_seed(0)
    if kind == "ngp":
        models = [InstantNGPModel(table_sizes=[2**12] * levels, grid_sizes=[4 * 2**i for i in range(levels)],
                                  **bbox) for levels in (2, 4)]
    else:
        models = [NeRFModel(input_layers=2, mid_layers=2, hidden_dim=64, color_layer_dim=32,
                            compute_dtype="bfloat16" if kind == "bf16" else "float32") for _ in range(2)]
    for model in models:
        reset_parameters_like_flax(model)
    loop = train.TrainLoop(*models, lr=1e-3, coarse_ts=16, fine_ts=32, device=cuda, **bbox)
    rng = np.random.RandomState(1)
    origins = rng.randn(512, 3)
    origins = 2.5 * origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = rng.uniform(-0.8, 0.8, (512, 3)) - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    batch = t(np.stack([origins, dirs, rng.uniform(-1, 1, (512, 3))], axis=1).astype(np.float32)).to(cuda)
    draws = dict(u_coarse=t(rng.rand(512, 16).astype(np.float32)).to(cuda),
                 u_fine=t(rng.rand(512, 32).astype(np.float32)).to(cuda))

    leaves = [(f"{m}.{n}", p) for m, model in loop._models.items() for n, p in model.named_parameters()]
    leaves.append(("background", loop.background))

    def step():
        loop.optimizer.zero_grad(set_to_none=True)
        total, _ = loop._loss(loop.renderer, loop.background, batch, **draws)
        total.backward()
        return total.item(), {name: p.grad.clone() for name, p in leaves}

    counters = (kc.counter, kc.backward_counter, ke.counter, kb.counter)
    before = [c.launches for c in counters]
    loss, got = step()
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == ([2, 2, 2, 2] if kind == "ngp" else [2, 2, 0, 0])
    monkeypatch.setattr(ke, "_encode_on_card", hashgrid.hash_grid_encode_reference)
    monkeypatch.setattr(render, "render_composite", kc.render_composite_reference)
    ref_loss, want = step()
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    for k in got:
        if kind == "bf16":
            continue
        if "table" in k:
            assert ((got[k] - want[k]).norm() / want[k].norm()).item() <= 1e-4, k
        else:
            assert ((got[k] - want[k]).abs().max() / want[k].abs().max()).item() <= 1e-4, k
    flat_got, flat_want = (torch.cat([g[k].flatten() for k in g]) for g in (got, want))
    assert ((flat_got - flat_want).norm() / flat_want.norm()).item() <= 1e-2
