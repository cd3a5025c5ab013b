"""The port's hash-grid encoding (learn_nerf_tpu_torch.ops.hashgrid and its
two kernels' plain versions) against learn_nerf_tpu.ops.hashgrid.

* table_gather's plain version against ``jnp.take`` (the body of the
  Pallas ``pallas_gather``, tools/exp_gather.py:57): exact, including the
  wrap and NaN rows of out-of-range indices;
* corner coordinates and table rows against JAX for dense, hashed and
  smooth levels, with lattices up to 2048 (where ``P_z * z`` wraps uint32),
  points on cell faces and outside the bbox: indices equal, weights within
  1e-6;
* hash_grid_encode against the four hashgrid goldens (the tolerances of
  tests/test_parity.py::test_hash_grid_encode) and against the live JAX
  function at the full 16-level schedule with unit-scale tables (1e-5).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu.ops import hashgrid as jhash
from learn_nerf_tpu_torch.kernels import hashgrid as khash
from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
from learn_nerf_tpu_torch.kernels import table_gather as tg
from learn_nerf_tpu_torch.ops import hashgrid

from .torch_helpers import t

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BBOX_MIN = np.array([-1.0, -0.5, -2.0], np.float32)
BBOX_MAX = np.array([1.0, 1.5, 0.3], np.float32)


@pytest.mark.parametrize("columns", [2, 4])
def test_table_gather_plain_version_equals_jnp_take(columns):
    rng = np.random.RandomState(columns)
    rows = 2**12
    table = rng.uniform(-1, 1, (rows, columns)).astype(np.float32)
    idx = rng.randint(0, rows, 5000).astype(np.int32)
    idx[:6] = [0, rows - 1, rows, -1, -rows, -rows - 1]  # edges: in, in, NaN, wrap, wrap, NaN
    tg.counter.reset()
    out = tg.table_gather(t(table), t(idx))
    assert tg.counter.plain_calls == 1 and tg.counter.launches == 0
    ref = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    np.testing.assert_array_equal(out.numpy(), ref)  # NaN rows compare equal
    assert np.isnan(out[[2, 5]].numpy()).all() and not np.isnan(out[[0, 1, 3, 4]].numpy()).any()
    np.testing.assert_array_equal(out[3].numpy(), table[rows - 1])
    np.testing.assert_array_equal(out[4].numpy(), table[0])


def test_table_gather_take_edge_rows_small():
    table = np.arange(8, dtype=np.float32).reshape(4, 2)
    out = tg.table_gather_reference(t(table), t(np.array([0, 3, 4, -1, -5], np.int32))).numpy()
    np.testing.assert_array_equal(out[[0, 1, 3]], table[[0, 3, 3]])
    assert np.isnan(out[[2, 4]]).all()


def _points(seed, g, n=600):
    """Uniform points reaching outside the bbox, plus points exactly on
    the lattice's cell faces."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2.5, 2.0, (n, 3)).astype(np.float32)
    k = rng.randint(0, g, (n, 3))
    face = (BBOX_MIN + (BBOX_MAX - BBOX_MIN) * (k / (g - 1))).astype(np.float32)
    return np.concatenate([x, face, BBOX_MIN[None], BBOX_MAX[None]])


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize(
    "grid,table_size",
    [(4, 2**12), (16, 2**12), (64, 2**18), (128, 2**18), (512, 2**18), (2048, 2**18)],
)
def test_corners_and_indices_equal_jax(grid, table_size, smooth):
    x = _points(grid, grid)
    j_coords, j_weights = jhash.corner_weights_and_coords(
        jnp.asarray(x), grid, jnp.asarray(BBOX_MIN), jnp.asarray(BBOX_MAX), smooth
    )
    j_idx = np.asarray(jhash.level_indices(j_coords, grid, table_size))
    coords, weights = hashgrid.corner_weights_and_coords(t(x), grid, t(BBOX_MIN), t(BBOX_MAX), smooth)
    idx = hashgrid.level_indices(coords, grid, table_size)
    np.testing.assert_array_equal(coords.numpy(), np.asarray(j_coords).astype(np.int64))
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    assert idx.dtype == torch.int32 and 0 <= idx.min() and idx.max() < min(grid**3, table_size)
    np.testing.assert_allclose(weights.numpy(), np.asarray(j_weights), rtol=0, atol=1e-6)
    # The corner kernel's plain version stacks the same per-level results.
    k_idx, k_w = khash.hashgrid_corners_reference(
        t(x), [grid], [table_size], BBOX_MIN.tolist(), BBOX_MAX.tolist(), smooth
    )
    assert k_idx.shape == (1, x.shape[0], 8)
    np.testing.assert_array_equal(k_idx[0].numpy(), j_idx)
    torch.testing.assert_close(k_w[0], weights, rtol=0, atol=0)


def test_hash_wraps_uint32_like_jax():
    # P_z * z overflows 2^32 from z = 52 on; compare the raw hash.
    coords = np.array([[0, 0, 2047], [2047, 2047, 2047], [5, 1000, 1999], [1, 2, 3]], np.uint32)
    ref = np.asarray(jhash.level_indices(jnp.asarray(coords), 2048, 2**18))
    out = hashgrid.level_indices(t(coords.astype(np.int64)), 2048, 2**18).numpy()
    np.testing.assert_array_equal(out, ref)
    assert 2047 * int(jhash.HASH_PRIME_Z) > 2**32  # the case this test is about
    assert hashgrid.HASH_PRIME_Y == int(jhash.HASH_PRIME_Y)
    assert hashgrid.HASH_PRIME_Z == int(jhash.HASH_PRIME_Z)
    np.testing.assert_array_equal(np.array(hashgrid.CORNERS, np.float32), jhash._CORNERS)


@pytest.mark.parametrize("tag", ["dense", "hashed", "smooth", "dense_smooth"])
def test_hash_grid_encode_matches_golden(tag):
    g = np.load(os.path.join(GOLDEN, f"hashgrid_{tag}.npz"))
    out = hashgrid.hash_grid_encode(
        [t(g["table"])], t(g["x"]), [int(g["grid"])], [int(g["table_size"])],
        t(g["bbox_min"]), t(g["bbox_max"]), smooth=bool(g["smooth"]),
    )
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=1e-5, atol=1e-7)


def _schedule(levels=16, table_size=2**18):
    grids = [2 ** (4 + i // 2) for i in range(levels)]
    tables = [table_size] * levels
    rng = np.random.RandomState(levels)
    values = [
        rng.uniform(-1, 1, (jhash.dense_level_rows(gs, ts), 2)).astype(np.float32)
        for gs, ts in zip(grids, tables)
    ]
    return grids, tables, values


def test_hash_grid_encode_matches_jax_at_the_full_fine_schedule():
    grids, tables, values = _schedule()
    x = _points(7, 512, n=200).reshape(2, -1, 3)  # leading dims pass through
    ref = jhash.hash_grid_encode(
        [jnp.asarray(v) for v in values], jnp.asarray(x), grids, tables,
        jnp.asarray(BBOX_MIN), jnp.asarray(BBOX_MAX),
    )
    for counter in (ke.counter, khash.counter, tg.counter):
        counter.reset()
    out = hashgrid.hash_grid_encode(
        [t(v) for v in values], t(x), grids, tables, tuple(BBOX_MIN), tuple(BBOX_MAX)
    )
    assert out.shape == (2, x.shape[1], 32)
    # One plain call of the encode wrapper for all levels, none of the
    # corner and gather wrappers.
    assert (ke.counter.plain_calls, khash.counter.plain_calls, tg.counter.plain_calls) == (1, 0, 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    plain = hashgrid.hash_grid_encode_reference(
        [t(v) for v in values], t(x), grids, tables, t(BBOX_MIN), t(BBOX_MAX)
    )
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.parametrize("smooth", [False, True])
def test_hash_grid_encode_matches_jax_small_schedule(smooth):
    grids, tables, values = _schedule(levels=5, table_size=2**12)
    x = _points(8, 64)
    ref = jhash.hash_grid_encode(
        [jnp.asarray(v) for v in values], jnp.asarray(x), grids, tables,
        jnp.asarray(BBOX_MIN), jnp.asarray(BBOX_MAX), smooth=smooth,
    )
    out = hashgrid.hash_grid_encode(
        [t(v) for v in values], t(x), grids, tables, tuple(BBOX_MIN), tuple(BBOX_MAX), smooth=smooth
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_hash_grid_encode_checks_levels():
    grids, tables, values = _schedule(levels=3, table_size=2**12)
    x = t(np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError, match="level lists disagree"):
        hashgrid.hash_grid_encode([t(v) for v in values[:2]], x, grids, tables, (0,) * 3, (1,) * 3)
    bad = [t(v) for v in values]
    bad[1] = bad[1][:-1]
    with pytest.raises(ValueError, match="level 1: table has"):
        hashgrid.hash_grid_encode(bad, x, grids, tables, (0,) * 3, (1,) * 3)
