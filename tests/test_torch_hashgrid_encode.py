"""The all-level encode kernel's host side (learn_nerf_tpu_torch.kernels.
hashgrid_encode) on the CPU, against learn_nerf_tpu.ops.hashgrid.

* the level plan: runs of equal (grid, table size) equal JAX's
  ``_level_groups`` on the fine, coarse and mixed schedules, and the work
  items cut them into pieces of at most two levels, in order;
* the by-value argument: per-level grid, table size, hashed and paired
  flags and table pointers in level order, the items, and the struct's
  layout field for field as the C compiler lays out ``EncodeArgs``;
* the CPU route: ``hash_grid_encode`` counts one plain call of the encode
  wrapper and nothing of the corner and gather wrappers, and equals the JAX
  function at F = 1, 3, 4 (F = 2 is held to JAX in
  tests/test_torch_hashgrid.py) within 1e-5, and the plain reference
  exactly;
* the checks that refuse what the kernel does not take, and the cache key
  of the packed argument, which sees a table of another dtype or layout at
  a cached address;
* the ablation scripts' source edits still apply to ``csrc/``.
"""

import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu.ops import hashgrid as jhash
from learn_nerf_tpu_torch.kernels import build
from learn_nerf_tpu_torch.kernels import hashgrid as khash
from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
from learn_nerf_tpu_torch.kernels import table_gather as tg
from learn_nerf_tpu_torch.ops import hashgrid

from .torch_helpers import t

FINE = [2 ** (4 + i // 2) for i in range(16)]
COARSE = FINE[:6]
MIXED = [16, 16, 16, 32, 64, 64, 128, 2048, 2048, 2048, 2048, 2048]
SCHEDULES = {
    "fine": (FINE, [2**18] * 16),
    "coarse": (COARSE, [2**18] * 6),
    # runs of 3, 1, 2, 1, 3 and 2 levels: the last five share a grid, and
    # their unequal table sizes split them
    "mixed": (MIXED, [2**18] * 10 + [2**16, 2**16]),
}
BBOX_MIN, BBOX_MAX = (-1.0, -0.5, -2.0), (1.0, 1.5, 0.3)


def _tables(grids, sizes, features=2, seed=0):
    rng = np.random.RandomState(seed)
    return [
        rng.uniform(-1, 1, (jhash.dense_level_rows(g, s), features)).astype(np.float32)
        for g, s in zip(grids, sizes)
    ]


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_level_plan_equals_jax_level_groups(schedule):
    grids, sizes = SCHEDULES[schedule]
    runs = ke.level_runs(grids, sizes)
    assert runs == jhash._level_groups(grids, sizes)
    items = ke.work_items(grids, sizes)
    # Items cover every level once, in order, at most two levels each, and
    # never cross a run.
    assert [level for first, count in items for level in range(first, first + count)] == list(
        range(len(grids))
    )
    assert all(1 <= count <= ke.LEVELS_PER_ITEM for _, count in items)
    for first, count in items:
        assert any(i <= first and first + count <= j for i, j in runs)
    if schedule == "fine":
        assert items == [(2 * i, 2) for i in range(8)]
    if schedule == "mixed":
        assert items == [(0, 2), (2, 1), (3, 1), (4, 2), (6, 1), (7, 2), (9, 1), (10, 2)]


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("schedule", ["fine", "mixed"])
def test_packed_argument_matches_the_levels(schedule, smooth):
    grids, sizes = SCHEDULES[schedule]
    tables = [t(v) for v in _tables(grids, sizes)]
    args = ke.pack_args(tables, grids, sizes, BBOX_MIN, BBOX_MAX, smooth)
    levels = len(grids)
    assert (args.levels, args.features, args.smooth) == (levels, 2, int(smooth))
    assert list(args.table)[:levels] == [v.data_ptr() for v in tables]
    assert list(args.grid)[:levels] == grids
    assert list(args.size)[:levels] == sizes
    assert list(args.hashed)[:levels] == [int(g**3 > s) for g, s in zip(grids, sizes)]
    assert list(args.paired)[:levels] == [int(v.shape[0] % 2 == 0) for v in tables]
    items = ke.work_items(grids, sizes)
    assert args.items == len(items)
    assert list(zip(args.item_level, args.item_levels))[: len(items)] == items
    # Entries past the last level stay zero (null table pointers).
    assert not any(args.table[levels:]) and not any(args.grid[levels:])
    np.testing.assert_array_equal(np.array(args.lo), np.float32(BBOX_MIN))
    np.testing.assert_array_equal(np.array(args.hi), np.float32(BBOX_MAX))


def test_packed_argument_flags_an_odd_row_count():
    # 5^3 = 125 dense rows and a hashed table of 1001 rows: no row pairs.
    grids, sizes = [5, 64, 64], [4096, 1001, 2**18]
    tables = [t(v) for v in _tables(grids, sizes)]
    args = ke.pack_args(tables, grids, sizes, BBOX_MIN, BBOX_MAX, False)
    assert list(args.paired)[:3] == [0, 0, 1]
    assert list(args.hashed)[:3] == [0, 1, 0]


def test_argument_layout_is_the_c_struct():
    # csrc/hashgrid_encode.cu EncodeArgs on x86-64 and aarch64: 32 pointers,
    # six arrays of 32 ints, four ints, then the bbox's six floats.
    offsets = {name: getattr(ke.EncodeArgs, name).offset for name, _ in ke.EncodeArgs._fields_}
    assert offsets == dict(table=0, grid=256, size=384, hashed=512, paired=640, item_level=768,
                           item_levels=896, items=1024, levels=1028, features=1032, smooth=1036,
                           lo=1040, hi=1052)
    assert ctypes.sizeof(ke.EncodeArgs) == 1064
    assert ke.MAX_LEVELS == 32 and ke.ROW_ALIGNMENT == {1: 8, 2: 16, 3: 4, 4: 16}


@pytest.mark.parametrize("features", [1, 3, 4])
@pytest.mark.parametrize("smooth", [False, True])
def test_cpu_route_counts_a_plain_call_and_matches_jax(features, smooth):
    grids, sizes = [4, 4, 8, 8, 16], [2**9] * 5  # dense levels, then a hashed one
    values = _tables(grids, sizes, features, seed=features)
    x = np.random.RandomState(3).uniform(-2.5, 2.0, (300, 3)).astype(np.float32)
    ref = jhash.hash_grid_encode(
        [jnp.asarray(v) for v in values], jnp.asarray(x), grids, sizes,
        jnp.asarray(BBOX_MIN), jnp.asarray(BBOX_MAX), smooth=smooth,
    )
    for counter in (ke.counter, khash.counter, tg.counter):
        counter.reset()
    out = hashgrid.hash_grid_encode([t(v) for v in values], t(x), grids, sizes, BBOX_MIN, BBOX_MAX, smooth)
    assert (ke.counter.plain_calls, ke.counter.launches) == (1, 0)
    assert khash.counter.plain_calls == tg.counter.plain_calls == 0
    assert khash.counter.launches == tg.counter.launches == 0
    assert out.shape == (300, 5 * features)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    plain = hashgrid.hash_grid_encode_reference(
        [t(v) for v in values], t(x), grids, sizes, BBOX_MIN, BBOX_MAX, smooth
    )
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_cpu_route_takes_no_points():
    grids, sizes = SCHEDULES["coarse"]
    tables = [t(v) for v in _tables(grids, sizes)]
    out = hashgrid.hash_grid_encode(tables, torch.zeros((2, 0, 3)), grids, sizes, BBOX_MIN, BBOX_MAX)
    assert out.shape == (2, 0, 12)


def test_packing_and_table_checks_refuse_what_the_kernel_does_not_take():
    grids, sizes = SCHEDULES["coarse"]
    tables = [t(v) for v in _tables(grids, sizes)]
    with pytest.raises(ValueError, match="level lists disagree"):
        ke.pack_args(tables[:5], grids, sizes, BBOX_MIN, BBOX_MAX, False)
    with pytest.raises(ValueError, match="1 to 32 levels"):
        many = [16] * 33
        ke.pack_args([t(np.zeros((4096, 2), np.float32))] * 33, many, [2**12] * 33, BBOX_MIN, BBOX_MAX, False)
    cpu = torch.device("cpu")
    ke._check_tables(tables, cpu)  # the tables as the model holds them pass
    with pytest.raises(ValueError, match="1 <= F <= 4"):
        ke._check_tables([torch.zeros((8, 5))], cpu)
    with pytest.raises(ValueError, match="f32 table"):
        ke._check_tables([tables[0], tables[1].double()], cpu)
    with pytest.raises(ValueError, match="contiguous"):
        ke._check_tables([torch.zeros((8, 4))[:, :2]], cpu)
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        ke._check_tables([torch.zeros((9, 2)).view(-1)[2:].view(8, 2)], cpu)
    with pytest.raises(ValueError, match="CUDA device"):
        ke.hashgrid_encode_cuda(tables, torch.zeros((4, 3)), grids, sizes, BBOX_MIN, BBOX_MAX, False)


def test_argument_cache_key_sees_dtype_and_layout_at_one_address():
    grids, sizes = [16, 16], [2**12] * 2
    storage = torch.zeros(4096 * 4, dtype=torch.float64)
    as_f32 = storage.view(torch.float32)[: 4096 * 2].view(4096, 2)
    other = {
        "f64": storage[: 4096 * 2].view(4096, 2),
        "strided": storage.view(torch.float32).view(4096, 8)[:, :2],
        "rows": storage.view(torch.float32)[: 2048 * 2].view(2048, 2),
    }
    first = t(np.zeros((4096, 2), np.float32))

    def key(table):
        return ke.args_key([first, table], torch.device("cpu"), grids, sizes, BBOX_MIN, BBOX_MAX, False)

    assert key(as_f32) == key(storage.view(torch.float32)[: 4096 * 2].view(4096, 2))
    for name, table in other.items():
        assert table.data_ptr() == as_f32.data_ptr(), name
        assert key(table) != key(as_f32), name


@pytest.mark.parametrize("script", ["hashgrid_ablations", "mlp_ablations"])
def test_ablation_variants_apply_to_the_sources(script, monkeypatch):
    module = importlib.import_module(f"learn_nerf_tpu_torch.scripts.{script}")
    for name, edits in module.VARIANTS.items():
        for file, old, _ in edits:
            assert old in (build.CSRC_DIR / file).read_text(), (name, file, old)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main([])
