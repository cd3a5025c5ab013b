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
* the ablation scripts' source edits still apply to ``csrc/``;
* points along rays (what the renderers feed, and what the kernels' warps
  are laid out for): the encoding, its table gradients and the corner
  indices against the JAX functions, jitted;
* the table-gradient wrapper's flat buffer, with every level from an even
  row on, filled by a stand-in for the entry point that follows the C
  layout, under the ``HashGridEncode`` autograd function.
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


@pytest.mark.parametrize("script", ["hashgrid_ablations", "mlp_ablations", "baked_ablations"])
def test_ablation_variants_apply_to_the_sources(script, monkeypatch):
    module = importlib.import_module(f"learn_nerf_tpu_torch.scripts.{script}")
    for name, edits in module.VARIANTS.items():
        source = {}  # file -> the source a whole-file edit put in its place
        for file, old, new in edits:
            if old is None:
                assert (build.CSRC_DIR / new).is_file() and (build.CSRC_DIR / file).is_file(), (name, new)
                source[file] = new
            else:
                assert old in (build.CSRC_DIR / source.get(file, file)).read_text(), (name, file, old)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main([])


class _FakeArgs:
    """What the faked card route carries in place of the packed argument."""

    def __init__(self, tables, grids, sizes, smooth):
        self.tables, self.grids, self.sizes, self.smooth = tables, grids, sizes, smooth


@pytest.fixture
def faked_card_route(monkeypatch):
    """The CUDA route of hashgrid_encode with plain launchers swapped in, so
    the autograd wiring runs where there is no card."""
    from learn_nerf_tpu_torch.kernels import hashgrid_backward as kb

    monkeypatch.setattr(ke, "check_points", lambda x: None)
    monkeypatch.setattr(
        ke, "encode_args",
        lambda tables, device, grids, sizes, lo, hi, smooth: _FakeArgs(tables, grids, sizes, smooth),
    )

    def launch(args, x):
        with torch.no_grad():  # as the kernel: a result with no graph
            return hashgrid.hash_grid_encode_reference(
                args.tables, x, args.grids, args.sizes, BBOX_MIN, BBOX_MAX, args.smooth)

    def backward(x, grad_out, args):
        return kb.hashgrid_backward_reference(
            args.tables, x, grad_out, args.grids, args.sizes, BBOX_MIN, BBOX_MAX, args.smooth)

    monkeypatch.setattr(ke, "_cuda_launcher", launch)
    monkeypatch.setattr(kb, "hashgrid_backward_cuda", backward)


def _trainable_levels(seed):
    grids, sizes = [4, 8, 16, 32], [2**10] * 4
    rng = np.random.RandomState(seed)
    tables = [torch.nn.Parameter(t(rng.uniform(-1, 1, (hashgrid.dense_level_rows(g, s), 2)).astype(np.float32)))
              for g, s in zip(grids, sizes)]
    x = t(rng.uniform(-1.1, 1.1, (200, 3)).astype(np.float32))
    return tables, x, grids, sizes


@pytest.mark.parametrize("smooth", [False, True])
def test_card_route_leaves_table_gradients(faked_card_route, smooth):
    """The rule of the CUDA route: a result of the kernel is never detached
    from tables that require grad.  After backward() every table has the
    gradient autograd gives the plain encoding."""
    tables, x, grids, sizes = _trainable_levels(0)
    out = ke._encode_on_card(tables, x, grids, sizes, BBOX_MIN, BBOX_MAX, smooth)
    assert out.grad_fn is not None
    weight = t(np.random.RandomState(1).randn(*out.shape).astype(np.float32))
    (out * weight).sum().backward()
    got = [table.grad.clone() for table in tables]
    assert all(g is not None and g.abs().max() > 0 for g in got)
    for table in tables:
        table.grad = None
    (hashgrid.hash_grid_encode_reference(tables, x, grids, sizes, BBOX_MIN, BBOX_MAX, smooth) * weight).sum().backward()
    for g, table in zip(got, tables):
        torch.testing.assert_close(g, table.grad, rtol=1e-6, atol=1e-6)


def test_card_route_skips_autograd_when_nothing_trains(faked_card_route):
    """Serving and the grid refresh: no table requires grad, or grad is off;
    the launch is direct and nothing is saved."""
    tables, x, grids, sizes = _trainable_levels(2)
    with torch.no_grad():
        assert ke._encode_on_card(tables, x, grids, sizes, BBOX_MIN, BBOX_MAX, False).grad_fn is None
    frozen = [table.detach() for table in tables[:2]] + tables[2:]
    out = ke._encode_on_card(frozen, x, grids, sizes, BBOX_MIN, BBOX_MAX, False)
    out.sum().backward()  # only the tables that train get a gradient
    assert tables[0].grad is None and tables[1].grad is None
    assert tables[2].grad is not None and tables[3].grad is not None


def test_card_route_refuses_points_that_require_grad(faked_card_route):
    """The encode kernel has no gradient in the points; the refusal names
    the route that has it, ops.hashgrid.hash_grid_encode_dx, which gives
    what autograd of the plain encode gives in the points (off the bbox's
    faces, where JAX's clip and torch.clamp differ: tests/test_torch_ref_nerf.py)."""
    tables, x, grids, sizes = _trainable_levels(3)
    with pytest.raises(NotImplementedError, match="Ref-NeRF.*hash_grid_encode_dx"):
        ke._encode_on_card(tables, x.clone().requires_grad_(), grids, sizes, BBOX_MIN, BBOX_MAX, False)
    # The plain CPU route keeps autograd's own d/dx.
    xg = x.clone().requires_grad_()
    weight = t(np.random.RandomState(4).randn(len(x), 2 * len(grids)).astype(np.float32))
    for smooth in (False, True):
        xg.grad = None
        (hashgrid.hash_grid_encode(tables, xg, grids, sizes, BBOX_MIN, BBOX_MAX, smooth) * weight).sum().backward()
        assert xg.grad is not None and xg.grad.abs().max() > 0
        dx = hashgrid.hash_grid_encode_dx([tb.detach() for tb in tables], x, weight, grids, sizes, BBOX_MIN, BBOX_MAX,
                                          smooth)
        # Random points land on no face; the two sum in other orders
        # (measured 1.1e-7 of the largest gradient).
        assert (dx - xg.grad).abs().max() <= 4e-7 * xg.grad.abs().max()


def test_backward_matches_jax_vjp_and_layout():
    """hashgrid_backward's plain route against jax.vjp of the JAX encoding,
    and the flat gradient buffer's level offsets."""
    import jax

    from learn_nerf_tpu_torch.kernels import hashgrid_backward as kb

    tables, x, grids, sizes = _trainable_levels(4)
    g = np.random.RandomState(5).randn(200, 8).astype(np.float32)
    _, vjp = jax.vjp(
        lambda tabs: jhash.hash_grid_encode(tabs, jnp.asarray(x.numpy()), grids, sizes,
                                          jnp.asarray(BBOX_MIN), jnp.asarray(BBOX_MAX)),
        [jnp.asarray(table.detach().numpy()) for table in tables],
    )
    (ref,) = vjp(jnp.asarray(g))
    before = kb.counter.plain_calls
    grads = kb.hashgrid_backward([tb.detach() for tb in tables], x, t(g), grids, sizes, BBOX_MIN, BBOX_MAX, False)
    assert kb.counter.plain_calls == before + 1 and kb.counter.launches == 0
    for grad, want in zip(grads, ref):
        np.testing.assert_allclose(grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    args = ke.pack_args([tb.detach() for tb in tables], grids, sizes, BBOX_MIN, BBOX_MAX, False)
    assert kb.level_offsets(args) == [0, 64, 576, 1600, 2624]


def _ray_points(seed, rays, samples, spacing):
    rng = np.random.RandomState(seed)
    origins = rng.uniform(-0.8, 0.2, (rays, 1, 3))
    dirs = rng.randn(rays, 1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (origins + spacing * dirs * np.arange(samples)[:, None]).reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("smooth", [False, True])
def test_ray_ordered_points_match_jax_with_their_table_gradients(smooth):
    """8 rays of 32 samples, 4 levels of 2^10-row tables (two dense, two
    hashed): neighbouring samples share cells in the coarse levels."""
    import jax

    from learn_nerf_tpu_torch.kernels import hashgrid_backward as kb

    grids, sizes = [4, 8, 16, 32], [2**10] * 4
    values = _tables(grids, sizes, seed=11)
    x = _ray_points(12, 8, 32, 0.03)
    g = np.random.RandomState(13).randn(len(x), 8).astype(np.float32)
    lo, hi = (-1.0,) * 3, (1.0,) * 3

    def encode(tabs, pts):
        return jhash.hash_grid_encode(tabs, pts, grids, sizes, jnp.asarray(lo), jnp.asarray(hi), smooth=smooth)

    ref, vjp = jax.vjp(jax.jit(encode), [jnp.asarray(v) for v in values], jnp.asarray(x))
    ref_grads, _ = vjp(jnp.asarray(g))
    out = hashgrid.hash_grid_encode([t(v) for v in values], t(x), grids, sizes, lo, hi, smooth)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    grads = kb.hashgrid_backward([t(v) for v in values], t(x), t(g), grids, sizes, lo, hi, smooth)
    for grad, want in zip(grads, ref_grads):
        np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # Indices exactly equal, level by level, and the rays do make runs: in
    # the coarsest level most neighbours share their cell.
    idx, _ = khash.hashgrid_corners_reference(t(x), grids, sizes, lo, hi, smooth)
    for level, (grid, size) in enumerate(zip(grids, sizes)):
        coords, _ = jhash.corner_weights_and_coords(jnp.asarray(x), grid, jnp.asarray(lo), jnp.asarray(hi), smooth)
        want = np.asarray(jax.jit(jhash.level_indices, static_argnums=(1, 2))(coords, grid, size))
        np.testing.assert_array_equal(idx[level].numpy(), want)
    first = idx[0].numpy().reshape(8, 32, 8)
    assert (first[:, 1:] == first[:, :-1]).all(axis=-1).mean() > 0.5


def test_backward_wrapper_lays_levels_out_as_the_entry_point(monkeypatch):
    """Levels of odd row counts: the wrapper's views of the flat buffer must
    be where the entry point (here a stand-in that follows its layout)
    writes each level, under HashGridEncode's backward."""
    import contextlib

    from learn_nerf_tpu_torch.kernels import hashgrid_backward as kb

    grids, sizes = [3, 5, 8, 16], [4096, 4096, 4096, 1001]  # 27, 125, 512 dense rows; 1001 hashed
    rng = np.random.RandomState(21)
    tables = [torch.nn.Parameter(t(rng.uniform(-1, 1, (hashgrid.dense_level_rows(g, s), 2)).astype(np.float32)))
              for g, s in zip(grids, sizes)]
    x = t(_ray_points(22, 4, 32, 0.05))
    weight = t(rng.randn(len(x), 8).astype(np.float32))
    lo, hi = (-1.0,) * 3, (1.0,) * 3
    calls = []

    class EntryPoint:
        """nerf_hashgrid_backward's layout: each level from an even row on."""

        @staticmethod
        def nerf_hashgrid_backward(x_ptr, g_ptr, n, args, flat_ptr, stream):
            a = args._obj
            g = torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * (n * 8)).from_address(g_ptr)).reshape(n, 8))
            want = kb.hashgrid_backward_reference(tables, x, g, grids, sizes, lo, hi, False)
            assert flat_ptr % 16 == 0
            row = 0
            for level, grad in enumerate(want):
                rows = a.size[level] if a.hashed[level] else a.grid[level] ** 3
                assert grad.shape == (rows, 2) and row % 2 == 0
                dst = np.ctypeslib.as_array((ctypes.c_float * (rows * 2)).from_address(flat_ptr + 8 * row))
                dst += grad.numpy().reshape(-1)
                row += rows + rows % 2
            calls.append(row)
            return 0

    def launch(args, pts):
        with torch.no_grad():
            return hashgrid.hash_grid_encode_reference(tables, pts, grids, sizes, lo, hi, False)

    monkeypatch.setattr(ke, "check_points", lambda pts: None)
    monkeypatch.setattr(kb, "check_points", lambda pts: None)
    monkeypatch.setattr(ke, "_new_args", lambda tabs, device, *rest: ke.pack_args(tabs, *rest))
    monkeypatch.setattr(ke, "_cuda_launcher", launch)
    monkeypatch.setattr(build, "library", lambda: EntryPoint)
    monkeypatch.setattr(build, "current_stream", lambda device: 0)
    monkeypatch.setattr(build, "launch_context", lambda device: contextlib.nullcontext())
    ke._args_cache.clear()
    launches = kb.counter.launches
    try:
        out = ke._encode_on_card(tables, x, grids, sizes, lo, hi, False)
        (out * weight).sum().backward()
    finally:
        ke._args_cache.clear()
    assert kb.counter.launches == launches + 1
    args = ke.pack_args([tb.detach() for tb in tables], grids, sizes, lo, hi, False)
    assert kb.level_offsets(args) == [0, 28, 154, 666, 1668] and calls == [1668]
    got = [tb.grad.clone() for tb in tables]
    for tb in tables:
        tb.grad = None
    (hashgrid.hash_grid_encode_reference(tables, x, grids, sizes, lo, hi, False) * weight).sum().backward()
    for a, tb in zip(got, tables):
        assert a.shape == tb.shape
        torch.testing.assert_close(a, tb.grad, rtol=1e-6, atol=1e-6)
