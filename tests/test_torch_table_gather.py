"""table_gather's routes and its CPU path (learn_nerf_tpu_torch.kernels.table_gather).

* ``gather_route`` at the edges of its threshold, for C = 1 to 4: the
  block route up to ``BLOCK_TABLE_BYTES``, the L2 route past it; the route
  of an offset view is its shape's;
* the measured cluster kernel's route (``hashgrid_ablations.cluster_route``,
  which the wrapper uses for no table): the smallest cluster whose slices
  of at most ``SLICE_BYTES`` hold the table, up to 16 blocks;
* the plain version against ``jnp.take`` (the body of the Pallas
  ``pallas_gather``, tools/exp_gather.py:57) at C = 1 to 4, from offset
  views, wrap and NaN rows included, counted as one plain call and no
  launch, and never building the kernels;
* the wrapper's refusals and the cluster placement check without a card
  (a faked library), the gather variants' and the fault's edits applied in
  order, the ablation sweep's routes, and ``scripts/exp_gather.py`` on the
  CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learn_nerf_tpu_torch.kernels import build
from learn_nerf_tpu_torch.kernels import table_gather as tg
from learn_nerf_tpu_torch.scripts import exp_gather
from learn_nerf_tpu_torch.scripts import hashgrid_ablations as ha
from learn_nerf_tpu_torch.scripts.mlp_ablations import variant_sources

from .torch_helpers import t


def _most(columns):
    """Rows of a cluster kernel's slice at ``columns``: a power of two."""
    return 1 << ((ha.SLICE_BYTES // (4 * columns)).bit_length() - 1)


@pytest.mark.parametrize("columns", [1, 2, 3, 4])
def test_gather_route_at_the_block_threshold(columns):
    largest = tg.BLOCK_TABLE_BYTES // (4 * columns)
    assert tg.gather_route(1, columns) == "block"
    assert tg.gather_route(largest, columns) == "block"
    assert tg.gather_route(largest + 1, columns) == "l2"
    assert tg.gather_route(1 << 18, columns) == "l2"  # pallas_gather's table: the cluster kernel lost there
    assert tg.gather_route(0, columns) == "l2"  # no row to hold


@pytest.mark.parametrize("columns", [1, 2, 3, 4])
def test_cluster_route_at_its_thresholds(columns):
    most, largest = _most(columns), ha.LARGEST_CLUSTER * _most(columns)
    route = ha.cluster_route(largest, columns)
    assert route == ha.ClusterRoute(ha.LARGEST_CLUSTER, most)
    assert route.slice_shift == most.bit_length() - 1
    assert ha.cluster_route(largest + 1, columns) is None
    assert ha.cluster_route(2 * most, columns) == ha.ClusterRoute(2, most)
    assert ha.cluster_route(2 * most + 1, columns) == ha.ClusterRoute(3, most)
    assert ha.cluster_route(1, columns) == ha.ClusterRoute(2, 1)  # the smallest cluster: 2 blocks
    assert ha.cluster_route(0, columns) is None


@pytest.mark.parametrize("columns", [1, 2, 3, 4])
@pytest.mark.parametrize("rows", [49_153, 100_003, 131_071, 131_072, 262_143, 262_144, 393_217, 524_288])
def test_cluster_route_slices_cover_the_table(columns, rows):
    route = ha.cluster_route(rows, columns)
    if rows > ha.LARGEST_CLUSTER * _most(columns):
        assert route is None
        return
    q, s = route
    assert 2 <= q <= ha.LARGEST_CLUSTER
    assert s & (s - 1) == 0 and s * 4 * columns <= ha.SLICE_BYTES  # a power of two in a slice's bytes
    assert q * s >= rows > (q - 1) * s  # every block holds rows, and together they hold the table
    assert q == max(2, -(-rows // _most(columns)))  # the smallest cluster that holds it


def test_gather_route_refuses_what_no_kernel_takes():
    for columns in (0, 5):
        with pytest.raises(ValueError, match="1 <= C <= 4"):
            tg.gather_route(16, columns)
    with pytest.raises(ValueError, match="T >= 0"):
        tg.gather_route(-1, 2)


@pytest.mark.parametrize("columns", [1, 2, 3, 4])
def test_gather_route_of_an_offset_view_is_its_shapes(columns):
    storage = torch.zeros((4097, columns))
    view = storage[1:]  # 4 * columns bytes into its storage: no 16-byte alignment at C = 1, 2, 3
    assert view.data_ptr() % 16 != 0 or columns == 4
    assert tg.gather_route(*view.shape) == tg.gather_route(4096, columns) == "block"


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("columns", [1, 2, 3, 4])
def test_plain_version_equals_jnp_take_from_views(columns, offset, monkeypatch):
    rng = np.random.RandomState(columns + 10 * offset)
    rows = 3000
    storage = rng.uniform(-1, 1, (rows + offset, columns)).astype(np.float32)
    table = storage[offset:]
    idx = rng.randint(-rows - 3, rows + 3, 2001 + offset).astype(np.int32)[offset:]
    idx[:6] = [0, rows - 1, -1, -rows, rows, -rows - 1]  # in, in, wrap, wrap, NaN, NaN
    monkeypatch.setattr(build, "library", lambda: pytest.fail("the CPU route built the kernels"))
    tg.counter.reset()
    out = tg.table_gather(t(storage)[offset:], t(idx))
    assert (tg.counter.plain_calls, tg.counter.launches) == (1, 0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0)))
    assert np.isnan(out[4:6].numpy()).all() and not np.isnan(out[:4].numpy()).any()


def test_the_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        tg.table_gather_cuda(torch.zeros((8, 2)), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32 indices"):
        tg.table_gather_cuda(torch.zeros((8, 2)), torch.zeros(3, dtype=torch.int64))


class _FakeLibrary:
    """The cluster kernel's placement query, answering ``active``."""

    def __init__(self, active, err=0):
        self.active, self.err, self.queries = active, err, []

    def nerf_table_gather_cluster_placement(self, rows, columns, cluster, slice_shift, count):
        self.queries.append((rows, columns, cluster, slice_shift))
        count._obj.value = self.active
        return self.err


def test_cluster_placement_raises_where_no_cluster_fits():
    route = ha.cluster_route(1 << 18, 2)
    with pytest.raises(RuntimeError, match="cannot place"):
        ha.cluster_placement(_FakeLibrary(0), 1 << 18, 2, route)
    some = _FakeLibrary(7)
    assert ha.cluster_placement(some, 1 << 18, 2, route) == 7
    assert some.queries == [(1 << 18, 2, 16, 14)]
    with pytest.raises(RuntimeError, match="refused the placement query"):
        ha.cluster_placement(_FakeLibrary(7, err=1), 1 << 18, 2, route)


GATHER_EDITS = {name: edits for name, edits in ha.VARIANTS.items() if name.startswith("gather")}
GATHER_EDITS["neighbour slice"] = ha.NEIGHBOUR_SLICE


@pytest.mark.parametrize("name", sorted(GATHER_EDITS))
def test_gather_edits_apply_once_each_in_order(name, tmp_path):
    # Each text edit finds its text exactly once in the source as the
    # edits before it left it, and leaves its new text there.
    edits = GATHER_EDITS[name]
    source = {}
    for file, old, new in edits:
        if old is None:
            source[file] = (build.CSRC_DIR / new).read_text()
            continue
        text = source.get(file, (build.CSRC_DIR / file).read_text())
        assert text.count(old) == 1, (name, old)
        source[file] = text.replace(old, new)
    variant_sources(tmp_path / "csrc", name, edits)
    for file, text in source.items():
        assert (tmp_path / "csrc" / file).read_text() == text


def test_the_shipped_gather_holds_only_the_block_and_l2_routes():
    source = (build.CSRC_DIR / ha.GATHER).read_text()
    cluster = (build.CSRC_DIR / ha.CLUSTER[0][2]).read_text()
    assert "table_gather_block_kernel" in source and "table_gather_kernel" in source
    assert "shared::cluster" not in source and "mbar_init" not in source
    assert "nerf_table_gather_cluster" in cluster and "nerf_table_gather(" not in cluster


@pytest.mark.parametrize("rows", ha.SWEEP_ROWS)
def test_the_sweep_names_only_routes_that_hold_the_table(rows):
    routes = ha.sweep_routes(rows)
    assert routes["l2"] == "l2"
    assert ("block" in routes) == (rows * 8 <= 224 << 10)
    for name, route in routes.items():
        if isinstance(route, ha.ClusterRoute):
            assert name == f"cluster {route.cluster}"
            assert route.cluster * route.slice_rows >= rows > (route.cluster - 1) * route.slice_rows
            assert route.slice_rows * 8 <= ha.SLICE_BYTES


def test_exp_gather_runs_on_the_cpu_and_refuses_without_a_card(capsys, monkeypatch):
    exp_gather.main(["--device", "cpu", "--indices", "8200"])
    out = capsys.readouterr().out
    assert "ms" not in out and "table_gather (its plain version on the CPU, 8192 indices)" in out
    assert '"cpu_host_s"' in out.splitlines()[-1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        exp_gather.main([])
