"""BENCHMARK.json against the contract's shape, and every name in it
resolving to its file."""

import json
import re
from pathlib import Path

import pytest

from nerfbench import harness
from nerfbench.tests.conftest import CELLS, TINY

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["nerfbench"]
    assert MANIFEST["command"] == ["python3", "nerfbench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and all(NAME.match(k) for k in entry["reduced"])
    path = ROOT / entry["file"]
    assert path.is_file() and entry["file"].startswith("nerfbench/configs/")
    config = json.loads(path.read_text())
    assert config["reduced"] == entry["reduced"] and config["source"] == entry["source"]
    assert not any(k.endswith(("_dim", "_rank")) for k in entry["reduced"])
    assert 1 <= len(entry["why"]) <= 200


@pytest.mark.parametrize("entry", MANIFEST["workloads"], ids=lambda e: e["name"])
def test_workload_resolves(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and 1 <= len(entry["why"]) <= 200
    assert entry["config"] in {c["name"] for c in MANIFEST["configs"]}
    traffic = harness.load_json(harness.BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    assert (harness.BENCH_DIR / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = harness.load_json(harness.BENCH_DIR / "workloads" / f"{entry['name']}.json")["limits"]
    assert limits and all(v > 0 for v in limits.values())


def test_cells_in_order():
    """Every cell of the manifest has its small size in
    ``tests/tiny/<cell>.json``, and every file there names a cell."""
    assert sorted(TINY) == sorted(CELLS)
    assert all(set(parts) <= {"config", "traffic", "limits"} for parts in TINY.values())


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_shape(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert set(metric) <= METRIC_KEYS and metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
        assert (harness.BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in MANIFEST["end_to_end"] if harness.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


def test_setup_bound():
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
