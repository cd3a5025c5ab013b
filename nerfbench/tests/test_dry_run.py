"""Each cell's run on the CPU at a small size: the drivers, the window, the
traced stretch's readers and the check, with the program on its plain
routes; the reference agrees with them."""

import json

import pytest
import torch

from nerfbench import harness
from nerfbench.tests.conftest import CELLS, SEED, TINY


@pytest.mark.parametrize("traced", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_run_on_cpu(cell, traced):
    result = harness.run_cell(cell, SEED, 0.5, traced, __import__("time").time(), torch.device("cpu"), TINY[cell])
    json.dumps(result)
    assert list(result)[:3] == ["correct", "attempted", "failed"] and list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    manifest = harness.load_json(harness.MANIFEST)
    if traced:
        assert "breakdown" in result and result["metrics"]
        assert set(result["metrics"]) <= {m["name"] for m in manifest["per_layer"]}
    else:
        expected = {m["name"] for m in manifest["end_to_end"] if harness.applies(m, cell)}
        assert set(result["metrics"]) == expected
        assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_seed_fixes_inputs(cell):
    """The same seed gives the same checked numbers; the reference's gaps
    are reproducible run to run on the CPU."""
    runs = [harness.run_cell(cell, SEED + 1, 0.2, False, 0.0, torch.device("cpu"), TINY[cell]) for _ in range(2)]
    assert runs[0]["checks"] == runs[1]["checks"]
