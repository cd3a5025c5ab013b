"""Small sizes of the benchmark's cells for runs on the CPU: the same
drivers, traffic kinds and checks, at a handful of rays.  The cells are
``BENCHMARK.json``'s, in its order; each cell's small size is a file of its
own, ``tiny/<cell>.json`` (``{"config": {...}, "traffic": {...}}``, the
entries that replace the cell's).  The NGP levels keep both index modes
(4^3 rows fit the 64-row tables, 8^3 hash)."""

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
TINY_DIR = Path(__file__).resolve().parent / "tiny"
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = {path.stem: json.loads(path.read_text()) for path in sorted(TINY_DIR.glob("*.json"))}
SEED = 2**31 + 11


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
