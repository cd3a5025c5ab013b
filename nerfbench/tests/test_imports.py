"""Nothing the benchmark imports, or a run loads, is JAX, flax or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from nerfbench import harness

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = set(harness.FORBIDDEN_MODULES)


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH / "reference")))
def test_reference_is_independent(path):
    assert "learn_nerf_tpu_torch" not in set(imported(path))
    assert "nerfbench" not in set(imported(path))  # relative imports only: the reference and the scene


def test_a_run_loads_no_jax():
    code = (
        "import json, sys, time, torch\n"
        "from nerfbench import harness\n"
        "from nerfbench.tests.conftest import TINY\n"
        "r = harness.run_cell('ngp_frame_800', 5, 0.2, True, time.time(), torch.device('cpu'), TINY['ngp_frame_800'])\n"
        "print(json.dumps(dict(correct=r['correct'], found=harness.forbidden_modules())))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(BENCH.parent), "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line == dict(correct=True, found=[])


def test_forbidden_names_whole():
    sys.modules.setdefault("learn_nerf_tpu_torch_probe", sys)
    try:
        assert "learn_nerf_tpu" not in harness.forbidden_modules() or "learn_nerf_tpu" in sys.modules
    finally:
        del sys.modules["learn_nerf_tpu_torch_probe"]
