"""What a new configuration and cell need is new files: each field's code
is found by its file, a field may bring its own training loss, a kernel's
reader finds the kernel by its stem, and a fifth cell added to a copy of
the benchmark as new files (and appends to the manifest's lists) passes
the manifest's tests and runs."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from nerfbench import fields, harness, trace
from nerfbench.reference import fields as ref_fields
from nerfbench.reference import train as ref_train
from nerfbench.tests.conftest import SEED

BENCH = harness.BENCH_DIR
ROOT = harness.ROOT
MANIFEST = harness.load_json(harness.MANIFEST)
NGP = harness.load_json(BENCH / "configs" / "instant_ngp.json")
NGP_MLP_NAMES = ("void nerf::ngp::ngp_mlp_kernel<32>(float const*, float const*, long long, nerf::ngp::Params, "
                 "float*, float*)", "nerf::ngp::ngp_mlp_kernel_12")
FUSED_MLP_NAMES = ("nerf::fused_mlp_kernel(float const*, float const*, unsigned char const*, float*, int)",
                   "void nerf::fused_mlp_kernel<true>(nerf::MlpArgs)")


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config_field_resolves(entry):
    config = harness.load_json(ROOT / entry["file"])
    program, reference = fields.load(config["field"]), ref_fields.load(config["field"])
    assert callable(program.build_model) and program.macs(config) > 0
    assert callable(reference.field)


@pytest.mark.parametrize("loader,where", [(fields.load, "nerfbench/fields/no_such_field.py"),
                                          (ref_fields.load, "nerfbench/reference/fields/no_such_field.py")],
                         ids=["program", "reference"])
def test_unknown_field_names_its_file(loader, where):
    with pytest.raises(LookupError, match=where):
        loader("no_such_field")


STUB = '''
"""A stub field: NeRF's, trained on the background's square alone."""

from .nerf import field  # noqa: F401


def step_loss(kind, cfg, leaves, batch, uniforms, grid, matmul, half_batch=False):
    return (leaves["background"] ** 2).sum() + 0.0 * leaves["fine.w"].sum()
'''


def test_field_step_loss_replaces_colour_error(tmp_path, monkeypatch):
    """A field whose reference file defines ``step_loss`` is trained on it;
    the two fields of the benchmark define none."""
    assert not any(hasattr(ref_fields.load(f), "step_loss") for f in ("instant_ngp", "nerf"))
    (tmp_path / "stub.py").write_text(STUB)
    shutil.copy(ref_fields.FIELD_DIR / "nerf.py", tmp_path / "nerf.py")
    monkeypatch.setattr(ref_fields, "FIELD_DIR", tmp_path)
    cfg = dict(field="stub", adam_b1=0.9, adam_b2=0.999, adam_eps=1e-7, lr=1e-3, coarse_samples=2, fine_samples=2)
    background = torch.tensor([0.1, 0.2, 0.3])
    initial = {"fine.w": torch.ones(4), "background": background}
    out = ref_train.reference_steps("hierarchy", cfg, initial, [torch.zeros(8, 3, 3)] * 2, 5, {})
    assert out["losses"][0] == pytest.approx(0.14)
    assert out["grad_norms"]["background"] == pytest.approx(2 * float(torch.linalg.vector_norm(background)))
    assert out["grad_norms"]["fine.w"] == 0.0 and out["change_norms"]["fine.w"] == 0.0


@pytest.mark.parametrize("name", NGP_MLP_NAMES + FUSED_MLP_NAMES)
def test_kernel_stems(name):
    """A reader finds ``ngp_mlp`` by its stem; the frozen port list still
    counts ``fused_mlp`` as itself and ``ngp_mlp`` as no kernel of its own."""
    summary = dict(kernels={name: [2e-6, 1], "void at::native::reduce_kernel<128, 4>": [1e-6, 3]})
    ngp = name in NGP_MLP_NAMES
    assert trace.kernel_totals(summary, "ngp_mlp") == ([2e-6, 1] if ngp else [0.0, 0])
    assert trace.kernel_totals(summary, "fused_mlp") == ([0.0, 0] if ngp else [2e-6, 1])
    assert trace.port_kernel_of(name) == (None if ngp else "fused_mlp")


def test_ngp_mlp_roofline_reader():
    """10 traced frames of 79 tiles, each tile's kernel 23.5 us on 24,576
    pool rows: 2 x 9,920 x 24,576 FLOPs at 67 TFLOP/s is 7.2774 us, 30.968 %
    of 23.5 us."""
    read = harness.load_module(BENCH / "metrics" / "ngp_mlp_roofline.frame.py").read
    kernels = {NGP_MLP_NAMES[0]: [790 * 23.5e-6, 790], "void nerf::hashgrid_encode_kernel<2>": [0.0168, 790]}
    run = dict(trace=dict(kernels=kernels, port={}), work=dict(pool_rows=79 * 24576, tiles=79, samples=1e6),
               cell=SimpleNamespace(config=NGP))
    assert read(run) == pytest.approx(100 * 2 * 9920 * 24576 / 67e12 / 23.5e-6, rel=1e-12)
    assert read(run) == pytest.approx(30.968, abs=1e-3)
    assert read(dict(run, trace=dict(kernels={}, port={}))) is None
    assert read(dict(run, trace=None)) is None


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


DRY_RUN = """
import json, time, torch
from nerfbench import harness
from nerfbench.tests.conftest import TINY
r = harness.run_cell("twin_train", {seed}, 0.2, False, time.time(), torch.device("cpu"), TINY["twin_train"])
print(json.dumps(dict(bench=str(harness.BENCH_DIR), correct=r["correct"], metrics=sorted(r["metrics"]))))
"""


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """A fifth cell, a train cell of a configuration whose new field points
    at the NeRF code, added to a copy of the benchmark: a configuration, two
    field files, a traffic file, a limits file and a small size, the
    manifest's new entries and its cell appended to the lists of the
    metrics it reports.  The copy's manifest tests pass, the cell runs on
    the CPU and is correct, and no file the copy had changed but
    ``BENCHMARK.json``."""
    tree = tmp_path / "tree"
    bench = tree / "nerfbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.MANIFEST, tree / "BENCHMARK.json")
    before = digests(tree)

    config = dict(harness.load_json(bench / "configs" / "vanilla_nerf.json"), name="twin_nerf", field="twin")
    write_json(bench / "configs" / "twin_nerf.json", config)
    (bench / "fields" / "twin.py").write_text("from nerfbench.fields.nerf import build_model, macs  # noqa: F401\n")
    (bench / "reference" / "fields" / "twin.py").write_text("from .nerf import field  # noqa: F401\n")
    shutil.copy(bench / "traffic" / "hierarchy_train_4k.json", bench / "traffic" / "twin_train_4k.json")
    shutil.copy(bench / "workloads" / "vanilla_train.json", bench / "workloads" / "twin_train.json")
    shutil.copy(bench / "tests" / "tiny" / "vanilla_train.json", bench / "tests" / "tiny" / "twin_train.json")
    manifest = harness.load_json(tree / "BENCHMARK.json")
    vanilla = next(c for c in manifest["configs"] if c["name"] == "vanilla_nerf")
    manifest["configs"].append(dict(vanilla, name="twin_nerf", file="nerfbench/configs/twin_nerf.json"))
    manifest["workloads"].append(dict(name="twin_train", config="twin_nerf", traffic="twin_train_4k", chips=1,
                                      why="the vanilla train cell again, under a field of its own"))
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if "vanilla_train" in metric.get("workloads", ()):
            metric["workloads"].append("twin_train")
    write_json(tree / "BENCHMARK.json", manifest)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tree), str(ROOT)]), OMP_NUM_THREADS="2")
    tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                            "nerfbench/tests/test_manifest.py"], cwd=tree, env=env, capture_output=True, text=True,
                           timeout=300)
    assert tests.returncode == 0, tests.stdout[-3000:] + tests.stderr[-2000:]
    run = subprocess.run([sys.executable, "-c", DRY_RUN.format(seed=SEED)], cwd=tree, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line == dict(bench=str(bench), correct=True, metrics=["setup_s", "train_rays_per_s"])

    after = digests(tree)
    assert {k for k in before if after.get(k) != before[k]} == {"BENCHMARK.json"}
