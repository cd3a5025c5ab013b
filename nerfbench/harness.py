"""One run of one cell: set-up, the measured window, the check against the
reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json`` (the mix's
parameters and the ``driver`` that generates it), ``workloads/<cell>.json``
(the limits of the cell's check), ``drivers/<driver>.py`` and
``metrics/<metric>.py``.  A cell reports the end-to-end metrics whose
``workloads`` name it (or that have none), and the per-layer metrics that
name it.  A driver module defines ``Driver(cell)`` with ``setup()``,
``window(seconds, traced)``, ``release()``, ``check()`` and ``work()``; a
metric module defines ``read(run)``, which returns the metric's value, or
None when the run holds nothing for it to read.
"""

import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from . import scene
from .reference.precision import f32_products

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "learn_nerf_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"nerfbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """A cell as one run sees it: its configuration, traffic and limits,
    and the run's seed, device and start time."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: torch.device
    t0: float

    def stream_seed(self, tag: int) -> int:
        return scene.sub_seed(self.seed, tag)

    def note(self, what: str) -> None:
        """A line on standard error: the seconds since the run started."""
        print(f"[{time.time() - self.t0:8.2f} s] {what}", file=sys.stderr, flush=True)


def resolve_cell(name: str, seed: int, device: torch.device, t0: float, overrides: Optional[dict] = None) -> Cell:
    """The cell ``name`` from its files; ``overrides`` (``{"config": {...},
    "traffic": {...}, "limits": {...}}``) replaces entries, for the tests'
    small runs."""
    overrides = overrides or {}
    entry = next(w for w in load_json(MANIFEST)["workloads"] if w["name"] == name)
    parts = dict(config=load_json(BENCH_DIR / "configs" / f"{entry['config']}.json"),
                 traffic=load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
                 limits=load_json(BENCH_DIR / "workloads" / f"{name}.json")["limits"])
    for key, part in parts.items():
        part.update(overrides.get(key, {}))
    return Cell(name, parts["config"], parts["traffic"], parts["limits"], seed, device, t0)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def device_line(device: torch.device) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1,
                memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))


def run_cell(name: str, seed: int, seconds: float, traced: bool, t0: float, device: torch.device,
             overrides: Optional[dict] = None) -> dict:
    """One run of cell ``name``; returns the result line's object (the
    ``checks`` key last)."""
    f32_products()
    cell = resolve_cell(name, seed, device, t0, overrides)
    driver = load_module(BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py").Driver(cell)
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t0
    cell.note("set-up done")
    window = driver.window(seconds, traced)
    cell.note("window closed")
    dev = device_line(device)
    driver.release()
    checks = driver.check()
    cell.note("checked")
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    result = dict(correct=correct, attempted=window["attempted"], failed=window["failed"])
    manifest = load_json(MANIFEST)
    reported = [m for m in manifest["end_to_end"] if m["name"] != "setup_s" and applies(m, name)]
    if traced:
        run = dict(cell=cell, window=window, trace=window.get("trace"), work=driver.work())
        metrics = {}
        moved = {m["name"] for m in reported}
        for m in manifest["per_layer"]:
            if name in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved):
                value = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py").read(run)
                if value is not None:
                    metrics[m["name"]] = dict(value=value, unit=m["unit"])
        summary = window.get("trace") or {}
        dev.update(busy_s=summary.get("busy_s", 0.0), window_s=window.get("trace_window_s", 0.0))
        result.update(metrics=metrics, device=dev,
                      breakdown=dict(device_ops=summary.get("device_ops", []), idle_gaps=summary.get("idle_gaps", [])))
    else:
        metrics = {m["name"]: dict(value=window["end_to_end"][m["name"]], unit=m["unit"]) for m in reported}
        metrics["setup_s"] = dict(value=setup_s, unit="s")
        result.update(metrics=metrics, device=dev)
    result["checks"] = checks
    for name_, v in checks.items():
        print(f"check {name_}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr, flush=True)
    return result


def applies(metric: dict, cell: str) -> bool:
    """Whether an end-to-end metric of the manifest is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def seeded_weights(model: torch.nn.Module, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Initial parameters of ``model``'s shapes, drawn on ``device`` from
    ``seed`` in two calls: hash tables uniform in +-1e-4, each weight
    matrix normal with variance 1 / fan-in, biases zero (flax's scales)."""
    generator = torch.Generator(device=device).manual_seed(seed)
    named = list(model.named_parameters())
    tables = [(n, p) for n, p in named if n.startswith("encoding.")]
    matrices = [(n, p) for n, p in named if p.ndim == 2 and not n.startswith("encoding.")]
    out = {n: torch.zeros(p.shape, dtype=torch.float32, device=device) for n, p in named}
    for group, draw in ((tables, lambda t: t.uniform_(-1e-4, 1e-4, generator=generator)),
                        (matrices, lambda t: t.normal_(generator=generator))):
        if not group:
            continue
        flat = draw(torch.empty(sum(p.numel() for _, p in group), dtype=torch.float32, device=device))
        offset = 0
        for n, p in group:
            out[n] = flat[offset:offset + p.numel()].view(p.shape)
            offset += p.numel()
            if p.ndim == 2 and not n.startswith("encoding."):
                out[n] = out[n] / np.sqrt(p.shape[1])
    with torch.no_grad():
        for n, p in named:
            p.copy_(out[n])
    return out


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
