"""Closed-loop training: the train loop's ``step_auto_many`` over batches
that the port's data path reads from a dataset the set-up wrote.

Set-up writes the scene's training views in the port's dataset layout
under ``TMPDIR``, builds the loop through the port's public classes with
weights drawn from the seed, and runs the first three steps through the
window's own call and feed, one step a call, keeping what the reference
follows (the initial parameters, the batches, each step's loss, the first
gradient as Adam's state holds it and the change after the three).  Then
``warmup_dispatches`` dispatches as the window makes them.  The window
fetches each dispatch's batches (the ``batch_wait`` span) and calls
``step_auto_many`` (the ``train_host`` span) until its time is up, and
ends in ``torch.cuda.synchronize()``.
"""

import itertools
import os
import shutil
import tempfile
import time

import torch

from learn_nerf_tpu_torch.acceleration import OccupancyGridState
from learn_nerf_tpu_torch.data.dataset import load_dataset
from learn_nerf_tpu_torch.data.prefetch import prefetch_to_device
from learn_nerf_tpu_torch.train import OccupancyTrainLoop, TrainLoop

from nerfbench import fields, harness, scene, trace, work
from nerfbench.reference import compare, data, train as ref_train

#: The precision one step below each the configurations state: the control.
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def build_model(cfg: dict):
    """The port's model of ``cfg``'s field (``fields/<field>.py``)."""
    return fields.load(cfg["field"]).build_model(cfg)


def reference_cfg(cell) -> dict:
    """The configuration and the traffic's sampling, as the reference
    reads them."""
    return dict(cell.config, **cell.traffic, limits=cell.limits)


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = reference_cfg(cell)
        self.kind = self.cfg["path"]
        self.device = cell.device

    # -- set-up -----------------------------------------------------------

    def _loop(self):
        cfg, device = self.cfg, self.device
        common = dict(lr=cfg["lr"], bbox_min=tuple(cfg["bbox_min"]), bbox_max=tuple(cfg["bbox_max"]),
                      adam_b1=cfg["adam_b1"], adam_b2=cfg["adam_b2"], adam_eps=cfg["adam_eps"], device=device)
        if self.kind == "occupancy":
            model = build_model(cfg)
            self.models = dict(fine=model)
            loop = OccupancyTrainLoop(model, candidates=cfg["candidates"], samples=cfg["samples"],
                                      grid_resolution=cfg["grid_resolution"], grid_threshold=cfg["grid_threshold"],
                                      pool_budget_per_ray=cfg["pool_budget"], pool_start_step=cfg["pool_start_step"],
                                      **common)
            # The converged grid, frozen: refreshes of a model with random
            # weights would mark every cell occupied.
            loop.grid_state = OccupancyGridState(densities=self.grid["densities"], step=loop.grid.warmup_updates)
            loop.grid_freeze_after = 0
        else:
            self.models = dict(coarse=build_model(cfg), fine=build_model(cfg))
            loop = TrainLoop(self.models["coarse"], self.models["fine"], coarse_ts=cfg["coarse_samples"],
                             fine_ts=cfg["fine_samples"], **common)
        return loop

    def _leaves(self):
        named = {f"{m}.{n}": p for m, model in self.models.items() for n, p in model.named_parameters()}
        named["background"] = self.loop.background
        return named

    def setup(self):
        cell, cfg, device = self.cell, self.cfg, self.device
        self.data_dir = tempfile.mkdtemp(prefix="nerfbench_")
        self.views = scene.write_dataset(self.data_dir, cell.seed, cfg["views"], cfg["image_size"])
        cell.note("dataset written")
        dataset = load_dataset(self.data_dir)
        res = cfg.get("grid_resolution", 0)
        self.grid = dict(bbox_min=cfg["bbox_min"], bbox_max=cfg["bbox_max"], resolution=res,
                         threshold=cfg.get("grid_threshold", 0.0), in_warmup=False,
                         densities=torch.from_numpy(scene.shell_densities(res)).to(device) if res else None)
        self.loop = self._loop()
        cell.note("loop built")
        self.initial = {}
        weight_seed = cell.stream_seed(10)
        for i, (m, model) in enumerate(self.models.items()):
            for n, v in harness.seeded_weights(model, weight_seed + i, device).items():
                self.initial[f"{m}.{n}"] = v
        with torch.no_grad():
            self.loop.background.fill_(cfg["background_init"])
        self.initial["background"] = self.loop.background.detach().clone()
        self.base_seed = cell.stream_seed(11)
        cell.note("weights drawn")
        self.batches = prefetch_to_device(
            dataset.iterate_batches(os.path.join(self.data_dir, "shuffled"), cell.stream_seed(12), cfg["rays"]), device)
        # The first steps, one a call through the window's own call and feed.
        self.first_batches, losses = [], []
        b1 = cfg["adam_b1"]
        for step in range(cfg["checked_steps"]):
            batch = next(self.batches)
            if step == 0:
                cell.note("shuffled shards built")
            self.first_batches.append(batch.clone())
            values = self.loop.step_auto_many(self.base_seed, [batch])
            losses.append(float(sum(values[k] for k in ("coarse", "fine") if k in values)))
            if step == 0:
                state = self.loop.optimizer.state
                grads = {k: float(torch.linalg.vector_norm(state[p]["exp_avg"]) / (1 - b1)) if p in state else 0.0
                         for k, p in self._leaves().items()}
        change = {k: float(torch.linalg.vector_norm(p.detach() - self.initial[k])) for k, p in self._leaves().items()}
        self.program = dict(losses=losses, grad_norms=grads, change_norms=change)
        cell.note(f"first {len(losses)} steps done")
        for _ in range(cfg["warmup_dispatches"]):
            self.loop.step_auto_many(self.base_seed, self._chunk())

    def _chunk(self):
        chunk = list(itertools.islice(self.batches, self.cfg["steps_per_dispatch"]))
        if len(chunk) < self.cfg["steps_per_dispatch"]:
            raise RuntimeError("the data path ran out of batches")
        return chunk

    # -- the window ---------------------------------------------------------

    def _dispatch(self):
        """One dispatch: ``(the last step's values, seconds fetching the
        batches, seconds in step_auto_many, the clock after it)``."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("nerfbench.batch_wait"):
            chunk = self._chunk()
        t1 = time.perf_counter()
        with torch.profiler.record_function("nerfbench.step_auto_many"):
            values = self.loop.step_auto_many(self.base_seed, chunk)
        t2 = time.perf_counter()
        return values, t1 - t0, t2 - t1, t2

    def window(self, seconds: float, traced: bool) -> dict:
        cfg, device = self.cfg, self.device
        k, rays = cfg["steps_per_dispatch"], cfg["rays"]
        captures0 = self.loop.captures
        fetch_s = step_s = 0.0
        steps = traced_steps = 0
        kept, summary, trace_window, trace_block = [], None, 0.0, 0.0
        trace_at = time.perf_counter() + cfg["trace_after_fraction"] * seconds if traced else None
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            if trace_at is not None and time.perf_counter() >= trace_at:
                trace_at, block = None, time.perf_counter()
                with trace.Traced(device) as traced_run:
                    for _ in range(cfg["trace_dispatches"]):
                        kept.append(self._dispatch()[0])
                summary, trace_window = trace.summary(traced_run.events), traced_run.window_s
                trace_block = time.perf_counter() - block
                steps += k * cfg["trace_dispatches"]
                traced_steps += k * cfg["trace_dispatches"]
                continue
            values, fetch, step, t2 = self._dispatch()
            kept.append(values)
            fetch_s, step_s, steps = fetch_s + fetch, step_s + step, steps + k
            if t2 >= deadline:
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - start
        failed = k * sum(1 for v in kept if not all(bool(torch.isfinite(x)) for x in v.values()))
        if self.loop.captures != captures0:
            self.cell.note(f"{self.loop.captures - captures0} step graph(s) captured inside the window")
        untraced = steps - traced_steps
        self.cell.note(f"window: {steps} steps in {elapsed:.3f} s; a step waited {1e3 * fetch_s / max(untraced, 1):.3f} ms "
                       f"for its batch and spent {1e3 * step_s / max(untraced, 1):.3f} ms in step_auto_many")
        return dict(
            attempted=steps, failed=failed,
            end_to_end=dict(train_rays_per_s=steps * rays / elapsed),
            spans=dict(batch_wait_s=fetch_s, train_host_s=step_s, steps=untraced,
                       seconds=elapsed - trace_block),
            trace=summary, trace_window_s=trace_window,
        )

    def release(self):
        """Free the program's state (the loop, its graphs and the feed)."""
        self.batches.close()
        del self.loop, self.models, self.batches
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.data_dir, ignore_errors=True)

    # -- the check ------------------------------------------------------------

    def reference(self, precision: str = "float32", half_batch: bool = False) -> dict:
        return ref_train.reference_steps(self.kind, self.cfg, self.initial, self.first_batches, self.base_seed,
                                         self.grid, precision, half_batch)

    def check(self) -> dict:
        limits = self.cfg["limits"]
        rows = data.batch_mismatch([b.cpu().numpy() for b in self.first_batches], self.views)
        reference = self.reference(self.cfg["compute_dtype"])
        gaps = compare.train_gaps(self.program, reference)
        for key in ("grad_norms", "change_norms"):
            worst = compare.leaf_gaps(self.program[key], reference[key], reference[key])
            leaf = max(worst, key=worst.get)
            self.cell.note(f"worst {key[:-6]} leaf {leaf}: program {self.program[key][leaf]!r}, "
                           f"reference {reference[key][leaf]!r}")
        out = {k: dict(value=v, limit=limits[k]) for k, v in gaps.items()}
        out.update({k: dict(value=v, limit=0) for k, v in rows.items()})
        return out

    def readings(self) -> dict:
        """The numbers the check compares, for the program and for what the
        limits are set from: the control (the reference in a lower
        precision in the program's place) and the planted fault of half the
        batch left out (the reference's mean over the first half of the
        rows).  A step that returns its state unchanged reads 1 by the
        change's measure and needs no run."""
        precision = self.cfg["compute_dtype"]
        reference = self.reference(precision)
        return dict(program=compare.train_gaps(self.program, reference),
                    control=compare.train_gaps(self.reference(CONTROL[precision]), reference),
                    half_batch=compare.train_gaps(self.reference(precision, half_batch=True), reference))

    def work(self) -> dict:
        return work.train_work(self.kind, self.cfg, self.first_batches, self.grid, self.base_seed)
