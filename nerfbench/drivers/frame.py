"""Closed-loop frames for one client: the poses of a spin video's orbit in
turn, one a frame.  Each call copies the pose's rays in from the host,
renders the frame and copies the image out to the host, as
``RenderSession.render_arrays`` does; its latency runs from the copy in to
the image on the host.  The client holds its rays and its image buffer in
pinned memory, so both copies run at the link's rate: through pageable
memory they are host copies, whose speed on a shared host spread the
frames' times by 6-10 % from run to run.

The occupancy path renders through ``OccupancyFrameSession.render``
(pooled, the ``auto`` budget measured each frame), the hierarchy through
``render.render_frame``; on the card each tile is a CUDA-graph replay.
Each frame draws its tiles' uniforms from a generator the harness seeds
from the run's seed and the frame's index.  Set-up renders
``warmup_frames`` poses, so every graph key the window meets is captured
before it.  The check compares frames sampled from the seed (a reservoir
over the window's frames) with the reference's.
"""

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from learn_nerf_tpu_torch.acceleration import OccupancyGrid, OccupancyGridState
from learn_nerf_tpu_torch.frame_graph import frame_graphs
from learn_nerf_tpu_torch.occ_render import OccupancyFrameSession, OccupancyRenderer
from learn_nerf_tpu_torch.render import Renderer, render_frame

from nerfbench import harness, scene, trace, work
from nerfbench.drivers.train import CONTROL, build_model, reference_cfg
from nerfbench.reference import compare, draws
from nerfbench.reference.frames import generator_passes, reference_frame



class Frame(NamedTuple):
    """One frame of a run: its latency (s), pose, generator seed, the
    generator's state after it, its image ``[M, 3]`` on the host and, on
    the pooled path, the session's pool counters."""

    latency: float
    pose: int
    seed: int
    state: torch.Tensor
    image: object
    pool: Optional[dict]


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = reference_cfg(cell)
        self.kind = self.cfg["path"]
        self.device = cell.device

    def setup(self):
        cell, cfg, device = self.cell, self.cfg, self.device
        size = cfg["image_size"]
        self.cameras = scene.orbit(cfg["poses"])
        self.rays = scene.orbit_rays(self.cameras, size, device)
        self.image = torch.empty((size * size, 3), dtype=torch.float32, pin_memory=device.type == "cuda")
        cell.note("orbit rays made")
        self.start_pose = int(np.random.RandomState(cell.stream_seed(20)).randint(cfg["poses"]))
        bbox = dict(bbox_min=tuple(cfg["bbox_min"]), bbox_max=tuple(cfg["bbox_max"]))
        weight_seed = cell.stream_seed(21)
        names = ["fine"] if self.kind == "occupancy" else ["coarse", "fine"]
        self.models = {m: build_model(cfg).to(device) for m in names}
        self.params = {m: harness.seeded_weights(model, weight_seed + i, device)
                       for i, (m, model) in enumerate(self.models.items())}
        for model in self.models.values():
            model.eval()
        self.background = torch.rand(3, generator=torch.Generator(device=device).manual_seed(cell.stream_seed(22)),
                                     device=device) * 2.0 - 1.0
        if self.kind == "occupancy":
            res = cfg["grid_resolution"]
            grid = OccupancyGrid(resolution=res, threshold=cfg["grid_threshold"], **bbox)
            densities = torch.from_numpy(scene.shell_densities(res)).to(device)
            self.grid = dict(bbox_min=cfg["bbox_min"], bbox_max=cfg["bbox_max"], resolution=res,
                             threshold=cfg["grid_threshold"], in_warmup=False, densities=densities)
            renderer = OccupancyRenderer(model=self.models["fine"], grid=grid, candidates=cfg["candidates"],
                                         samples=cfg["samples"], **bbox)
            self.session = OccupancyFrameSession(
                renderer, self.background, OccupancyGridState(densities=densities, step=grid.warmup_updates),
                tile_size=cfg["tile"], transmittance_eps=cfg["transmittance_eps"], budget_cfg=cfg["pool_budget"])
            self.graphs = self.session.graphs
            self._render = self.session.render
        else:
            self.grid = None
            renderer = Renderer(coarse=self.models["coarse"], fine=self.models["fine"],
                                coarse_ts=cfg["coarse_samples"], fine_ts=cfg["fine_samples"], **bbox)
            self.graphs = frame_graphs(device)
            self._render = lambda rays, generator: render_frame(renderer, rays, self.background,
                                                                tile_size=cfg["tile"], generator=generator,
                                                                graphs=self.graphs)
        self.generator = torch.Generator(device=device)
        self.frames = 0
        cell.note("session built")
        for _ in range(cfg["warmup_frames"]):
            self._frame(self.frames)
            self.frames += 1

    def _frame(self, i: int) -> Frame:
        """Frame ``i`` of the run; its image is the client's buffer (copy it
        to keep it)."""
        pose = (self.start_pose + i) % self.cfg["poses"]
        frame_seed = draws.fold_seed(self.cell.stream_seed(23), 2, i)
        self.generator.manual_seed(frame_seed)
        t0 = time.perf_counter()
        with torch.profiler.record_function("nerfbench.frame"):
            rays = self.rays[pose].to(self.device)
            with torch.inference_mode():
                out = self._render(rays, self.generator)
            image = self.image.copy_(out["outputs"])
        latency = time.perf_counter() - t0
        pool = getattr(self.session, "last_pool", None) if self.kind == "occupancy" else None
        return Frame(latency, pose, frame_seed, self.generator.get_state(), image, pool)

    def window(self, seconds: float, traced: bool) -> dict:
        cfg, device = self.cfg, self.device
        captures0 = self.graphs.captures if self.graphs is not None else 0
        rng = np.random.RandomState(self.cell.stream_seed(24))
        keep = cfg["checked_frames"]
        reservoir, latencies, failed, seen = [], [], 0, 0
        summary, trace_window, traced_frames, trace_block = None, 0.0, 0, 0.0
        trace_at = time.perf_counter() + cfg["trace_after_fraction"] * seconds if traced else None
        start = time.perf_counter()
        deadline = start + seconds
        while True:
            if trace_at is not None and time.perf_counter() >= trace_at:
                trace_at, block = None, time.perf_counter()
                with trace.Traced(device) as traced_run:
                    for _ in range(cfg["trace_frames"]):
                        self._frame(self.frames)
                        self.frames += 1
                summary, trace_window, traced_frames = trace.summary(traced_run.events), traced_run.window_s, \
                    cfg["trace_frames"]
                trace_block = time.perf_counter() - block
                continue
            frame = self._frame(self.frames)
            self.frames += 1
            latencies.append(frame.latency)
            failed += int(frame.pool is not None and frame.pool["dropped"] > 0)
            # Reservoir sampling: every frame of the window is as likely to
            # be checked.
            seen += 1
            slot = len(reservoir) if len(reservoir) < keep else rng.randint(seen)
            if slot < keep:
                frame = frame._replace(image=frame.image.numpy().copy())
                if slot == len(reservoir):
                    reservoir.append(frame)
                else:
                    reservoir[slot] = frame
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - start
        if self.graphs is not None and self.graphs.captures != captures0:
            self.cell.note(f"{self.graphs.captures - captures0} frame graph(s) captured inside the window")
        self.checked = reservoir
        self.cell.note(f"window: {seen} frames, latency median {1e3 * harness.percentile(latencies, 50):.3f} ms, "
                       f"p95 {1e3 * harness.percentile(latencies, 95):.3f} ms")
        return dict(
            attempted=seen, failed=failed,
            end_to_end=dict(frames_per_s=seen / (elapsed - trace_block),
                            frame_ms_p95=harness.percentile(latencies, 95) * 1e3),
            trace=summary, trace_window_s=trace_window, trace_frames=traced_frames,
            seconds=elapsed - trace_block, frames=seen,
        )

    def release(self):
        self.session = self._render = self.graphs = None
        self.models = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _widths(self):
        cfg = self.cfg
        return [cfg["candidates"]] if self.kind == "occupancy" else [cfg["coarse_samples"], cfg["fine_samples"]]

    def _passes(self, frame) -> int:
        """How many passes over its tiles ``frame`` drew (0: none matches)."""
        tile = self.cfg["tile"]
        tiles = -(-self.rays.shape[1] // tile)
        return generator_passes(frame.seed, frame.state, tiles, tile, self._widths(), self.device)

    def reference(self, frame, precision: str) -> np.ndarray:
        rays = self.rays[frame.pose].to(self.device)
        return reference_frame(self.kind, self.cfg, self.params, rays, frame.seed, max(self._passes(frame), 1),
                               self.background, self.grid, precision).cpu().numpy()

    def check(self) -> dict:
        gaps = [compare.frame_gap(f.image, self.reference(f, self.cfg["compute_dtype"])) for f in self.checked]
        unknown = sum(1 for f in self.checked if self._passes(f) == 0)
        return dict(frame_gap=dict(value=max(gaps), limit=self.cfg["limits"]["frame_gap"]),
                    frame_draws_unmatched=dict(value=unknown, limit=0))

    def readings(self) -> dict:
        """``frame_gap`` of the program, of the control (the reference in a
        lower precision in the program's place) and of the planted fault of
        an answer altered where it is produced (the tile of pixels at the
        middle of each checked frame replaced by the background)."""
        precision, tile = self.cfg["compute_dtype"], self.cfg["tile"]
        out = dict(program=[], control=[], altered=[])
        for f in self.checked:
            reference = self.reference(f, precision)
            altered = f.image.copy()
            mid = (altered.shape[0] - tile) // 2
            altered[mid:mid + tile] = self.background.cpu().numpy()
            out["program"].append(compare.frame_gap(f.image, reference))
            out["control"].append(compare.frame_gap(self.reference(f, CONTROL[precision]), reference))
            out["altered"].append(compare.frame_gap(altered, reference))
        return {k: dict(frame_gap=max(v)) for k, v in out.items()}

    def work(self) -> dict:
        frame = self.checked[0]
        rays = self.rays[frame.pose].to(self.device)
        tiles = -(-rays.shape[0] // self.cfg["tile"])
        stream = draws.frame_uniforms(frame.seed, (max(self._passes(frame), 1) - 1) * tiles, self.cfg["tile"],
                                      self._widths(), self.device)
        budget = frame.pool["budget"] if frame.pool else None
        return dict(work.frame_work(self.kind, self.cfg, rays, stream, self.grid, budget),
                    frames=self.frames)
