#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (learn_nerf_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (nothing is caught; any failure exits
nonzero):

1. the card's name and power limit; build the CUDA kernels from
   ``learn_nerf_tpu_torch/csrc`` (one nvcc per source, in parallel; timed,
   with ptxas's resource report);
2. each kernel against its plain PyTorch version on the card at full width
   (fused_mlp on 2^20 points, fused_render on 8192 rays x 32 samples, and
   the edges of their persistent tile loops: fused_mlp at 1, 127, 128, 129
   and 2^20 - 37 points and on a hidden-40 model, fused_render at 1, 24,
   32 and 64 samples per ray with a last tile that is not full;
   table_gather's two routes at 999,424 indices: the block route at
   [4096, 2], the L2 route at pallas_gather's own shape, [2^18, 2] f32
   rows (the wrapper's pick there), and at [2^21, 2], and the cluster
   kernel (``csrc/ablations/table_gather_cluster.cu``, which the wrapper
   picks for no table) at [2^18, 2]; each exactly equal to index_select
   and its plain version, at 1, 3, 4 and 5 indices with wrapped and NaN
   rows and from offset views, and at C = 1, 3 and 4 on the tables at the
   routes' edges, with a check that a cluster kernel reading the
   neighbouring block's slice is caught, the routes and the clusters
   placed printed, each timed beside the kernel it replaced
   (``csrc/ablations/table_gather_parent.cu``, in turns A B B A),
   ``index_select`` and the card's rate for its reads (shared-memory and
   distributed shared-memory reads and the fill, or L2 sectors;
   ``csrc/ablations/probes.cu``); the corner kernel at the 16-level fine schedule on 2^20
   points; the all-level encode kernel at the fine schedule on 2^20 points
   with unit-scale tables, at the 6-level coarse schedule, in smooth mode
   and at 1, 31, 32, 33 and 2^20 - 37 points, on points along rays and on
   the runs of equal cells that rays make (32 lanes in one cell, a run
   across two warps, two rays in a warp, a part-full tile), bit for bit
   equal to the kernel in the table-gradient kernel's thread layout (a
   measured variant built from ``csrc/ablations``), with the per-level
   route it replaced timed beside it; the table-gradient kernel hashgrid_backward at the train step's
   131,072 points and at 2^20, at the coarse schedule, in smooth mode, at
   F = 1 and 4, at 1, 31, 32 and 33 points, on the same ray runs and on one
   point repeated 4096 times, relative to each level's largest gradient,
   with each level timed on its own and 16 ``index_add_`` calls and its
   earlier layout (``csrc/ablations``) beside it (both hash-grid kernels'
   main-path time is the one on points along rays, ``ms_rays``); the
   composite kernels, forward and backward, at the main path's shapes (the
   train step's 4096 x 32 and a fixed-K tile's 8192 x 32 with one bin width
   a ray, the hierarchy's 4096 x 64 and 4096 x 192 with one a sample, the
   points as extras), with five extras, and at 1, 24, 33, 63, 65 and 191
   samples (both paths of the kernels) with a part-full last block, on rays
   of optical depth 1-3, with the background's gradient bit-equal over two
   runs, every main shape bit-equal to the dense kernels of the source
   before the pool layout had kernels of its own
   (``csrc/ablations/composite_pooled_parent.cu``, built on its own), the
   train step's two calls profiled to one kernel each and no memset, and
   each shape timed); the pool layout's kernels (a warp a ray, or a group of
   2-32 rays a warp, as the wrappers pick from the pool's rows a ray) at the
   pooled step's pool (4096 rays, 16 rows a ray) and a pooled frame's tile
   (8192 rays at budget 6 and 32 on short rays, and at budget 6 with the
   rows in runs of long rays, as the served frame's tiles have them), at
   rays of 0, 1, K and 64 samples, a
   part-full tail, a pool that cuts the trailing rays, every ray one row,
   rays alternating 0 and 64 rows, a run of 31, 33, 1 rows across chunks
   and groups and 8195 rays (no multiple of a group), each case at every
   rays-a-warp, with a check that the bounds catch starts shifted by one,
   the forward and the background's gradient bit-equal over two runs, the
   step's and a budget-6 tile's two calls profiled to one kernel each and
   no memset, each main shape timed beside the pair it replaced (one warp
   a ray, from the same parent source, in turns A B B A), beside the floor of one
   launch at the same grid (an empty kernel, ``csrc/ablations/probes.cu``)
   and beside the [N, K] route before them;
   max abs error against the stated bound, both
   times, and each kernel's bound (the least time of its bytes at the HBM
   rate or of its operations at the peak rate of their type); ptxas must
   report no spills for the two MLP kernels;
   the baked lookup at the JAX README's ``--baked 384``: the serving
   scene's fine NGP field baked to 384^3 in bf16 on the card (its seconds,
   and each pack's), the kernel against its plain version at packs 1, 2, 4
   and 8 on 2^20 random points and 2^20 points along rays, on an f32
   table, on the bbox's faces and beyond, on lattice vertices, at r = 2 and
   3 and at 1, 31, 32, 33 and 2^20 - 37 points, every pack bit-equal to
   pack 1 and to the kernel it replaced (``csrc/ablations/baked_parent.cu``,
   built on its own), with a check that the bound catches a z-major corner
   order and a row offset by one, timed at each pack beside the replaced
   kernel (in turns) on random points, along rays and on a pooled frame
   tile's pool (its unused rows one repeated point) and a fixed-K frame
   tile's points, beside ``grid_sample``, and beside the card's own rate
   for the random runs of rows that its points read, over the table's bytes
   (``csrc/ablations/probes.cu``);
   the Ref-NeRF hybrid's kernels of the encoding's gradient in the points
   (hashgrid_dx) and of its backward in the cotangent and the tables, in
   smooth mode at the fine schedule along rays (the occupancy step's
   131,072 points, and the hierarchy's 262,144 x 6 and 786,432 x 16
   levels), near the bbox's faces and at the edges of their thread grids,
   with a check that the bounds catch a wrong axis of a corner weight's
   gradient, a missing smoothstep derivative and a flipped corner sign,
   at every case bit for bit equal (dx, grad_g) to the pair as first
   designed (``csrc/ablations/hashgrid_dx_parent.cu``, built on its own)
   and its table gradients within the backward's bound of that pair's,
   timed beside that pair (turns A B B A), the plain versions and eager
   autograd of the plain encode; the selection kernels
   (``check_selection_kernels``): select_strided, which reads its
   occupancy test from the grid's packed cell bits, at the train step's
   4096 rays x 192 candidates -> 32 on the scene's ball grid, an
   off-centre ball, a warmup grid (c = 192 > K), an opaque off-centre ball
   with the prune at eps 1e-2 and a 126^3 grid (padded words), at served
   tiles of 8192 rays (the ball, an opaque ball with the prune,
   frame_matrix's shell grid with it, and the span lever's range of 64
   probes as input to 96 candidates) and at the edges (1, 31 and 33 rays,
   rays that miss the box, directions with zero components, C = 1, 33,
   100, 200 and 4096, K = 1 and 64), bit for bit equal to its plain
   version, with the prune's decisions different only within PRUNE_MARGIN
   of eps (the count and the largest gap printed), and bit for bit equal
   to the kernel it replaced (``csrc/ablations/selection_parent.cu``, the
   prune included); pool_pack, one launch from the selection's counts, bit
   for bit at budgets that hold every survivor and that drop and at the
   edges of its chunks and blocks (one ray, 33 rays, counts off a 16-byte
   boundary), against its plain version from the counts, the plain pack
   of the sample mask and the replaced clamp, cumsum and pack; a rank off
   by one, x and z swapped in the cell index (which only the prune reads)
   and in a word's bit index, a tail row not written and a scan off by
   one ray (copies of the source), and the words of another grid state,
   each caught; a pooled tile's selection and pack profiled to two kernels
   and no memset; both timed by graph replay in turns A B B A beside the
   replaced pair and the plain route's device time, the selection beside
   the card's rate for its random word reads (and the replaced kernel's
   for its random grid reads);
3. a synthetic scene with a full-width vanilla checkpoint and a full-width
   Instant-NGP checkpoint (6 coarse and 16 fine hash-grid levels of 2^18
   rows) in the pickle contract (random weights from a NumPy seed, a 128^3
   occupancy grid with empty and occupied cells); the kernel route of each
   render mode (vanilla: hierarchy, occupancy; NGP: hierarchy, fixed-K
   occupancy, pooled, and baked pooled and baked fixed-K, whose CPU session
   serves the card's bake) against the plain route on the CPU on a small
   view, with the same uniforms; one full-width Instant-NGP train step's loss
   and gradients on the card (kernel route) against the plain route on the
   CPU, with no table left without its gradient, dense and pooled (at the
   batch's auto budget), and the pooled step at a budget that holds every
   survivor against the dense step on the card; the occupancy loop's
   step graph (``check_graph_step``): ``step_auto`` as CUDA-graph replays,
   dense across the grid's warmup exit and auto-pooled on the ball grid,
   96 steps each against eager ``step()`` from the graph loop's own state
   and draws (forward values and grid bit for bit, ``grad_norm`` within
   its bound), 96 free-running steps within the eager route's run-to-run
   noise, one replay a step after the first, one capture a key, a handful
   of host launches a replayed step in the profile, whose trace runs each
   of the port's kernels as often as the counters claim, the composite
   ticket back at 0, replays of a graph captured at 4096 rays bit-equal to
   eager steps after steps of 8192 rays outgrew its composite scratch
   (kept, not freed), three deliberate faults caught (words not rebuilt after a
   refresh, the batch not copied into its buffer, the logged values read
   after the next replay), and a full state saved on the CPU resumed on
   the card;
   the selection levers' frames the same way (NGP pooled with ``--occ_span_candidates 64``, and
   with ``--occ_block_gather 4 --occ_span_block_gather 4`` too, NGP
   fixed-K with ``--occ_block_gather 1``, vanilla ``--bf16 --occupancy``
   with ``--occ_block_gather 2``, baked pooled with span 64) and their
   invariants on the card, on the scene's 128^3 grid and on frame_matrix's
   shell grid over one tile of 8192 rays (``check_lever_invariants``: block
   words and span block words at stride 1 equal to the per-cell paths, at
   stride 4 only adding, and no span skipping an occupied cell by a
   brute-force check against the full-resolution grid, which must catch a
   span of one probe); frames as tile replays (``check_frame_graphs``):
   every render mode's 256x256 frame (vanilla ``--bf16`` hierarchy, fused
   occupancy and block words 2; NGP hierarchy, fixed-K and pooled; baked
   pooled and fixed-K; the north star; the live lever stack; NGP pooled
   with depth outputs; once trained, the Ref-NeRF hierarchy and the NGP
   Ref-NeRF occupancy mode) twice by replays and twice by the eager route
   from the same generator states, bit for bit (outputs, ``selected``,
   ``dropped``), one capture a key, a profiled replayed frame whose trace
   runs each of the port's kernels as often as the counters claim, in the
   replays and on their own (profiled again only where the trace shows
   the kernel records it lost), the
   grid changed in place between frames (graphs dropped, still
   bit-equal), three deliberate faults caught (a tile's rays not copied
   into the static buffer, a changed grid under kept graphs, a tile's
   outputs read after the next replay), and one 800x800 frame of
   frame_matrix's shell the same way, one of its tile replays timed by
   CUDA events beside the profiler;
4. the port's ``serve_nerf`` in a thread, vanilla with ``--bf16`` in
   hierarchy and occupancy mode, and NGP in f32 (the CLI default) in
   hierarchy, occupancy and pooled mode (``--occ_budget_per_ray auto
   --occ_t_eps 1e-2``), baked pooled (the same with ``--baked 384
   --baked_pack 4``, serve_nerf's own example) and baked fixed-K
   (``--baked 384``), and with the selection levers: the JAX package's
   north-star frame (``bench_frame``'s configuration: baked 384^3 pack 4,
   ``--occ_candidates 96 --occ_span_candidates 64``, pooled auto, eps
   1e-2, serving the bake of the baked pooled mode), the live NGP lever
   stack (pooled, span 64, block words 4 in both) and vanilla ``--bf16
   --occupancy --occ_block_gather 2``: three ``POST /render`` requests
   each at 256x256, each answered 200 with a PNG of that shape, with
   latencies, every request after the first served by the tile replays of
   the graphs the first captured (replays and captures printed);
5. every kernel of each mode launched during its serve phase (select_strided
   once a tile in every occupancy mode but the block-word ones, and once
   more a frame for an auto budget's demand, pool_pack once a pooled tile,
   the block-word modes' plain candidate test counted apart; fused_mlp,
   fused_render, the encode kernel in the three live NGP modes, the
   composite kernel in both hierarchy modes, twice a tile, and in fixed-K
   NGP, its pool layout in pooled NGP, the baked lookup once a tile in
   the baked modes, whose encode kernel ran in the bake and never while
   serving, none at all in the north-star mode, which bakes nothing; the
   pool layout in both lever modes, fused_render with block words), and no
   plain version called there or in the set-up;
6. a posed dataset of its own (views of the ball the occupancy grid
   models, coloured by position) and the port's ``train_nerf --instant_ngp
   --occupancy`` on it at full width (16 levels of 2^18 rows, 192 -> 32
   samples, a 128^3 grid, batch 4096) for 96 steps: every loss finite and
   falling, the encode, table-gradient, composite and selection kernels
   launched on every step and no plain version called, six grid refreshes,
   every step after the first a graph replay (in every occupancy run of
   ``train_nerf`` below too);
   then the
   same run pooled, the flagship ``--occ_train_budget auto`` from step 36
   with ``--steps_per_dispatch 8`` (the macro step 32-39 straddles the
   switch): the pool-layout pair and pool_pack launched on every step from
   36 on and on no other, the selection once more for each demand
   measurement, ``fine_pool_dropped`` 0 on every pooled step; both
   checkpoints scored by the port's ``eval_psnr`` on two held-out views
   (the pooled run's shortfall bounded), the dense one also baked
   (``--baked 384 --baked_pack 4``: its shortfall against the live score
   bounded, its frames' PSNR against the live frames printed), and both
   served (the pooled one with ``--occ_budget_per_ray auto``); steps/s and
   rays/s over the last 64 and 48 steps; then the Ref-NeRF hybrid, ``train_nerf
   --instant_ngp --ref_nerf --occupancy`` at the same width for 96 steps
   (the loss falls, its normal_mse printed; the encode, table-gradient,
   hashgrid_dx, its backward and composite kernels launched on every step,
   the encode and hashgrid_dx kernels once more a grid refresh, no plain
   version), scored by ``eval_psnr`` and served; the dense checkpoint
   through the render-family CLIs with the levers (``lever_phase``, its
   weights over the scene's ball grid, which the levers cull):
   ``eval_psnr`` pooled with span 64, and with block words 4 too, within
   the pooled run's bound of the plain pooled score (an ~8 dB image, the
   dense run's own score printed beside it), ``render_new_dataset``
   (two RGBD views), ``marching_cubes --resolution 128`` (its sweep by the
   encode kernel against the plain encode on the card) and
   ``render_nerf_spin`` (4 frames), each launching the encode kernel and
   no plain version;
7. the coarse/fine hierarchy through ``train_nerf`` without
   ``--occupancy`` on the same dataset, at the vanilla model's full width
   (5 + 4 layers of 256, a 128-wide colour branch, batch 4096, 64 coarse
   and 128 fine samples) in f32 (96 steps, cosine lr) and with ``--bf16``
   (16 steps), with ``--instant_ngp`` at the JAX widths (96 steps), and
   both Ref-NeRF models (``--instant_ngp --ref_nerf`` and ``--ref_nerf``, 16
   steps each, the hybrid's dx pair twice a step; the vanilla one served
   after):
   the loss falls, the composite pair, forward and backward, launched at
   4096 x 64 and 4096 x 192 on every step, in NGP the encode and
   table-gradient kernels twice a step, no plain version called; each run
   scored by ``eval_psnr`` on the held-out views; the f32 run stopped
   after step 49 (its full state saved at 48) and resumed from its full
   state: the step counter and the lr continue, and every resumed step's
   losses equal the uninterrupted run's within RESUME_BOUND; every step
   of every run after the first a graph replay.  Before the
   serve phase, one full-width step of each of these models by the kernel
   route against the plain route on the card (loss and gradients, and each
   pass's normal_mse in the Ref-NeRF models), then the hierarchy loop's
   step graph (``check_hierarchy_graph_step``): each of these models'
   ``step_auto`` with the density penalty as CUDA-graph replays, each step
   against eager ``step()`` from the graph loop's state and the same seed
   (forward values bit for bit, ``grad_norm`` within its bound), one
   capture and a replay a step after the first, the launches of both
   routes once a step, the composite ticket back at 0, a handful of host
   launches a replayed step in the profile, whose trace runs each of the
   port's kernels as often as the counters claim, each graph pool and the
   peak memory printed, and three deliberate faults caught on the NGP loop
   (the fine uniforms not redrawn into their buffer, the batch not copied,
   the logged values read after the next replay); and in phase 2 the
   hash-grid kernels at the NGP hierarchy's two passes;
8. data parallelism (``parallel_phase``): two ranks sharing the card over
   gloo (``init_distributed`` with the JAX CLI's flags, CUDA tensors), each
   training 4096 rays of every global batch at bench_occupancy's width
   (16 dense, then auto-pooled steps through ``step_auto``) against one
   process on the 8192-ray global batch with the same seeds (run twice,
   its gap to itself printed): the first step's loss bit-equal, each
   later one within DP_LOSS_BOUND, parameters and grids bit-equal across the
   ranks, one auto bucket, every rank launching the train kernels on every
   step, their step times and the gloo all-reduce's printed beside one
   process's; ``train_nerf`` as a one-rank NCCL group launched with
   torchrun's environment and ``--profile_dir`` (the group is NCCL, the
   loss falls, rank 0 writes the checkpoint, the trace names
   hashgrid_encode, the NCCL all-reduce of the gradients timed); frames
   (vanilla ``--bf16`` hierarchy and occupancy: fused_mlp and
   fused_render; NGP hierarchy and pooled) over the device list [cuda:0,
   cuda:0], and over every card when there are several, against the
   one-device frame within MESH_FRAME_BOUND; ``check_bbox`` (the rays that
   miss the bbox see the background) and ``cv_nerf`` (2 folds of 16 NGP
   hierarchy steps) on the train scene;
9. the JAX package's Blender stand-in quality gate through the port: the
   capture written here (``write_blender_capture``, the cube of the repo's
   synthetic scene from 40 train and 7 test orbit views at 64x64),
   converted by ``learn_nerf_tpu_torch.convert.blender``, trained with the
   JAX recipe (1000 steps, batch 1024, vanilla f32 occupancy) and scored
   by ``eval_psnr --occupancy`` on the test views: mean dB and SSIM, and
   the dB held to GATE_FLOOR; then, fixed-K and pooled, with span 64 and
   with block words 4 too, each shortfall against the plain route's score
   within GATE_LEVER_SHORTFALL (the levers' quality check: a ~29 dB
   checkpoint whose own grid culls).

It prints the card line and one JSON line of kernel results, then, as its
last line, ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits nonzero before printing any result.

    python3 chip_smoke.py --profile

adds, after phase 5, one JSON line per render mode and numerics mode
(vanilla hierarchy and occupancy, ``--bf16`` and f32; the three NGP modes,
the two baked modes and the two lever modes in f32) from ``learn_nerf_tpu_torch.scripts.profile_render`` on the same
scene and view size: median latency, one profiled render's device time,
idle share, top kernels and the port's own kernels' share; and one such
line for the train step from ``scripts.profile_train``, and two (the dense
and the pooled step on ``bench_pooled``'s frozen grid) from
``scripts.profile_train --pooled``, one for the Ref-NeRF hybrid's occupancy
step, and one for each hierarchy model's step (``scripts.profile_train
--hierarchy``); and, last, ``scripts/frame_matrix.py`` at 800x800 (every
lever configuration in turns, and the one-tile selection rows), its JSON
line.

    python3 chip_smoke.py --gate_seeds 0 1 2 3 4

runs phase 9 alone at each seed and prints ``{"quality_gate": {seed: [mean
PSNR, mean SSIM]}}`` (the five seeds that set GATE_FLOOR).

    python3 chip_smoke.py --dp_runs 12

runs phase 8's ranks against one process alone, twelve times, and prints
each run's fine loss gaps by step, of the ranks to one process and of one
process to itself (the runs that set DP_LOSS_BOUND).

    python3 chip_smoke.py --graph_runs 12

runs ``check_graph_step``'s free-running comparison alone, twelve times,
dense and pooled, and prints each run's fine loss and parameter gaps of the
graph route and of the eager route to the eager route (the runs that set
GRAPH_LOSS_BOUND and GRAPH_PARAM_BOUND).
"""

import argparse
import contextlib
import copy
import functools
import gc
import io
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from pathlib import Path

import numpy as np
import torch

from learn_nerf_tpu_torch.scripts.hashgrid_ablations import ray_points
from learn_nerf_tpu_torch.scripts.timing import cuda_ms, graph_ms

SEED = 0
MLP_POINTS = 1 << 20
RENDER_RAYS, RENDER_SAMPLES = 8192, 32
# Kernel vs plain version: the same bf16 rounding points, f32 sums in
# another order, so a bf16 rounding of an activation may flip and
# propagate through up to nine layers.  Each bound is about twice the
# error measured on an H100 at these inputs: 2.68e-3 (fused_mlp) and
# 2.25e-4 (fused_render, whose wide bins scale a flipped density).
MLP_BOUND = 5e-3
RENDER_BOUND = 5e-4
# The NGP MLP kernel (check_ngp_mlp_kernel) at both encoding widths, U(-1,
# 1) encodings and unit directions: around its 192-row tiles, past one
# persistent wave (132 SMs x 192 rows), a served tile's pool (8192 rays x
# 3), the NGP hierarchy's passes (4096 rays x 192, x 64).  Its f32 sums run
# in another order than cuBLAS's: the density's relative gap and rgb's
# absolute gap are held to NGP_MLP_BOUND, about twenty times the widest measured
# on an H100 (5.4e-7 for the density at 786,432 rows, 3.6e-7 for rgb).
NGP_MLP_CASES = {32: (1, 33, 191, 192, 193, 8193, 24_576, 25_345, 786_432), 12: (1, 33, 8193, 262_144)}
NGP_MLP_TIMED = (24_576, 786_432)
NGP_MLP_BOUND = 1e-5
# fused_render's bins: up to 0.25 wide, a fifth of them padding (0), which
# puts each ray's optical depth at about 1-3 under the random weights
# (density ~0.6), as on the occupancy path.  At these depths a scan that
# is off by one sample (weight exp(-acc) in place of exp(-(acc - sig_dt)))
# moves the output by more than SCAN_MARGIN times RENDER_BOUND (measured
# 4.7e-2 on an H100, ~90 times); the check measures that and fails if it
# does not.
MAX_DELTA = 0.25
SCAN_MARGIN = 20
# The edges of the MLP kernels' persistent loops over 128-row tiles.
MLP_EDGE_ROWS = (1, 127, 128, 129, MLP_POINTS - 37)
RENDER_EDGE_SAMPLES = (1, 24, 32, 64)
# Peaks of one H100 SXM (NVIDIA's data sheet; dense, at the 700 W limit):
# bf16 tensor cores, f32 outside them, HBM3.  f32 operations per sample of
# fused_render's scan and composite: the product with delta, the running
# sum, the exclusive difference, two exponentials, 1 - exp, the weight, and
# three weighted sums.
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SCAN_OPS = 10
# Kernel route on the card vs plain route on the CPU through a whole frame,
# same uniforms: as above, plus the hierarchy's fine samples follow the
# coarse weights.  Measured on an H100: 8.7e-5 (hierarchy) and 3.0e-5
# (occupancy) for the bf16 vanilla model; 3.5e-6 to 4.3e-6 for the three
# f32 NGP modes, whose kernels move and index without rounding.
FRAME_BOUND = 1e-3
SIDE = 256
REQUESTS = 3
# pallas_gather's shape (tools/exp_gather.py): one NGP level, [2^18, 2] f32,
# gathered at 122 tiles of 8192 int32 indices.  Rows are moved, not summed:
# the kernel must equal index_select exactly, and its plain version at the
# edge lengths, NaN rows included.  table_gather picks its route from the
# table's shape: a [4096, 2] table (a 16^3 dense level) takes the block
# route, pallas_gather's table and [2^21, 2] (past what a cluster of 16
# holds) the L2 route; the cluster kernel, which the wrapper gives no
# table, is held and timed at pallas_gather's.  Each is held at C = 2 and on the
# tables at the routes' edges at C = 1, 3 and 4, and timed beside the
# kernel it replaced in turns A B B A.
GATHER_ROWS, GATHER_INDICES = 1 << 18, 999_424
GATHER_EDGE_INDICES = (1, 3, 4, 5)
GATHER_SHAPES = {"block": 4096, "pallas_gather": GATHER_ROWS, "past a cluster": 1 << 21}
GATHER_PARENT, GATHER_CLUSTER, GATHER_NEIGHBOUR = "gather parent", "gather cluster 16", "gather neighbour slice"
# The NGP encoding at the fine schedule (16 levels of 2^18 rows, lattices
# 2^(4 + i//2)) on 2^20 points with unit-scale tables U(-1, 1), and at the
# edges of the encode kernel's grid of (point, level pair) threads, 8 to a
# warp's 32 lanes.  Indices and weights are bit-equal by design; the kernel
# sums the 8 weighted corners in corner order and the plain version in
# PyTorch's, so the two differ by rounding: 2.4e-7 measured on an H100, and
# the bound is about four times that.  A wrong index (the hash primes
# swapped; measured 1.97) must move the output by at least SCAN_MARGIN
# times it.
ENCODE_POINTS = 1 << 20
FINE_LEVELS, COARSE_LEVELS = 16, 6
ENCODE_BOUND = 1e-6
ENCODE_EDGE_POINTS = (1, 31, 32, 33, ENCODE_POINTS - 37)
# The table gradients at the train step's shape: 4096 rays x 32 samples on
# the fine schedule, a unit-scale cotangent.  The kernel sums with f32
# atomics in an order that changes from run to run, the plain version in
# index_add_'s: up to ~260 terms meet on a row of the coarsest level.
# Relative to each level's largest gradient the two differ by 4e-7 to 6e-7
# there and by 9e-7 to 1.1e-6 at 2^20 points, where ~2,000 terms meet
# (measured on an H100); the bound is about four times that, holds between
# two runs of the kernel too, and a wrong index (the hash primes swapped;
# measured 1.93) must break it by at least SCAN_MARGIN times.
TRAIN_RAYS, TRAIN_SAMPLES = 4096, 32
TRAIN_POINTS = TRAIN_RAYS * TRAIN_SAMPLES
BACKWARD_BOUND = 4e-6
# The NGP hierarchy's fine pass feeds 786,432 points along rays 0.01 apart
# (HIERARCHY_PASSES): 786,432 x 8 corner terms over the 17^3 rows of the
# coarsest level, ~1,300 a row on average, and an H100 measured 3.5e-6
# there (2.2e-6 in the coarse pass); the bound is about three times that.
HIERARCHY_BACKWARD_BOUND = 1e-5
BACKWARD_EDGE_POINTS = (1, 31, 32, 33)
# The encoding's gradient in the points (hashgrid_dx) and its backward in
# the cotangent and the tables, in smooth mode (the Ref-NeRF hybrid forces
# it) at the fine schedule with unit-scale tables and cotangents, along
# rays: the occupancy step's 131,072 points (`ms`) and the hierarchy's two
# passes (HIERARCHY_PASSES); near the bbox's faces (on them, where JAX's
# clip gives half the slope, within an ulp of them and past them); at the
# edges of the kernels' thread grids (DX_EDGE_POINTS, by levels: the
# forward's blocks of floor(256 / items) whole points, 32 at the 16 levels
# that hash, and of 256 points, a thread each, at the 6 dense levels of the
# coarse model; the backward's tiles of 32 points).  Every case is also
# held to the pair as first designed (DX_PARENT, csrc/ablations/
# hashgrid_dx_parent.cu): dx and grad_g bit for bit (both sum in its
# order), the table gradients within DX_BACKWARD_BOUND; both kernels are
# timed beside it in turns A B B A (`parent_ms`).  Errors relative to each
# tensor's largest value (each level's gradient on its own).  Over two
# runs an H100 measured 0.8e-7 to 1.8e-7 on
# thousands of points and 7.3e-7 on a single point (relative to its own
# largest component, where the 128 corner terms cancel) in the forward,
# which sums in the plain version's order but rounds the products apart;
# and up to 2.0e-6 in the backward, whose table gradients are f32 atomics
# (1.2e-6 and 2.0e-6 in the hierarchy's passes, 3.5e-7 between two runs of
# the kernel, 1.8e-6 from the first design's).  The bounds are two and a
# half to three times the worst.  A wrong axis of a corner weight's
# gradient, a missing smoothstep derivative and a flipped corner sign must
# move the plain version by at least SCAN_MARGIN times them (measured
# 0.53 to 1.9).
DX_BOUND = 2e-6
DX_BACKWARD_BOUND = 5e-6
DX_EDGE_POINTS = {FINE_LEVELS: (1, 31, 32, 33, 63, 64, 65, 255, 256, 257, TRAIN_POINTS - 37),
                  COARSE_LEVELS: (1, 33, 255, 256, 257)}
DX_PARENT = "dx parent"
DX_FAULTS = ("a wrong axis of the weight gradient", "no smoothstep derivative", "a flipped corner sign")
# Variants of scripts/hashgrid_ablations.py: the table-gradient kernel in the
# layout it had before the ray-ordered one, and the encode kernel in the
# ray-ordered layout (measured, not kept).
PARENT_LAYOUT, ENCODE_TILES = "parent layout", "encode tiles"
# The composite kernels against autograd through ops/volume: the scan sums
# in another order and expf differs from torch's exp in the last place.
# Measured on an H100 over the shapes below: 6e-8 to 1.5e-7 (forward,
# absolute) and 1.3e-7 to 9.2e-7 (backward, relative to each gradient's
# max; the largest on 65 samples with per-sample widths); the bounds are
# about three times that.  An off-by-one scan, forward or reverse, must
# move the result by at least SCAN_MARGIN times the bound (measured 6.7e-2
# and 1.3e-1).
COMPOSITE_BOUND = 5e-7
COMPOSITE_GRAD_BOUND = 3e-6
# (rays, samples, per-sample widths): the train step, a fixed-K frame's
# tile, the hierarchy's coarse and fine passes (tiles of 4096).
COMPOSITE_SHAPES = ((4096, 32, False), (8192, 32, False), (4096, 64, True), (4096, 192, True))
COMPOSITE_EDGE_SAMPLES = (1, 24, 33, 63, 65, 191)
# The pool layout of the same kernels (the pooled passes) against its plain
# version (the pool gathered back to [N, K] slots, then the dense plain
# version): measured on an H100 over the cases below 6.0e-8 to 1.2e-7
# (forward) and 1.4e-7 to 3.3e-7 (backward, relative); the bounds are
# about three times that.  Starts shifted by one row must move the result
# by at least SCAN_MARGIN times the bound (measured 0.27 and 1.2).
POOLED_BOUND = 4e-7
POOLED_GRAD_BOUND = 1e-6
# (rays, K, pool rows per ray, mean survivors per ray, width of the run of
# rays that own rows in each image row of 256 or None) of the pooled train
# step on bench_pooled's grid (5 % of 192 candidates survive, budget 16), of
# a pooled frame's tile at budget 6 (chip_smoke's served frames) and 32 on
# short rays, and of a budget-6 tile as a served frame fills it: a run of
# 36 rays a row crossing the ball own ~31 rows each, the rest none
# (measured on the served view: 1,153-1,170 of 8,192 rays, 30.4-30.9 rows).
POOLED_SHAPES = {
    "step 4096 x 16 of 32": (4096, 32, 16, 9.6, None),
    "tile 8192 x 6 of 32": (8192, 32, 6, 4.6, None),
    "tile 8192 x 32 of 32": (8192, 32, 32, 23.0, None),
    "tile 8192 x 6 of 32, runs": (8192, 32, 6, 34.0, 36),
}
# The selection kernels (csrc/selection.cu) against their plain versions on
# the card, bit for bit with the prune off: the train step's 4096 rays x 192
# candidates -> 32 on the scene's ball grid (density 5 in a ball of radius
# 0.45), on an off-centre ball (which a word's bit index with x and z
# swapped misses) and on a warmup grid (c = 192 > K), and served tiles of
# 8192 rays; the edges below, and a 126^3 grid, whose words are padded (the
# block dims do not divide 126).  With the prune on (eps 1e-2, the served
# frames' --occ_t_eps; on both balls at density 50, which it cuts), the
# kernel's prefix sum adds in another order than torch.cumsum: a ray may
# differ only where one of its candidates has exp(-acc_prev) within
# PRUNE_MARGIN (relative) of eps, set at four times the f32 scan's own
# rounding of acc_prev where exp(-acc_prev) is near eps (its gap to an f64
# scan, which is the relative error it puts on exp(-acc_prev)): 9.5e-7
# measured on an H100 on these inputs.
# The pack at the step's pool (budget 32 a ray, and 4 a ray, which drops)
# and a served tile's (8192 x 6), and at the edges of its blocks and chunks,
# bit for bit.
SELECT_RAYS, SELECT_CANDIDATES, SELECT_SAMPLES = 4096, 192, 32
SELECT_EDGES = ((1, 192, 32), (31, 192, 32), (33, 192, 32), (33, 100, 32), (64, 33, 1), (64, 1, 1),
                (64, 200, 64), (256, 4096, 64))
PRUNE_EPS = 1e-2
# The block-word lever's candidate test stays plain ops by decision (block
# words do not pay on the card, PERF.md §7): its calls count under this name
# and are no fault.
BLOCK_WORD_SELECTION = "block-word selection (plain by decision)"
PRUNE_MARGIN = 4e-6
PACK_BUDGETS = {"step pool, budget 32 a ray": (SELECT_RAYS, 32), "step pool, budget 4 a ray (drops)": (SELECT_RAYS, 4),
                "tile 8192 x 6": (8192, 6)}
# (rays, first ray, budget a ray): one ray; a part-full chunk; counts that
# start off a 16-byte boundary (the kernel's scalar head); a part-full last
# chunk of the last block at a tile that drops.
PACK_EDGES = ((1, 0, 32), (33, 0, 3), (4093, 3, 8), (8189, 1, 1))
# Deliberate faults in copies of csrc/selection.cu, each of which the checks
# above must catch (the cell index only the prune reads, on the opaque
# off-centre ball); and the words of another grid state, handed to the
# kernel as the state's (STALE_WORDS).
SELECTION_FAULTS = {
    "a rank off by one": ("const int target = min(rank + 1, count);", "const int target = min(rank + 2, count);"),
    "x and z swapped in the cell index": ("return cell[0] + r * (cell[1] + r * cell[2]);",
                                          "return cell[2] + r * (cell[1] + r * cell[0]);"),
    "x and z swapped in a word's bit index": ("return (cell[0] & 3) + 4 * (cell[1] & 3) + 16 * (cell[2] & 1);",
                                              "return (cell[2] & 3) + 4 * (cell[1] & 3) + 16 * (cell[0] & 1);"),
    "a tail row not written": ("long long i = total + static_cast<long long>(blockIdx.x)",
                               "long long i = total + 1 + static_cast<long long>(blockIdx.x)"),
    "a scan off by one ray": ("if (i < first) before += kept;", "if (i < first - 1) before += kept;"),
}
STALE_WORDS = "the words of another grid state"
# One train step by the kernel route on the card: (loss relative, table
# gradients by L2 norm relative, other gradients relative to their max)
# against the plain route on the card and on the CPU (check_train_step).
STEP_BOUNDS_SAME_CARD = (1e-6, 1e-6, 1e-6)
STEP_BOUNDS_CPU = (1e-5, 1e-2, 5e-4)
# The pooled step at a budget that holds every survivor against the dense
# step on the card: the same samples and arithmetic, the field model on the
# pool's rows in place of N x K (relative loss).
POOLED_DENSE_BOUND = 1e-5
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_VIEWS, TRAIN_SIDE = 96, 2, 8, 96
# The pooled run switches at step 36 (inside its macro step 32-39), and
# eval_psnr scores both runs on held-out views of the ball.  Three runs on
# an H100 measured the pooled run's shortfall at -0.016, -0.005 and +0.002
# dB (the two runs' atomics sum in different orders, and training carries
# the difference on); the bound is about three times the largest.
POOL_START, HELDOUT_VIEWS = 36, 2
POOLED_PSNR_SHORTFALL = 0.05
# The hierarchy's train phase: train_nerf without --occupancy at the
# vanilla model's full width (5 + 4 layers of 256, a 128-wide colour
# branch) and the JAX widths of --instant_ngp (6 coarse and 16 fine levels
# of 2^18 rows, F = 2), batch 4096, 64 coarse and 128 fine samples (192 in
# the fine pass), on the ball: (flags, steps) of each run.  The f32 run
# decays its lr (cosine), so the resume check holds the lr on.
COARSE_SAMPLES, FINE_SAMPLES = 64, 128
HIERARCHY_FLAGS = ["--seed", str(SEED), "--batch_size", str(TRAIN_RAYS), "--coarse_samples",
                   str(COARSE_SAMPLES), "--fine_samples", str(FINE_SAMPLES)]
HIERARCHY_RUNS = {
    "hierarchy f32": (["--lr", "5e-4", "--lr_schedule", "cosine"], 96),
    "hierarchy ngp": (["--instant_ngp", "--lr", "1e-2"], 96),
    "hierarchy bf16": (["--bf16", "--lr", "5e-4"], 16),
    "hierarchy ref-nerf ngp": (["--instant_ngp", "--ref_nerf", "--lr", "1e-2"], 16),
    "hierarchy ref-nerf": (["--ref_nerf", "--lr", "5e-4"], 16),
}
REF_NERF_RUNS = ("hierarchy ref-nerf ngp", "hierarchy ref-nerf")
# One step by the kernel route against the plain route on the card (the
# composite pair, and in NGP the hash-grid kernels, against their plain
# versions): the loss, relative, and the gradients by the measures each
# model's rounding allows: every gradient but the tables' relative to its
# tensor's max; table gradients by L2 norm, relative; in bf16 all
# gradients together by L2 norm (a scalar bias's gradient is a cancelling
# sum whose bf16 rounding alone moves it by tens of percents).  The fine
# pass samples where the coarse weights put it, and the two routes' coarse
# weights differ in the last place, so some of the 786,432 fine points
# land across a cell face of a fine lattice and move the rows they alone
# touch.  An H100 measured 1.3e-3 on the NGP tables by L2 (4.5e-7 over all
# gradients together), 3.1e-5 / 3.7e-5 on the f32 / NGP MLP gradients by
# max, and 1.0e-4 over all bf16 gradients together (4.0e-3 on its worst
# tensor by max); the losses within 1.1e-7.  The bounds are about three
# times that.
# The Ref-NeRF models are held by all gradients together by L2 norm and by
# each pass's normal_mse term, relative: an H100 measured 6.9e-6 and 4.5e-6
# by L2 (the hybrid and the vanilla model; the hybrid's worst table 4.5e-3
# on its own, as in NGP), and the normal_mse terms within 1.1e-6 and
# 4.4e-7, a few ulps of a mean over 786,432 samples.  The bounds are about
# three times the L2 errors, and 5e-6 for normal_mse.
HIERARCHY_LOSS_BOUND = 1e-5
HIERARCHY_GRAD_BOUNDS = {"hierarchy f32": {"others max": 1e-4},
                         "hierarchy ngp": {"tables L2": 4e-3, "others max": 1e-4},
                         "hierarchy bf16": {"all L2": 3e-4},
                         "hierarchy ref-nerf ngp": {"all L2": 2e-5, "normal_mse": 5e-6},
                         "hierarchy ref-nerf": {"all L2": 1.5e-5, "normal_mse": 5e-6}}
# The f32 run stopped after step RESUME_AT + 1 with its full state saved at
# RESUME_AT, then resumed from it: every resumed step's coarse and fine
# losses against the uninterrupted run's (absolute).
RESUME_AT, RESUME_BOUND = 48, 1e-5
# The NGP hierarchy step's two passes as the hash-grid kernels see them:
# (label, levels, samples a ray, spacing of the samples along a ray).
HIERARCHY_PASSES = (("coarse 4096 x 64, 6 levels", COARSE_LEVELS, COARSE_SAMPLES, 0.03),
                    ("fine 4096 x 192, 16 levels", FINE_LEVELS, COARSE_SAMPLES + FINE_SAMPLES, 0.01))
# The JAX package's Blender stand-in gate (tools/bench_queue/queues.py:239-262,
# BASELINE.md): a 64x64 capture of the cube, 40 train orbit views and 7 test
# views at distance 2.3, through the Blender converter, 1000 steps of
# vanilla f32 occupancy training, eval_psnr --occupancy on the test views.
# The JAX package scored 27.62 dB there (CPU).  The port at seeds 0-4 on an
# H100 (chip_smoke.py --gate_seeds 0 1 2 3 4): 29.341, 27.800, 27.972,
# 28.355 and 28.900 dB (SSIM 0.9461-0.9535); the floor is the larger of
# 27.62 - 1.0 and the lowest of the five less 0.3 dB.
BLENDER_SIDE, BLENDER_TRAIN_VIEWS, BLENDER_TEST_VIEWS, BLENDER_FOV = 64, 40, 7, 0.9
GATE_RAYS, GATE_STEPS = 1024, 1000
GATE_FLAGS = ["--batch_size", str(GATE_RAYS), "--lr", "2e-3", "--occupancy", "--occ_candidates", "64",
              "--occ_samples", "24", "--occ_grid", "64"]
JAX_GATE_PSNR = 27.62
GATE_FLOOR = max(JAX_GATE_PSNR - 1.0, 27.800 - 0.3)
# Mean density of the NGP checkpoint's fine field inside the ball (set
# through the density head's bias): rays crossing the occupied ball reach
# optical depth ~1-3.
NGP_DENSITY = 2.5
# The JAX README's baked serving (--baked 384, bf16) of the serving scene's
# fine NGP field, the kernel at 2^20 points, and serve_nerf's own example
# (pack 4) as the main path's pack.  The kernel sums the 8 weighted
# corners in corner order, the plain version in PyTorch's: measured up to
# 3.6e-7 on an H100 over the cases of check_baked_kernel (the features are
# O(1)); the bound is about three times that.  A z-major corner order and a row offset by one must
# move the output by at least SCAN_MARGIN times it.
BAKE_RESOLUTION, BAKED_PACK = 384, 4
BAKED_POINTS = 1 << 20
BAKED_EDGE_POINTS = (1, 31, 32, 33, BAKED_POINTS - 37)
BAKED_BOUND = 1e-6
# eval_psnr on the dense trained checkpoint baked (--baked 384
# --baked_pack 4) against live, on the same held-out views: three runs on
# an H100 measured the baked shortfall at -0.002, -0.001 and -0.002 dB
# (the baked field scored higher) and the baked frames at 46.1-46.6 dB
# against the live frames; the bound is about five times the largest
# shortfall, and a wrong table layout would bring the frames far below
# the floor.
BAKED_PSNR_SHORTFALL = 0.01
BAKED_FRAME_PSNR = 40.0
VANILLA_MODES = {"hierarchy": [], "occupancy": ["--occupancy"]}
NGP_MODES = {
    "ngp hierarchy": ["--instant_ngp"],
    "ngp occupancy": ["--instant_ngp", "--occupancy"],
    "ngp pooled": ["--instant_ngp", "--occupancy", "--occ_budget_per_ray", "auto",
                   "--occ_t_eps", "1e-2"],
}
BAKED_EVAL_FLAGS = ["--baked", str(BAKE_RESOLUTION), "--baked_pack", str(BAKED_PACK)]
BAKED_MODES = {
    "ngp baked pooled": [*NGP_MODES["ngp pooled"], "--baked", str(BAKE_RESOLUTION), "--baked_pack",
                         str(BAKED_PACK)],
    "ngp baked occupancy": [*NGP_MODES["ngp occupancy"], "--baked", str(BAKE_RESOLUTION)],
}
# The occupancy renderer's selection levers (two-phase span selection, block
# words), each frame path they change held to its plain route as the modes
# above are (phase 3), and served (phase 4): bench_frame's configuration,
# the JAX package's north-star frame (baked 384^3 bf16 at pack 4, 96
# candidates, span 64, pooled auto, eps 1e-2), serving the bake that "ngp
# baked pooled" made, and the live lever stack.
SPAN_FLAGS = ["--occ_span_candidates", "64"]
BLOCK_FLAGS = ["--occ_block_gather", "4", "--occ_span_block_gather", "4"]
LEVER_FRAME_MODES = {
    "ngp pooled span": [*NGP_MODES["ngp pooled"], *SPAN_FLAGS],
    "ngp pooled span block words": [*NGP_MODES["ngp pooled"], *SPAN_FLAGS, *BLOCK_FLAGS],
    "ngp occupancy block words 1": [*NGP_MODES["ngp occupancy"], "--occ_block_gather", "1"],
    "ngp baked pooled span": [*BAKED_MODES["ngp baked pooled"], *SPAN_FLAGS],
}
VANILLA_LEVER_MODES = {"occupancy block words": ["--occupancy", "--occ_block_gather", "2"]}
NORTH_STAR = "ngp baked north-star"
LEVER_SERVE_MODES = {
    NORTH_STAR: ["--instant_ngp", "--occupancy", "--baked", str(BAKE_RESOLUTION), "--baked_pack", str(BAKED_PACK),
                 "--occ_candidates", "96", *SPAN_FLAGS, "--occ_budget_per_ray", "auto", "--occ_t_eps", "1e-2"],
    "ngp live levers": [*NGP_MODES["ngp pooled"], *SPAN_FLAGS, *BLOCK_FLAGS],
}
# The lever invariants (check_lever_invariants) over one tile of rays: the
# span's brute-force check samples each ray at LEVER_CHECK_SAMPLES points of
# its bbox range against the full-resolution grid, and must catch a span of
# UNDERSIZED_PROBES probes (under the minimum, which the renderer refuses).
# The one-bin pad and the supergrid's dilation leave a wide margin: a few
# probes still cover the shell's crossings, one probe (the range's
# midpoint, inside the shell) does not.
LEVER_TILE = 8192
LEVER_CHECK_SAMPLES = 2048
UNDERSIZED_PROBES = 1
# eval_psnr with the levers against the plain route's score in the same
# mode, each shortfall at most the pooled run's bound.  The dense NGP
# checkpoint's 96 steps leave its own grid all occupied, so lever_phase
# runs its weights over the ball's grid: an ~8 dB image, a weak check.
# quality_gate holds the levers on its ~29 dB checkpoint, whose own grid
# culls ~40 % of its cells (its 8^3 supergrid stays full, so the span
# selects as the plain route there), fixed-K and pooled.  Block words add
# the samples of the cells they overcount, which moved the gate's score
# by -0.161 to +0.151 dB at seeds 0-4 on an H100 (and the JAX package's
# by +0.09 dB on one CPU checkpoint of the gate's recipe): there their
# shortfall is held to about twice the largest seen.
LEVER_RUNS = {"span 64": SPAN_FLAGS, "span 64, block words 4": [*SPAN_FLAGS, *BLOCK_FLAGS]}
LEVER_PSNR_SHORTFALL = POOLED_PSNR_SHORTFALL
GATE_LEVER_SHORTFALL = {"span 64": LEVER_PSNR_SHORTFALL, "span 64, block words 4": 0.3}
GATE_LEVER_MODES = {"fixed-K": ("--occupancy",), "pooled": ("--occupancy", "--occ_budget_per_ray", "auto")}
# marching_cubes on the trained checkpoint: the sweep's occupancy volume by
# the encode kernel against the plain encode on the card.
MESH_RESOLUTION = 128
MESH_BOUND = 1e-5
# The data-parallel phase (parallel_phase).  (a) DP_RANKS ranks share the
# one card over gloo (NCCL refuses two ranks on one card), each training
# TRAIN_RAYS rays of every global batch at bench_occupancy's width, DP_STEPS
# steps through step_auto, dense and then pooled (auto) from
# DP_POOL_START on, against one process on the global batch with the same
# seeds.  The ranks' steps and the one process's differ where
# hashgrid_backward's atomics and the all-reduce sum in other orders, and
# Adam (eps 1e-15) carries that on.  Before the first backward no sum
# changes order: the first step's loss is bit-equal.  Each later step's
# loss, relative, lies within DP_LOSS_BOUND: one process run twice differs
# as much as the ranks do (``--dp_runs 12`` on an H100: ranks to one process
# up to 1.22e-6, one process to itself up to 1.34e-6, both at the last
# step; the bound is about four times the larger).  (b) train_nerf as a one-rank NCCL group, launched with
# torchrun's environment, with --profile_dir.  (c) frames over the device
# list [cuda:0, cuda:0] (and over every card when there are several)
# against the one-device frame, within MESH_FRAME_BOUND.  (d) check_bbox
# and cv_nerf (CV_FOLDS folds of CV_STEPS steps) on the train scene.
DP_RANKS, DP_STEPS, DP_POOL_START, DP_SEED = 2, 16, 8, SEED + 19
DP_LOSS_BOUND = 5e-6
MESH_FRAME_BOUND = 1e-5
MESH_FRAME_MODES = {"vanilla hierarchy --bf16": ([], True), "vanilla occupancy --bf16": (["--occupancy"], True),
                    "ngp hierarchy": (NGP_MODES["ngp hierarchy"], False),
                    "ngp pooled": (NGP_MODES["ngp pooled"], False)}
CV_FOLDS, CV_STEPS = 2, 16
# The step graph (check_graph_step): OccupancyTrainLoop.step_auto as
# CUDA-graph replays against eager step() fed the same draws, at
# bench_occupancy's width on the train scene with the density penalty,
# GRAPH_STEPS steps dense (from the loop's own grid, across its warmup exit)
# and auto-pooled from step 0 (on the scene's ball grid, past warmup, whose
# refreshes change its words), each route from train_nerf's loop with one
# seed.  Each step against an eager step from the graph loop's own state:
# the forward values (the losses, param_norm, the pool's drops) and the
# grid are bit-equal, as no sum changes order before the backward;
# grad_norm, after hashgrid_backward's atomics, within
# GRAPH_GRAD_NORM_BOUND (an H100 measured it bit-equal on every step of
# six runs).  This catches each deliberate fault (GRAPH_FAULTS, on the
# pooled run's first GRAPH_FAULT_STEPS steps, two refreshes).
# Free-running, the atomics add in another order on each route, and Adam
# at eps 1e-15 turns a near-zero gradient of either sign into a whole step,
# so two eager runs part as far as the graph route and an eager one do
# (``--graph_runs 12`` on an H100, 96 steps, largest of the twelve, dense:
# fine loss 3.67e-2 graph to eager, 2.57e-2 eager to itself; parameters'
# relative L2 distance 3.21e-2 and 2.94e-2; pooled 3.6e-5 / 2.3e-5 and
# 3.1e-3 / 3.0e-3): the loss and parameter bounds are about four times the
# dense ones.  A replayed step makes at most GRAPH_HOST_LAUNCHES launches on
# the host (an H100 profiled 13 dense and 14 pooled: the draws, the batch's
# copy, the replay, the logged values' clones, then Adam's foreach
# launches, eager after the replay).
GRAPH_STEPS, GRAPH_FAULT_STEPS, GRAPH_SEED = 96, 24, SEED + 21
GRAPH_LOSS_BOUND, GRAPH_PARAM_BOUND, GRAPH_GRAD_NORM_BOUND = 0.15, 0.13, 1e-5
GRAPH_HOST_LAUNCHES = 16
# A wrapper's launch counter by the name its CUDA kernel carries
# (profile_render.PORT_KERNELS), where the two differ.
COUNTER_KERNELS = {"composite": "composite_forward", "composite_pooled": "composite_pooled_forward"}
GRAPH_FAULTS = ("words not rebuilt after a refresh", "the batch not copied into its buffer",
                "the logged values read after the next replay")
# The hierarchy's hot route (check_hierarchy_graph_step): each
# HIERARCHY_RUNS model at full width with the density penalty on,
# HIERARCHY_GRAPH_STEPS[name] steps of train_nerf's loop, each against an
# eager step() from the graph loop's state with the draws of the same seed
# (drawn inside the loss, as before the hot route split the step): the
# forward values bit-equal and grad_norm within GRAPH_GRAD_NORM_BOUND, as
# in check_graph_step.  A step's launches on either route, with the
# penalty's two model calls: the composite pair twice; in NGP the encode
# and table-gradient kernels four times; in the hybrid the dx kernel four
# times, its backward twice (the penalty reads no normal).  The eager
# steps run after the graph loop is gone: the vanilla Ref-NeRF's graph pool
# (42.3 GB) and an eager step beside it (37.9 GB at its peak) ran the card
# out of memory in a full run.  The three
# faults run on the NGP loop, HIERARCHY_GRAPH_FAULT_STEPS steps each.  A
# replayed step makes at most HIERARCHY_HOST_LAUNCHES launches on the host
# (an H100 profiled 14 in NGP and the vanilla Ref-NeRF, 16 in vanilla f32
# and bf16: the four draws, the batch's copy, the replay, the values'
# clone, then Adam's foreach launches, more of them for more tensors).
HIERARCHY_GRAPH_STEPS = {"hierarchy f32": 8, "hierarchy ngp": 32, "hierarchy bf16": 8, "hierarchy ref-nerf ngp": 16,
                         "hierarchy ref-nerf": 8}
HIERARCHY_GRAPH_FAULT_STEPS, HIERARCHY_PENALTY = 4, "1e-3"
HIERARCHY_HOST_LAUNCHES = 20
HIERARCHY_GRAPH_FAULTS = ("the fine uniforms not redrawn into their buffer", GRAPH_FAULTS[1], GRAPH_FAULTS[2])
# Frames as tile replays (check_frame_graphs): each mode's SIDE x SIDE frame
# rendered FRAME_GRAPH_FRAMES times by replays (the first captures) and again
# by the eager route from the same generator states, bit for bit; then one
# 800x800 frame of frame_matrix's shell (its no-lever row) the same way.
# The Ref-NeRF models' frames are held the same way once they are trained.
# name -> (render flags, --bf16, include_depth_outputs).
FRAME_GRAPH_FRAMES = 2
FRAME_GRAPH_MODES = {
    "hierarchy --bf16": (VANILLA_MODES["hierarchy"], True, False),
    "occupancy --bf16 (fused)": (VANILLA_MODES["occupancy"], True, False),
    "occupancy --bf16 block words 2": (VANILLA_LEVER_MODES["occupancy block words"], True, False),
    "ngp hierarchy": (NGP_MODES["ngp hierarchy"], False, False),
    "ngp occupancy (fixed-K)": (NGP_MODES["ngp occupancy"], False, False),
    "ngp pooled": (NGP_MODES["ngp pooled"], False, False),
    "ngp baked pooled": (BAKED_MODES["ngp baked pooled"], False, False),
    "ngp baked occupancy": (BAKED_MODES["ngp baked occupancy"], False, False),
    NORTH_STAR: (LEVER_SERVE_MODES[NORTH_STAR], False, False),
    "ngp live levers": (LEVER_SERVE_MODES["ngp live levers"], False, False),
    "ngp pooled, depth outputs": (NGP_MODES["ngp pooled"], False, True),
}
FRAME_GRAPH_FAULTS = ("the tile's rays not copied into the static buffer", "a changed grid kept its graphs",
                      "a tile's outputs read after the next replay")


def require(ok, message):
    if not ok:
        raise RuntimeError(message)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, flops=0.0, f32_ops=0.0):
    """(bound_ms, bound_by): the larger of the bytes' time at the HBM rate
    (each input read once, each output written once) and the operations'
    time at the peak rate of their type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (flops / BF16_FLOPS + f32_ops / F32_FLOPS) * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def pack_bytes(rays, sel, budget, out):
    """The bytes pool_pack must move on this data: the counts, the ts of
    the survivors it places (not the rest of ``ts``), the rows of the rays
    it writes slots for (the last ray's too where a tail is left), and
    every output."""
    kept = torch.clamp(sel.count.long(), max=sel.ts.shape[1])
    before = torch.cumsum(kept, dim=0) - kept
    placed = torch.minimum(kept, torch.clamp(budget - before, min=0))
    read = placed > 0
    read[-1] |= bool(kept.sum() < budget)
    ray_bytes = rays[0].numel() * rays.element_size()
    return (nbytes(sel.count) + int(placed.sum()) * sel.ts.element_size() + int(read.sum()) * ray_bytes
            + nbytes(*out))


def ptxas_report(log):
    """``{kernel: (registers, spill bytes)}`` from ptxas's ``-v`` lines."""
    report, name, spills = {}, None, 0
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) and name:
            spills = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            report[name] = (int(m.group(1)), spills)
            name = None
    return report


def flax_tree(rng, hidden=256, color=128, x_dim=60, d_dim=24):
    """Full-width vanilla ``Dense_i`` tree: lecun-normal kernels, small biases."""
    shapes = [(x_dim, hidden)] + [(hidden, hidden)] * 4
    shapes += [(hidden + x_dim, hidden)] + [(hidden, hidden)] * 3
    shapes += [(hidden, 1), (hidden + d_dim, color), (color, 3)]
    return {
        f"Dense_{i}": dict(
            kernel=(rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
            bias=(0.1 * rng.randn(s[1])).astype(np.float32),
        )
        for i, s in enumerate(shapes)
    }


def check_kernels(device, rng):
    from learn_nerf_tpu_torch.checkpoint import params_from_flax
    from learn_nerf_tpu_torch.kernels import fused_mlp as fm
    from learn_nerf_tpu_torch.kernels import fused_render as fr
    from learn_nerf_tpu_torch.models import NeRFModel

    model = NeRFModel(compute_dtype="bfloat16")
    model.load_state_dict(params_from_flax(flax_tree(rng)))
    model = model.to(device)
    packed = model.packed()
    # Multiply-adds per sample: every Dense layer's [in, out] (591,488).
    macs = sum(layer.weight.numel() for layer in model.dense_layers())

    uniform, unit, deltas_for = samplers(rng, device)
    weights = nbytes(packed.kernel_weights, packed.kernel_biases)
    results = []
    x, d = uniform(MLP_POINTS, 3, lo=-0.7, hi=0.7), unit(MLP_POINTS)
    out = fm.fused_mlp_cuda(packed, x, d)
    torch.cuda.synchronize()
    ref = fm.fused_mlp_reference(packed, x, d)
    require(torch.isfinite(out).all().item() and out.shape == (MLP_POINTS, 4),
            "fused_mlp produced non-finite values or the wrong shape")
    results.append(dict(
        name="fused_mlp", route="cuda", source="learn_nerf_tpu_torch/csrc/fused_nerf.cu",
        replaces="tools/pallas_recipe/fused_mlp.py:205",
        max_abs_err=(out - ref).abs().max().item(),
        ms=cuda_ms(lambda: fm.fused_mlp_cuda(packed, x, d), 20),
        plain_ms=cuda_ms(lambda: fm.fused_mlp_reference(packed, x, d), 5),
        flops=2.0 * macs * MLP_POINTS, nbytes=nbytes(x, d, out) + weights,
    ))
    del out, ref

    n, k = RENDER_RAYS, RENDER_SAMPLES
    points, dirs, deltas = uniform(n, k, 3, lo=-0.7, hi=0.7), unit(n), deltas_for(n, k)
    out = fr.fused_render_cuda(packed, points, dirs, deltas)
    torch.cuda.synchronize()
    ref = fr.fused_render_reference(packed, points, dirs, deltas)
    require(torch.isfinite(out).all().item() and out.shape == (n, 4),
            "fused_render produced non-finite values or the wrong shape")
    depth, shifted_err = shifted_scan(packed, points, dirs, deltas, ref)
    print(f"fused_render inputs: optical depth per ray median {depth.median().item():.3f}, "
          f"min {depth.min().item():.3f}, max {depth.max().item():.3f}; an off-by-one scan "
          f"moves the output by {shifted_err:.3e}", flush=True)
    require(shifted_err >= SCAN_MARGIN * RENDER_BOUND,
            f"fused_render's bound {RENDER_BOUND:g} would not catch an off-by-one scan")
    results.append(dict(
        name="fused_render", route="cuda", source="learn_nerf_tpu_torch/csrc/fused_nerf.cu",
        replaces="tools/pallas_recipe/fused_render.py:178",
        max_abs_err=(out - ref).abs().max().item(),
        ms=cuda_ms(lambda: fr.fused_render_cuda(packed, points, dirs, deltas), 20),
        plain_ms=cuda_ms(lambda: fr.fused_render_reference(packed, points, dirs, deltas), 5),
        flops=2.0 * macs * n * k, f32_ops=SCAN_OPS * n * k,
        nbytes=nbytes(points, dirs, deltas, out) + weights,
    ))
    for r in results:
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), r["flops"], r.pop("f32_ops", 0.0))
        r["library_ms"] = None  # no one PyTorch call computes the fused chain
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        r["tflops"] = r.pop("flops") / r["ms"] / 1e9
    for r, limit in zip(results, (MLP_BOUND, RENDER_BOUND)):
        print(
            f"{r['name']}: max abs err {r['max_abs_err']:.3e} (bound {limit:g}); "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {100 * r['share_of_bound']:.1f} % of it, {r['tflops']:.1f} TFLOP/s",
            flush=True,
        )
        require(r["max_abs_err"] <= limit, f"{r['name']} disagrees with its plain version")
    # The edge cases draw from their own seed: the later phases see the same
    # weights and uniforms whether or not they run.
    check_edges(device, np.random.RandomState(SEED + 4), packed)
    return results


def samplers(rng, device):
    """Inputs on the card from ``rng``: uniform values, unit directions, and
    bin widths up to MAX_DELTA with a fifth of them padding (0)."""

    def uniform(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(device)

    def unit(n):
        d = torch.from_numpy(rng.randn(n, 3).astype(np.float32)).to(device)
        return d / d.norm(dim=-1, keepdim=True)

    def deltas_for(n, k):
        return uniform(n, k, lo=0.0, hi=MAX_DELTA) * (uniform(n, k, lo=0.0, hi=1.0) < 0.8)

    return uniform, unit, deltas_for


def check_edges(device, rng, packed):
    """The MLP kernels where their persistent loops over 128-row tiles
    break: fused_mlp around one tile, just short of 2^20 points and on a
    hidden-40 model (padded to the kernel's widths); fused_render at each K
    with one ray in its last tile."""
    from learn_nerf_tpu_torch.checkpoint import params_from_flax
    from learn_nerf_tpu_torch.kernels import fused_mlp as fm
    from learn_nerf_tpu_torch.kernels import fused_render as fr
    from learn_nerf_tpu_torch.models import NeRFModel

    uniform, unit, deltas_for = samplers(rng, device)
    narrow = NeRFModel(hidden_dim=40, color_layer_dim=20, compute_dtype="bfloat16")
    narrow.load_state_dict(params_from_flax(flax_tree(rng, hidden=40, color=20)))
    cases = [(packed, m) for m in MLP_EDGE_ROWS] + [(narrow.to(device).packed(), 4099)]
    mlp_errs = []
    for p, m in cases:
        x, d = uniform(m, 3, lo=-0.7, hi=0.7), unit(m)
        out = fm.fused_mlp_cuda(p, x, d)
        torch.cuda.synchronize()
        require(out.shape == (m, 4) and torch.isfinite(out).all().item(),
                f"fused_mlp at {m} points: wrong shape or non-finite values")
        mlp_errs.append((out - fm.fused_mlp_reference(p, x, d)).abs().max().item())
    render_errs = []
    for k in RENDER_EDGE_SAMPLES:
        n = 128 // k * 50 + 1
        points, dirs, deltas = uniform(n, k, 3, lo=-0.7, hi=0.7), unit(n), deltas_for(n, k)
        out = fr.fused_render_cuda(packed, points, dirs, deltas)
        torch.cuda.synchronize()
        require(out.shape == (n, 4) and torch.isfinite(out).all().item(),
                f"fused_render at K = {k}: wrong shape or non-finite values")
        render_errs.append((out - fr.fused_render_reference(packed, points, dirs, deltas)).abs().max().item())
    rows = [f"{m}{' (hidden 40)' if p is not packed else ''}: {e:.2e}"
            for (p, m), e in zip(cases, mlp_errs)]
    print(f"fused_mlp edges, max abs err: {', '.join(rows)} (bound {MLP_BOUND:g})", flush=True)
    print("fused_render edges, max abs err: " + ", ".join(
        f"K {k} ({128 // k * 50 + 1} rays): {e:.2e}" for k, e in zip(RENDER_EDGE_SAMPLES, render_errs))
        + f" (bound {RENDER_BOUND:g})", flush=True)
    require(max(mlp_errs) <= MLP_BOUND, "fused_mlp disagrees with its plain version at an edge")
    require(max(render_errs) <= RENDER_BOUND, "fused_render disagrees with its plain version at an edge")


def ngp_mlp_layers(device, rng, enc_dim):
    """An InstantNGPModel's five layers at the ngp_mlp kernel's widths with
    lecun-normal weights and U(-0.1, 0.1) biases from ``rng``."""
    from learn_nerf_tpu_torch.kernels import ngp_mlp as km

    layers = []
    for out_dim, in_dim in km.layer_shapes(enc_dim):
        layer = torch.nn.Linear(in_dim, out_dim)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(rng.standard_normal((out_dim, in_dim)) / np.sqrt(in_dim)))
            layer.bias.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, out_dim)))
        layers.append(layer.to(device))
    return layers


def ngp_mlp_gaps(got, want):
    """(the density's relative gap, rgb's absolute gap) of two outputs."""
    (density, rgb), (density_ref, rgb_ref) = got, want
    return (((density - density_ref).abs() / density_ref.abs()).max().item(),
            (rgb - rgb_ref).abs().max().item())


def check_ngp_mlp_kernel(device, rng):
    """The NGP MLP kernel against its plain version on the card (the
    model's own cuBLAS and elementwise chain): at both encoding widths, at
    the row counts around its 192-row tiles and its persistent loop, a
    served tile's pool and the hierarchy's passes; bit-equal across runs;
    timed by graph replay beside the chain it replaces."""
    from learn_nerf_tpu_torch.kernels import ngp_mlp as km

    uniform, unit, _ = samplers(rng, device)
    gaps, results = [], []
    for enc_dim, rows_list in NGP_MLP_CASES.items():
        layers = ngp_mlp_layers(device, rng, enc_dim)
        for rows in rows_list:
            enc, d = uniform(rows, enc_dim), unit(rows)
            got = km.launch_ngp_mlp(layers, enc, d)
            again = km.launch_ngp_mlp(layers, enc, d)
            torch.cuda.synchronize()
            want = km.ngp_mlp_reference(layers, enc, d)
            require(got[0].shape == (rows, 1) and got[1].shape == (rows, 3)
                    and all(torch.isfinite(t).all().item() for t in got),
                    f"ngp_mlp at E = {enc_dim}, {rows} rows: wrong shape or non-finite values")
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"ngp_mlp at E = {enc_dim}, {rows} rows: two runs differ")
            gaps.append((enc_dim, rows, *ngp_mlp_gaps(got, want)))
            if rows in NGP_MLP_TIMED:
                macs = sum(layer.weight.numel() for layer in layers)
                weights = nbytes(*(t for layer in layers for t in (layer.weight, layer.bias)))
                results.append(dict(
                    name="ngp_mlp", route="cuda", source="learn_nerf_tpu_torch/csrc/ngp_mlp.cu",
                    replaces="none (the JAX package leaves the 64-wide layers to XLA)", shapes=f"E {enc_dim}, {rows} rows",
                    max_abs_err=gaps[-1][3], ms=graph_ms(lambda: km.launch_ngp_mlp(layers, enc, d), 50),
                    plain_ms=graph_ms(lambda: km.ngp_mlp_reference(layers, enc, d), 20),
                    f32_flops=2.0 * macs * rows, nbytes=nbytes(enc, d, *got) + weights,
                ))
            del got, again, want, enc, d
    for r in results:
        r["bound_ms"], r["bound_by"] = bound(r.pop("nbytes"), f32_ops=r.pop("f32_flops"))
        r["library_ms"] = r["plain_ms"]  # the plain version is the replaced chain: the model's own layers
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        print(f"ngp_mlp at {r['shapes']}: kernel {r['ms']:.4f} ms, the replaced chain {r['plain_ms']:.4f} ms "
              f"(graph replays); bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{100 * r['share_of_bound']:.1f} % of it", flush=True)
    print("ngp_mlp against its plain version, density's relative gap / rgb's absolute gap: " + ", ".join(
        f"E {e} x {n}: {dg:.2e} / {rg:.2e}" for e, n, dg, rg in gaps) + f" (bound {NGP_MLP_BOUND:g})", flush=True)
    require(max(max(g[2], g[3]) for g in gaps) <= NGP_MLP_BOUND, "ngp_mlp disagrees with its plain version")
    return results


def shifted_scan(packed, points, dirs, deltas, ref):
    """Per-ray optical depth of the inputs, and how far the plain version
    moves from ``ref`` when its scan is off by one sample."""
    from learn_nerf_tpu_torch.kernels.fused_mlp import fused_mlp_reference

    n, k, _ = points.shape
    flat_dirs = dirs[:, None, :].expand(n, k, 3).reshape(-1, 3)
    out = fused_mlp_reference(packed, points.reshape(-1, 3), flat_dirs).reshape(n, k, 4)
    sig_dt = out[..., 0] * deltas
    acc = torch.cumsum(sig_dt, dim=1)
    weights = torch.exp(-acc) * (1.0 - torch.exp(-sig_dt))
    fg = torch.einsum("nk,nkc->nc", weights, out[..., 1:])
    return acc[:, -1], (fg - ref[:, :3]).abs().max().item()


def fine_schedule(levels):
    """Grid and table sizes of an NGP model's levels (scripts/common.py)."""
    return [2 ** (4 + i // 2) for i in range(levels)], [2**18] * levels


def ray_run_cases(rng):
    """Points whose neighbours share cells, where the table-gradient
    kernel's warps (32 consecutive points, one lane each) combine runs, at
    the places its vote and shuffles can break."""
    across = rng.uniform(-0.6, 0.6, (64, 3))
    across[16:48] = across[16] + 1e-5 * np.arange(32)[:, None]  # lanes 16-31, then 0-15 of the next warp
    return {
        "32 lanes in one cell": ray_points(rng, 1, 32, 1e-4, -0.3, 0.3),
        "a run across two warps": across.astype(np.float32),
        "two rays in a warp": ray_points(rng, 64, 16, 5e-3, -0.5, 0.5),
        "a part-full tile": ray_points(rng, 6, 32, 2e-2, -0.5, 0.3)[:-25],
    }


@contextlib.contextmanager
def launching_from(lib):
    """Inside, the hash-grid wrappers launch from ``lib`` (a variant of the
    kernel library built by scripts/hashgrid_ablations.py)."""
    from learn_nerf_tpu_torch.kernels import build

    built = build._library
    build._library = lib
    try:
        yield
    finally:
        build._library = built


def gather_routes(rows, columns, cluster_lib):
    """``{kernel: (gather, route)}`` for a ``[rows, columns]`` table, each
    ``gather(table, idx, route)`` adding nothing to the wrapper's launch
    count: the route the wrapper picks, and the cluster kernel
    (``cluster_lib``, which the wrapper gives no table) where the table is
    past the block route and a cluster holds it."""
    from learn_nerf_tpu_torch.kernels import table_gather as tg
    from learn_nerf_tpu_torch.scripts.hashgrid_ablations import cluster_route, gather_with

    picked = tg.gather_route(rows, columns)
    routes = {picked: (gather_with(None), picked)}
    cluster = cluster_route(rows, columns)
    if picked == "l2" and cluster:
        routes["cluster"] = (gather_with(cluster_lib), cluster)
    return routes


def gather_tables(columns):
    """``{case: rows}``: the tables at the edges of table_gather's kernels
    at ``columns``: the largest the block route takes, one past it (no
    cluster size divides 100,003 rows), the largest a cluster of 16 holds
    and one row past it."""
    from learn_nerf_tpu_torch.kernels import table_gather as tg
    from learn_nerf_tpu_torch.scripts.hashgrid_ablations import LARGEST_CLUSTER, SLICE_BYTES

    block = tg.BLOCK_TABLE_BYTES // (4 * columns)
    cluster = LARGEST_CLUSTER * (1 << ((SLICE_BYTES // (4 * columns)).bit_length() - 1))
    return {"largest block": block, "100,003 rows": 100_003, "largest cluster": cluster, "past a cluster": cluster + 1}


def profiled(call, device, counters, tries=3):
    """``profile_render.profile_call`` of ``call``, profiled again, up to
    ``tries`` times, only while its trace holds no device event at all and
    the wrappers' launch ``counters`` show that the call did launch:
    torch.profiler on an H100 now and then records a call's host side and
    none of its kernels (one profiled call in two to four runs of this
    script).  A call that launched nothing is not profiled again, and its
    check fails."""
    from learn_nerf_tpu_torch.scripts.profile_render import profile_call

    for attempt in range(tries):
        before = sum(c.launches for c in counters)
        seen = profile_call(call, device)
        launched = sum(c.launches for c in counters) - before
        if seen["kernels_launched"] or seen["memsets"] or not launched:
            break
        print(f"  the call launched {launched} kernel(s) and the profiler recorded no device event "
              f"(try {attempt + 1} of {tries})", flush=True)
    return seen


def kernel_sequence(call, device, tries=3):
    """The names of the kernels one call of ``call`` launched, in launch
    order (torch.profiler's trace), profiled again, up to ``tries`` times,
    while the trace holds no kernel (see ``profiled``) or shows kernel
    records it lost (``profile_render.launch_records``: a launch call with
    no kernel record), which would hide a kernel from the sequence."""
    from learn_nerf_tpu_torch.scripts.profile_render import launch_records

    for attempt in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize(device)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kernels = sorted((float(e["ts"]), e["name"]) for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
        records = launch_records(events)
        lost = lost_records(dict(graph_launch_kernels=records["graph_kernels"],
                                 launches_without_kernel=records["without_kernel"]))
        if kernels and not lost:
            break
        print(f"  the trace of {len(kernels)} kernels shows {lost} kernel record(s) lost (try {attempt + 1} of "
              f"{tries})", flush=True)
    return [name for _, name in kernels]


def after_selection(sequence):
    """The kernel launched right after each ``select_strided_kernel`` of a
    kernel sequence (None after the last kernel)."""
    return [(sequence[i + 1] if i + 1 < len(sequence) else None) for i, name in enumerate(sequence)
            if "select_strided_kernel" in name]


def same_rows(got, want):
    """Equal, NaN rows where the other has them."""
    return bool(torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))


def check_table_gather(device, rng, libs, probes):
    """table_gather's kernels (routes) at 999,424 indices, exactly
    index_select and the plain version: the block route at [4096, 2], the
    L2 route at pallas_gather's [2^18, 2] and at [2^21, 2], the cluster
    kernel (``libs[GATHER_CLUSTER]``, which the wrapper picks for no table)
    at [2^18, 2]; each at C = 1, 3 and 4 on the tables at the routes'
    edges, at 1, 3, 4 and 5 indices with wrapped and NaN rows, from offset
    views; a variant of the cluster kernel that reads the neighbouring
    block's slice must be caught; each timed beside the kernel it replaced
    (``libs[GATHER_PARENT]``, in turns A B B A), ``index_select`` and the
    card's rate for its reads (``probes``)."""
    from learn_nerf_tpu_torch.kernels import table_gather as tg
    from learn_nerf_tpu_torch.scripts.hashgrid_ablations import (LARGEST_CLUSTER, cluster_placement, gather_with,
                                                                  sector_us, shared_probes)

    def on_card(a):
        return torch.from_numpy(a).to(device)

    def edged(rows, m):
        """m in-range indices, then a wrapped one (-1) and two out of range
        (T, -T - 1) in their first places."""
        idx = rng.randint(0, rows, m).astype(np.int32)
        idx[: min(m, 3)] = [-1, rows, -rows - 1][: min(m, 3)]
        return on_card(idx)

    def table_of(rows, columns):
        return on_card(rng.uniform(-1, 1, (rows, columns)).astype(np.float32))

    def synced(gather, table, idx, route):
        out = gather(table, idx, route)
        torch.cuda.synchronize()
        return out

    placed, unequal, main = {}, [], {}
    for rows in sorted(set(GATHER_SHAPES.values())):
        table, idx = table_of(rows, 2), on_card(rng.randint(0, rows, GATHER_INDICES).astype(np.int32))
        storage, raw = table_of(rows + 1, 2), edged(rows, GATHER_INDICES + 1)
        for kind, (gather, route) in gather_routes(rows, 2, libs[GATHER_CLUSTER]).items():
            name = f"{kind} [{rows}, 2]"
            if kind == "cluster":
                placed[name] = cluster_placement(libs[GATHER_CLUSTER], rows, 2, route)
            out = tg.table_gather_cuda(table, idx) if kind != "cluster" else gather(table, idx, route)
            torch.cuda.synchronize()
            if not (torch.equal(out, table.index_select(0, idx))
                    and torch.equal(out, tg.table_gather_reference(table, idx))):
                unequal.append(name)
            main[name] = (table, idx, out, gather, route)
            for m in GATHER_EDGE_INDICES:
                edge = edged(rows, m)
                if not same_rows(synced(gather, table, edge, route), tg.table_gather_reference(table, edge)):
                    unequal.append(f"{name} at M = {m}")
            # Offset views: the table one row into its storage (8 bytes: no
            # 16-byte vector copies of it), the indices one element into
            # theirs.
            view, idx_view = storage[1:], raw[1:]
            if not same_rows(synced(gather, view, idx_view, route), tg.table_gather_reference(view, idx_view)):
                unequal.append(f"{name} from offset views")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"table_gather: the wrapper's routes {({r: tg.gather_route(r, 2) for r in GATHER_SHAPES.values()})}; "
          f"the block route runs one block on each of the {sms} SMs; the cluster kernel's clusters placed at once "
          f"{placed}", flush=True)
    columns = {}
    for c in (1, 3, 4):
        for case, rows in gather_tables(c).items():
            table, idx = table_of(rows, c), edged(rows, GATHER_INDICES)
            view = table_of(rows + 1, c)[1:]  # 4 * C bytes into its storage
            for kind, (gather, route) in gather_routes(rows, c, libs[GATHER_CLUSTER]).items():
                name = f"C = {c}, {case} [{rows}, {c}], {kind}"
                columns[name] = same_rows(synced(gather, table, idx, route), tg.table_gather_reference(table, idx))
                if not (columns[name] and same_rows(synced(gather, view, idx, route),
                                                    tg.table_gather_reference(view, idx))):
                    unequal.append(name)
    print(f"table_gather at C = 1, 3, 4, 999,424 indices with wrapped and NaN rows, from the table and from an "
          f"offset view: {sorted(columns)}", flush=True)
    table, idx, out, _, route = main[f"cluster [{GATHER_ROWS}, 2]"]
    wrong = synced(gather_with(libs[GATHER_NEIGHBOUR]), table, idx, route)
    caught = (wrong != out).any(dim=1).double().mean().item()
    print(f"table_gather: unequal cases {unequal}; a cluster kernel reading the neighbouring block's slice gets "
          f"{100 * caught:.1f} % of the rows wrong", flush=True)
    require(not unequal, f"table_gather disagrees with index_select or its plain version: {unequal}")
    require(caught > 0.5, "the equality check would not catch a kernel that reads the neighbouring block's slice")

    rates = shared_probes(probes, device)
    print("card's rate for random 8-byte shared-memory reads: "
          + ", ".join(f"{'own' if q == 1 else f'cluster of {q}'} {r['giga_reads_per_s']:.1f} G/s ({r['blocks']} blocks)"
                      for q, r in rates["reads"].items())
          + "; the fill from L2: "
          + ", ".join(f"{k} {r['us']:.2f} us ({r['blocks']} blocks, {r['tb_per_s']:.2f} TB/s)"
                      for k, r in rates["fills"].items()), flush=True)
    fill, reads = rates["fills"], rates["reads"]
    card_us = {  # the fill and the reads at the probed rates, or random L2 sectors
        "block": fill["32 KiB a block, one block a SM"]["us"] + GATHER_INDICES / reads[1]["giga_reads_per_s"] / 1e3,
        "cluster": fill["128 KiB a block, clusters of 16"]["us"]
        + GATHER_INDICES / reads[LARGEST_CLUSTER]["giga_reads_per_s"] / 1e3,
    }
    parent = gather_with(libs[GATHER_PARENT])
    shapes = {}
    for name, (table, idx, out, gather, route) in main.items():
        kind = name.split()[0]
        kernel = lambda: gather(table, idx, route)
        replaced = lambda: parent(table, idx, route)
        turns = {"ms": [], "parent_ms": []}
        for own in (True, False, False, True):
            turns["ms" if own else "parent_ms"].append(graph_ms(kernel if own else replaced, 50))
        rate_us = card_us.get(kind) or sector_us(probes, table.shape[0], GATHER_INDICES, device)
        entry = dict(route=kind, picked=kind == tg.gather_route(*table.shape),
                     **{k: sum(v) / len(v) for k, v in turns.items()}, turns_ms=turns,
                     plain_ms=graph_ms(lambda: tg.table_gather_reference(table, idx), 50),
                     library_ms=graph_ms(lambda: table.index_select(0, idx), 50), card_rate_ms=rate_us / 1e3,
                     eager_ms=cuda_ms(kernel, 200), bound_ms=bound(nbytes(table, idx, out))[0])
        shapes[f"{name} x {GATHER_INDICES}"] = entry
        print(f"table_gather {name} x {GATHER_INDICES}{'' if entry['picked'] else ' (not the wrapper pick)'} "
              f"(graph replay, turns A B B A): kernel {[round(1e3 * t, 3) for t in turns['ms']]} us, the kernel it "
              f"replaced {[round(1e3 * t, 3) for t in turns['parent_ms']]} us, index_select "
              f"{1e3 * entry['library_ms']:.3f} us, plain {1e3 * entry['plain_ms']:.3f} us, bound "
              f"{1e3 * entry['bound_ms']:.3f} us ({100 * entry['bound_ms'] / entry['ms']:.1f} % of it), the card's "
              f"rate {rate_us:.3f} us; back-to-back eager calls {1e3 * entry['eager_ms']:.3f} us", flush=True)
    first = shapes[f"l2 [{GATHER_ROWS}, 2] x {GATHER_INDICES}"]  # the wrapper's pick at pallas_gather's shape
    err = max((out - table.index_select(0, idx)).abs().max().item() for table, idx, out, _, _ in main.values())
    gather = dict(
        name="table_gather", route="cuda", source="learn_nerf_tpu_torch/csrc/table_gather.cu",
        replaces="tools/exp_gather.py:64", max_abs_err=err, ms=first["ms"], parent_ms=first["parent_ms"],
        plain_ms=first["plain_ms"], library_ms=first["library_ms"],  # index_select, the one PyTorch call for it
        card_rate_ms=first["card_rate_ms"], shapes=shapes,
    )
    gather["bound_ms"], gather["bound_by"] = bound(nbytes(*main[f"l2 [{GATHER_ROWS}, 2]"][:3]))
    return gather


def check_hashgrid_kernels(device, rng, tiles):
    """The corner kernel at the fine schedule, then the all-level encode
    kernel at the fine and coarse schedules, in smooth mode, at the edges
    of its thread grid and on points along rays, each against its plain
    version, and bit for bit against the kernel in the table-gradient
    kernel's thread layout (``tiles``, a variant library)."""
    from learn_nerf_tpu_torch.kernels import hashgrid as kh
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.kernels import table_gather as tg
    from learn_nerf_tpu_torch.ops import hashgrid as hg

    def on_card(a):
        return torch.from_numpy(a).to(device)

    grids, tables = fine_schedule(FINE_LEVELS)
    values = [on_card(rng.uniform(-1, 1, (hg.dense_level_rows(g, t), 2)).astype(np.float32))
              for g, t in zip(grids, tables)]
    bbox_min, bbox_max = (-0.7,) * 3, (0.7,) * 3
    x = on_card(rng.uniform(-0.75, 0.75, (ENCODE_POINTS, 3)).astype(np.float32))
    idx, w = kh.hashgrid_corners_cuda(x, grids, tables, bbox_min, bbox_max, False)
    torch.cuda.synchronize()
    ref_idx, ref_w = kh.hashgrid_corners_reference(x, grids, tables, bbox_min, bbox_max, False)
    differ = (idx != ref_idx).double().mean().item()
    corners = dict(
        name="hashgrid_corners", route="cuda", source="learn_nerf_tpu_torch/csrc/hashgrid.cu",
        replaces="learn_nerf_tpu/ops/hashgrid.py:43-99 (XLA)",
        max_abs_err=(w - ref_w).abs().max().item(),
        ms=cuda_ms(lambda: kh.hashgrid_corners_cuda(x, grids, tables, bbox_min, bbox_max, False), 20),
        plain_ms=cuda_ms(
            lambda: kh.hashgrid_corners_reference(x, grids, tables, bbox_min, bbox_max, False), 5),
        library_ms=None,
    )
    corners["bound_ms"], corners["bound_by"] = bound(nbytes(x, idx, w))
    del idx, w, ref_idx, ref_w
    print(f"hashgrid_corners {FINE_LEVELS} levels x {ENCODE_POINTS} points: share of indices "
          f"that differ {differ:.3e} (bound 0); max abs err of weights {corners['max_abs_err']:.3e} "
          f"(bound 0); kernel {corners['ms']:.4f} ms, plain {corners['plain_ms']:.4f} ms", flush=True)
    require(differ == 0 and corners["max_abs_err"] == 0, "hashgrid_corners disagrees with its plain version")

    encode = lambda: ke.hashgrid_encode_cuda(values, x, grids, tables, bbox_min, bbox_max, False)
    plain = lambda: hg.hash_grid_encode_reference(values, x, grids, tables, bbox_min, bbox_max)
    out, ref = encode(), plain()
    torch.cuda.synchronize()
    require(torch.isfinite(out).all().item() and out.shape == (ENCODE_POINTS, 2 * FINE_LEVELS),
            "the encode kernel's output is not finite or has the wrong shape")
    errs = {f"fine, {ENCODE_POINTS} points": (out - ref).abs().max().item()}
    # The same plain encoding with the hash primes swapped: a wrong index.
    primes = hg.HASH_PRIME_Y, hg.HASH_PRIME_Z
    hg.HASH_PRIME_Y, hg.HASH_PRIME_Z = primes[1], primes[0]
    try:
        wrong_err = (plain() - ref).abs().max().item()
    finally:
        hg.HASH_PRIME_Y, hg.HASH_PRIME_Z = primes
    del out, ref
    errs.update(encode_cases(values, x, grids, tables, bbox_min, bbox_max, device, rng))
    # Points along rays, as the main path feeds them: 128 samples 0.01 apart
    # on each of 8192 rays (a frame), 32 samples 0.02 apart on each of 4096 (a
    # train step); neighbouring points share cells in the coarse levels.
    ray_x = on_card(ray_points(rng, ENCODE_POINTS // 128, 128, 0.01, -0.7, 0.7))
    step_x = on_card(ray_points(rng, TRAIN_RAYS, TRAIN_SAMPLES, 0.02, -0.7, 0.4))
    runs = {"2^20 points along rays": ray_x, "a step's points along rays": step_x,
            **{k: on_card(v) for k, v in ray_run_cases(rng).items()}}
    same_bits = True
    for name, pts in {"random points": x, **runs}.items():
        got = ke.hashgrid_encode_cuda(values, pts, grids, tables, bbox_min, bbox_max, False)
        if pts is not x:
            want = hg.hash_grid_encode_reference(values, pts, grids, tables, bbox_min, bbox_max)
            require(torch.isfinite(got).all().item(), f"the encode kernel ({name}): non-finite values")
            errs[name] = (got - want).abs().max().item()
        with launching_from(tiles):
            other = ke.hashgrid_encode_cuda(values, pts, grids, tables, bbox_min, bbox_max, False)
        torch.cuda.synchronize()
        same_bits = same_bits and torch.equal(got, other)
        del got, other

    def per_level():
        # The route the encode kernel replaced, from the kernels that remain:
        # corners, one table_gather per level, the weighted sums and cat.
        idx, w = kh.hashgrid_corners_cuda(x, grids, tables, bbox_min, bbox_max, False)
        return torch.cat([hg.interpolate(w[level], tg.table_gather_cuda(v, idx[level].reshape(-1))
                                         .view(len(x), 8, v.shape[1]))
                          for level, v in enumerate(values)], dim=-1)

    # The NGP hierarchy's train step: each pass's points along rays, the
    # coarse model's levels and the fine model's (HIERARCHY_PASSES).
    hierarchy = {}
    for label, levels, samples, spacing in HIERARCHY_PASSES:
        pts = on_card(ray_points(rng, TRAIN_RAYS, samples, spacing, -0.7, 0.4))
        shape = (values[:levels], pts, grids[:levels], tables[:levels], bbox_min, bbox_max)
        errs[f"hierarchy {label}"] = (ke.hashgrid_encode_cuda(*shape, False)
                                      - hg.hash_grid_encode_reference(*shape)).abs().max().item()
        hierarchy[label] = dict(ms=cuda_ms(lambda: ke.hashgrid_encode_cuda(*shape, False), 20),
                                bound_ms=bound(nbytes(pts, *values[:levels]) + len(pts) * 2 * levels * 4)[0])
    enc = dict(
        name="hashgrid_encode", route="cuda", source="learn_nerf_tpu_torch/csrc/hashgrid_encode.cu",
        replaces="learn_nerf_tpu/ops/hashgrid.py:135 (XLA)", max_abs_err=max(errs.values()),
        ms=cuda_ms(encode, 20), plain_ms=cuda_ms(plain, 3), library_ms=None, hierarchy=hierarchy,
    )
    route_ms = cuda_ms(per_level, 5)
    on = lambda pts: (lambda: ke.hashgrid_encode_cuda(values, pts, grids, tables, bbox_min, bbox_max, False))
    # The main path feeds points along rays: ms_rays at this shape (the bound
    # is the same: as many bytes), ms_step_rays at a train step's.
    enc["ms_rays"], enc["ms_step_rays"] = cuda_ms(on(ray_x), 20), cuda_ms(on(step_x), 20)
    step_random_ms = cuda_ms(on(x[:TRAIN_POINTS].contiguous()), 20)
    with launching_from(tiles):
        tiles_ms = [cuda_ms(on(pts), 20) for pts in (x, ray_x, step_x)]
    ray_ms = enc["ms_rays"]
    out_bytes = ENCODE_POINTS * 2 * FINE_LEVELS * 4
    enc["bound_ms"], enc["bound_by"] = bound(nbytes(x, *values) + out_bytes)
    enc["bound_step_ms"] = bound(nbytes(step_x, *values) + TRAIN_POINTS * 2 * FINE_LEVELS * 4)[0]
    # What the kernel really pulls from L2: one 32-byte sector per corner row.
    l2_gb = ENCODE_POINTS * FINE_LEVELS * 8 * 32 / 1e9
    print(f"hashgrid_encode {FINE_LEVELS} levels x {ENCODE_POINTS} points: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bound {ENCODE_BOUND:g}); swapped hash primes move the plain route by {wrong_err:.3e}; "
          f"kernel {enc['ms']:.4f} ms ({ray_ms:.4f} ms on points along rays), plain "
          f"{enc['plain_ms']:.4f} ms, the per-level route (corners + {FINE_LEVELS} table_gather + "
          f"sums + cat) {route_ms:.4f} ms; L2 sectors of its corner rows {l2_gb:.2f} GB, "
          f"{l2_gb / enc['ms']:.2f} TB/s; at a train step's {TRAIN_POINTS} points {step_random_ms:.4f} ms "
          f"random, {enc['ms_step_rays']:.4f} ms along rays (bound {enc['bound_step_ms']:.4f} ms); in the "
          f"table-gradient kernel's layout {tiles_ms[0]:.4f} ms random, {tiles_ms[1]:.4f} ms along rays, "
          f"{tiles_ms[2]:.4f} ms on a step's rays; bit for bit equal to it on every input: {same_bits}; "
          f"the hierarchy's passes along rays: " + ", ".join(
              f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} ms)" for k, v in hierarchy.items()), flush=True)
    require(enc["max_abs_err"] <= ENCODE_BOUND, "the encode kernel disagrees with its plain version")
    require(same_bits, "the encode kernel's bits differ between its two thread layouts")
    require(wrong_err >= SCAN_MARGIN * ENCODE_BOUND,
            f"the encoding's bound {ENCODE_BOUND:g} would not catch a wrong hash index")
    require(enc["ms"] <= route_ms, "the encode kernel is slower than the per-level route")
    return [corners, enc]


def encode_cases(values, x, grids, tables, bbox_min, bbox_max, device, rng):
    """The encode kernel against its plain version at the coarse schedule,
    in smooth mode and at the edges of its thread grid; ``{case: error}``."""
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.ops import hashgrid as hg

    coarse = COARSE_LEVELS
    cases = [(f"coarse, {len(x)} points", values[:coarse], x, grids[:coarse], tables[:coarse], False),
             (f"smooth, {len(x)} points", values, x, grids, tables, True)]
    cases += [(f"{n} points", values, x[-n:].contiguous(), grids, tables, False) for n in ENCODE_EDGE_POINTS]
    errs = {}
    for name, vals, pts, g, t, smooth in cases:
        out = ke.hashgrid_encode_cuda(vals, pts, g, t, bbox_min, bbox_max, smooth)
        torch.cuda.synchronize()
        ref = hg.hash_grid_encode_reference(vals, pts, g, t, bbox_min, bbox_max, smooth)
        require(out.shape == ref.shape and torch.isfinite(out).all().item(),
                f"the encode kernel ({name}): wrong shape or non-finite values")
        errs[name] = (out - ref).abs().max().item()
    return errs


def per_level_index_add(x, g, grids, tables, bbox_min, bbox_max, features):
    """The yardstick route for the table gradients: the corner kernel's
    indices and weights, then one ``index_add_`` per level (timed here, used
    nowhere in the port)."""
    from learn_nerf_tpu_torch.kernels import hashgrid as kh
    from learn_nerf_tpu_torch.ops import hashgrid as hg

    idx, w = kh.hashgrid_corners_cuda(x, grids, tables, bbox_min, bbox_max, False)
    grads = []
    for level, (grid, size) in enumerate(zip(grids, tables)):
        rows = hg.dense_level_rows(grid, size)
        src = w[level][:, :, None] * g[:, None, level * features:(level + 1) * features]
        grads.append(torch.zeros((rows, features), device=x.device).index_add_(
            0, idx[level].reshape(-1), src.reshape(-1, features)))
    return grads


def relative_errors(got, want):
    """Per tensor: max abs difference over the reference's max abs value."""
    return [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(got, want)]


def check_backward_kernel(device, rng, parent):
    """hashgrid_backward against its plain version (autograd through the
    plain encoding) at the train step's shape, at its edges and on the runs
    of equal cells that rays make; timed beside its earlier layout
    (``parent``)."""
    from learn_nerf_tpu_torch.kernels import hashgrid_backward as kb
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.ops import hashgrid as hg

    def on_card(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    bbox_min, bbox_max = (-0.7,) * 3, (0.7,) * 3
    grids, sizes = fine_schedule(FINE_LEVELS)

    def case(n, levels=FINE_LEVELS, features=2, smooth=False, points=None, one_sign=False):
        g_l, s_l = grids[:levels], sizes[:levels]
        tables = [torch.empty((hg.dense_level_rows(g, t), features), device=device)
                  for g, t in zip(g_l, s_l)]
        x = points if points is not None else on_card(rng.uniform(-0.75, 0.75, (n, 3)))
        g = on_card(rng.uniform(0 if one_sign else -1, 1, (len(x), levels * features)))
        args = ke.encode_args(tables, x.device, g_l, s_l, bbox_min, bbox_max, smooth)
        return tables, x, g, args, (g_l, s_l, bbox_min, bbox_max, smooth)

    tables, x, g, args, config = case(TRAIN_POINTS)
    run = lambda: kb.hashgrid_backward_cuda(x, g, args)
    plain = lambda: kb.hashgrid_backward_reference(tables, x, g, *config)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    require(all(torch.isfinite(a).all().item() for a in out)
            and [a.shape for a in out] == [t.shape for t in tables],
            "hashgrid_backward produced non-finite values or the wrong shapes")
    errs = {f"fine, {TRAIN_POINTS} points": max(relative_errors(out, ref))}
    errs["a second run"] = max(relative_errors(run(), out))
    primes = hg.HASH_PRIME_Y, hg.HASH_PRIME_Z
    hg.HASH_PRIME_Y, hg.HASH_PRIME_Z = primes[1], primes[0]
    try:
        wrong_err = max(relative_errors(plain(), ref))
    finally:
        hg.HASH_PRIME_Y, hg.HASH_PRIME_Z = primes
    cases = {f"{ENCODE_POINTS} points": case(ENCODE_POINTS),
             "coarse": case(TRAIN_POINTS, levels=COARSE_LEVELS),
             "smooth": case(TRAIN_POINTS, smooth=True),
             "F = 1": case(TRAIN_POINTS, features=1), "F = 4": case(TRAIN_POINTS, features=4)}
    cases.update({f"{n} points": case(n) for n in BACKWARD_EDGE_POINTS})
    # Points along rays, as a train step feeds them (32 samples 0.02 apart).
    ray_x = on_card(ray_points(rng, TRAIN_RAYS, TRAIN_SAMPLES, 0.02, -0.7, 0.4))
    cases["along rays"] = case(0, points=ray_x)
    cases.update({k: case(0, points=on_card(v)) for k, v in ray_run_cases(rng).items()})
    # 4096 terms on each of 8 rows: a cotangent of one sign keeps the sums
    # from cancelling, where an error relative to the largest gradient
    # would measure the sum's size and not the kernel.
    cases["one point 4096 times"] = case(
        0, points=on_card(np.tile(rng.uniform(-0.5, 0.5, (1, 3)), (4096, 1))), one_sign=True)
    tb, xs, gs, a, cfg = cases["along rays"]
    errs["a second run along rays"] = max(relative_errors(
        kb.hashgrid_backward_cuda(xs, gs, a), kb.hashgrid_backward_cuda(xs, gs, a)))
    for name, (tb, xs, gs, a, cfg) in cases.items():
        got = kb.hashgrid_backward_cuda(xs, gs, a)
        torch.cuda.synchronize()
        errs[name] = max(relative_errors(got, kb.hashgrid_backward_reference(tb, xs, gs, *cfg)))
        del got
    big_ms = graph_ms(lambda: kb.hashgrid_backward_cuda(*cases[f"{ENCODE_POINTS} points"][1:4]), 10)
    del cases

    entry = dict(
        name="hashgrid_backward", route="cuda", source="learn_nerf_tpu_torch/csrc/hashgrid_backward.cu",
        replaces="learn_nerf_tpu/ops/hashgrid.py:198-203 under jax.grad (XLA scatter-add)",
        # By graph replay, memset included: the wrapper's host work per call
        # is as long as the kernel, and back-to-back eager calls would time it.
        max_abs_err=max(errs.values()), ms=graph_ms(run, 20), plain_ms=cuda_ms(plain, 3),
        library_ms=cuda_ms(lambda: per_level_index_add(x, g, grids, sizes, bbox_min, bbox_max, 2), 5),
    )
    # The main path feeds points along rays: ms_rays (as many bytes: the
    # same bound).
    ray_ms = entry["ms_rays"] = graph_ms(lambda: kb.hashgrid_backward_cuda(ray_x, g, args), 20)
    # The NGP hierarchy's train step: each pass's points along rays, the
    # coarse model's levels and the fine model's (HIERARCHY_PASSES).
    entry["hierarchy"] = {}
    for label, levels, samples, spacing in HIERARCHY_PASSES:
        tb, xs, gs, a, cfg = case(0, levels=levels,
                                  points=on_card(ray_points(rng, TRAIN_RAYS, samples, spacing, -0.7, 0.4)))
        got = kb.hashgrid_backward_cuda(xs, gs, a)
        err = max(relative_errors(got, kb.hashgrid_backward_reference(tb, xs, gs, *cfg)))
        entry["hierarchy"][label] = dict(ms=graph_ms(lambda: kb.hashgrid_backward_cuda(xs, gs, a), 20),
                                         bound_ms=bound(nbytes(xs, gs, *got))[0], max_abs_err=err)
        del got, tb
    hierarchy_err = max(v["max_abs_err"] for v in entry["hierarchy"].values())
    with launching_from(parent):
        earlier_ms = [graph_ms(lambda: kb.hashgrid_backward_cuda(pts, g, args), 20) for pts in (x, ray_x)]
    entry["bound_ms"], entry["bound_by"] = bound(nbytes(x, g, *out))
    # Each level on its own (its own [N, F] cotangent and buffer), random
    # points and points along rays: where the atomics meet.
    level_us = []
    for level in range(FINE_LEVELS):
        one = [torch.empty((hg.dense_level_rows(grids[level], sizes[level]), 2), device=device)]
        a = ke.encode_args(one, x.device, grids[level:level + 1], sizes[level:level + 1],
                           bbox_min, bbox_max, False)
        g_one = g[:, 2 * level:2 * level + 2].contiguous()
        level_us.append((1e3 * graph_ms(lambda: kb.hashgrid_backward_cuda(x, g_one, a), 20),
                         1e3 * graph_ms(lambda: kb.hashgrid_backward_cuda(ray_x, g_one, a), 20)))
    print(f"hashgrid_backward {FINE_LEVELS} levels x {TRAIN_POINTS} points: max err relative to each "
          "level's largest gradient " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bound {BACKWARD_BOUND:g}); swapped hash primes move the plain route by {wrong_err:.3e}; "
          f"kernel {entry['ms']:.4f} ms, {ray_ms:.4f} ms on points along rays, {big_ms:.4f} ms at {ENCODE_POINTS} "
          f"points; in its earlier layout {earlier_ms[0]:.4f} ms, {earlier_ms[1]:.4f} ms along rays; plain "
          f"{entry['plain_ms']:.4f} ms; corners + {FINE_LEVELS} index_add_ "
          f"{entry['library_ms']:.4f} ms; bound {entry['bound_ms']:.4f} ms; the hierarchy's passes along rays: "
          + ", ".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} ms), max err {v['max_abs_err']:.3e}"
                      for k, v in entry["hierarchy"].items()) + f" (bound {HIERARCHY_BACKWARD_BOUND:g})", flush=True)
    print("hashgrid_backward per level, us (lattice: random points / along rays): " + ", ".join(
        f"{grids[i]}: {a:.1f} / {b:.1f}" for i, (a, b) in enumerate(level_us)), flush=True)
    require(entry["max_abs_err"] <= BACKWARD_BOUND and hierarchy_err <= HIERARCHY_BACKWARD_BOUND,
            "hashgrid_backward disagrees with its plain version")
    require(wrong_err >= SCAN_MARGIN * BACKWARD_BOUND,
            f"hashgrid_backward's bound {BACKWARD_BOUND:g} would not catch a wrong hash index")
    return [entry]


def weight_gradients_with(fault):
    """``ops.hashgrid.corner_weight_gradients`` with one of DX_FAULTS."""
    from learn_nerf_tpu_torch.ops import hashgrid as hg

    def faulty(x, grid_size, bbox_min, bbox_max, smooth):
        coords, _ = hg.corner_weights_and_coords(x, grid_size, bbox_min, bbox_max, smooth)
        lo = torch.as_tensor(bbox_min, dtype=torch.float32, device=x.device)
        span = torch.as_tensor(bbox_max, dtype=torch.float32, device=x.device) - lo
        raw = (x - lo) / span
        scale = float(grid_size - 2) if smooth else float(grid_size - 1)
        findex = (0.5 if smooth else 0.0) + scale * torch.clamp(raw, 0.0, 1.0)
        c = findex - torch.clamp(torch.floor(findex), max=float(grid_size - 2))
        slope = (((raw > 0) & (raw < 1)).float() + 0.5 * ((raw == 0) | (raw == 1)).float()) * scale / span
        if smooth and fault != "no smoothstep derivative":
            slope = slope * 6.0 * c * (1.0 - c)
        cf = c * c * (3.0 - 2.0 * c) if smooth else c
        offs = torch.tensor(hg.CORNERS, dtype=torch.bool, device=x.device)
        wpa = torch.where(offs, cf[..., None, :], 1.0 - cf[..., None, :])
        dwpa = torch.where(offs, slope[..., None, :], -slope[..., None, :])
        grads = torch.stack([dwpa[..., 0] * wpa[..., 1] * wpa[..., 2], wpa[..., 0] * dwpa[..., 1] * wpa[..., 2],
                             wpa[..., 0] * wpa[..., 1] * dwpa[..., 2]], dim=-1)
        if fault == "a wrong axis of the weight gradient":
            grads = grads[..., [1, 2, 0]]
        elif fault == "a flipped corner sign":
            grads = torch.cat([-grads[..., :1, :], grads[..., 1:, :]], dim=-2)
        return coords, grads

    return faulty


def face_points(rng, n, lo=-0.7, hi=0.7):
    """``n`` points in the bbox with one coordinate each on a face, within
    an ulp of one or just past one (a quarter each), the rest inside."""
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    axis = rng.randint(0, 3, n)
    face = np.where(rng.rand(n) < 0.5, np.float32(lo), np.float32(hi))
    kind = rng.randint(0, 4, n)
    inward = np.where(face == np.float32(lo), 1.0, -1.0).astype(np.float32)
    value = np.where(kind == 0, face, np.where(kind == 1, np.nextafter(face, face + inward),
                                               np.where(kind == 2, face - inward * np.float32(1e-3), pts[np.arange(n), axis])))
    pts[np.arange(n), axis] = value.astype(np.float32)
    return pts


def check_dx_kernels(device, rng, parent):
    """hashgrid_dx and its backward against their plain versions (the JAX
    package's derivative, ops/hashgrid.py) in smooth mode at the occupancy
    step's and the hierarchy's shapes along rays, near the bbox's faces and
    at the thread grids' edges, and against the pair as first designed
    (``parent``: its forward and backward entry points); timed beside that
    pair (turns A B B A), the plain versions and eager autograd of the plain
    encode (first and second derivative)."""
    from learn_nerf_tpu_torch.kernels import hashgrid_dx as kd
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.ops import hashgrid as hg

    def on_card(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    bbox_min, bbox_max = (-0.7,) * 3, (0.7,) * 3
    grids, sizes = fine_schedule(FINE_LEVELS)
    tables = [on_card(rng.uniform(-1, 1, (hg.dense_level_rows(g, s), 2))) for g, s in zip(grids, sizes)]

    def case(points, levels=FINE_LEVELS):
        n = len(points)
        x, g, h = on_card(points), on_card(rng.uniform(-1, 1, (n, 2 * levels))), on_card(rng.uniform(-1, 1, (n, 3)))
        config = (grids[:levels], sizes[:levels], bbox_min, bbox_max, True)
        return tables[:levels], x, g, h, ke.encode_args(tables[:levels], x.device, *config), config

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    def plain(tb, x, g, h, config):
        return (hg.hash_grid_encode_dx_reference(tb, x, g, *config),
                hg.hash_grid_encode_dx_backward_reference(tb, x, g, h, *config))

    unequal, parent_errs = [], {}

    def errors(name, tb, x, g, h, args, config, reference=None):
        dx, (gg, gt) = kd.launch_dx(args, x, g), kd.launch_dx_backward(args, x, g, h)
        was_dx, (was_gg, was_gt) = kd.run_dx(parent[0], args, x, g), kd.run_dx_backward(parent[1], args, x, g, h)
        torch.cuda.synchronize()
        require(dx.shape == x.shape and gg.shape == g.shape and all(torch.isfinite(t).all().item()
                                                                     for t in (dx, gg, *gt)),
                "hashgrid_dx or its backward: wrong shapes or values that are not finite")
        if not (torch.equal(dx, was_dx) and torch.equal(gg, was_gg)):
            unequal.append(name)
        parent_errs[name] = max(relative_errors(gt, was_gt))
        ref_dx, (ref_gg, ref_gt) = reference or plain(tb, x, g, h, config)
        return rel(dx, ref_dx), max(rel(gg, ref_gg), *relative_errors(gt, ref_gt))

    def in_turns(own, replaced):
        """(own ms, replaced ms) by graph replay in turns A B B A."""
        times = [graph_ms(fn, 20) for fn in (own, replaced, replaced, own)]
        return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2

    step = case(ray_points(rng, TRAIN_RAYS, TRAIN_SAMPLES, 0.02, -0.7, 0.4))
    tb, x, g, h, args, config = step
    reference = plain(tb, x, g, h, config)
    name = f"step, {TRAIN_POINTS} points along rays"
    errs = {name: errors(name, *step, reference=reference)}
    errs["near the bbox faces"] = errors("near the bbox faces", *case(face_points(rng, TRAIN_POINTS)))
    for levels, counts in DX_EDGE_POINTS.items():
        for n in counts:
            name = f"{n} points, {levels} levels"
            errs[name] = errors(name, *case(rng.uniform(-0.75, 0.75, (n, 3)), levels))
    _, second = kd.launch_dx_backward(args, x, g, h)
    _, third = kd.launch_dx_backward(args, x, g, h)
    errs["the backward twice"] = (0.0, max(relative_errors(second, third)))
    del second, third
    moves = {}
    for fault in DX_FAULTS:
        right = hg.corner_weight_gradients
        hg.corner_weight_gradients = weight_gradients_with(fault)
        try:
            wrong_dx, (wrong_gg, wrong_gt) = plain(tb, x, g, h, config)
        finally:
            hg.corner_weight_gradients = right
        ref_dx, (ref_gg, ref_gt) = reference
        moves[fault] = (rel(wrong_dx, ref_dx), max(rel(wrong_gg, ref_gg), *relative_errors(wrong_gt, ref_gt)))
        del wrong_dx, wrong_gg, wrong_gt

    # Eager autograd of the plain encode: its first derivative in the
    # points, and that derivative's own in the cotangent and the tables.
    xr, gr = x.detach().requires_grad_(), g.detach().requires_grad_()
    tr = [t.detach().requires_grad_() for t in tb]

    def autograd_dx(create_graph=False):
        out = hg.hash_grid_encode_reference(tr, xr, *config)
        return torch.autograd.grad(out, xr, gr, create_graph=create_graph)[0]

    def autograd_dx_backward():
        return torch.autograd.grad(autograd_dx(create_graph=True), [gr, *tr], h)

    dx_out, (gg_out, gt_out) = kd.launch_dx(args, x, g), kd.launch_dx_backward(args, x, g, h)
    forward_ms = in_turns(lambda: kd.launch_dx(args, x, g), lambda: kd.run_dx(parent[0], args, x, g))
    backward_ms = in_turns(lambda: kd.launch_dx_backward(args, x, g, h),
                           lambda: kd.run_dx_backward(parent[1], args, x, g, h))
    forward = dict(
        name="hashgrid_dx", route="cuda", source="learn_nerf_tpu_torch/csrc/hashgrid_dx.cu",
        replaces="learn_nerf_tpu/ops/hashgrid.py:135 under jax.vjp at learn_nerf_tpu/models/ref_nerf.py:71-74 (XLA)",
        max_abs_err=max(e[0] for e in errs.values()), ms=forward_ms[0], parent_ms=forward_ms[1],
        plain_ms=cuda_ms(lambda: hg.hash_grid_encode_dx_reference(tb, x, g, *config), 3),
        library_ms=cuda_ms(autograd_dx, 3), hierarchy={},
    )
    forward["bound_ms"], forward["bound_by"] = bound(nbytes(x, g, dx_out, *tb))
    backward = dict(
        name="hashgrid_dx_backward", route="cuda", source="learn_nerf_tpu_torch/csrc/hashgrid_dx.cu",
        replaces="the VJP of hashgrid_dx's XLA ops under jax.grad (learn_nerf_tpu/models/ref_nerf.py:71-74, "
                 "normal_mse)",
        max_abs_err=max(e[1] for e in errs.values()), ms=backward_ms[0], parent_ms=backward_ms[1],
        plain_ms=cuda_ms(lambda: hg.hash_grid_encode_dx_backward_reference(tb, x, g, h, *config), 3),
        library_ms=cuda_ms(autograd_dx_backward, 3), hierarchy={},
    )
    backward["bound_ms"], backward["bound_by"] = bound(nbytes(x, g, h, *tb, gg_out, *gt_out))
    del xr, gr, tr, reference, dx_out, gg_out, gt_out
    for label, levels, samples, spacing in HIERARCHY_PASSES:
        tb, xs, gs, hs, a, cfg = case(ray_points(rng, TRAIN_RAYS, samples, spacing, -0.7, 0.4), levels)
        err = errors(label, tb, xs, gs, hs, a, cfg)
        dx_out, (gg_out, gt_out) = kd.launch_dx(a, xs, gs), kd.launch_dx_backward(a, xs, gs, hs)
        ms = in_turns(lambda: kd.launch_dx(a, xs, gs), lambda: kd.run_dx(parent[0], a, xs, gs))
        forward["hierarchy"][label] = dict(ms=ms[0], parent_ms=ms[1], bound_ms=bound(nbytes(xs, gs, dx_out, *tb))[0],
                                           max_abs_err=err[0])
        ms = in_turns(lambda: kd.launch_dx_backward(a, xs, gs, hs),
                      lambda: kd.run_dx_backward(parent[1], a, xs, gs, hs))
        backward["hierarchy"][label] = dict(ms=ms[0], parent_ms=ms[1],
                                            bound_ms=bound(nbytes(xs, gs, hs, *tb, gg_out, *gt_out))[0],
                                            max_abs_err=err[1])
        del xs, gs, hs, a, dx_out, gg_out, gt_out
    for k in (forward, backward):
        k["max_abs_err"] = max(k["max_abs_err"], *(v["max_abs_err"] for v in k["hierarchy"].values()))
    for k, bound_, i in ((forward, DX_BOUND, 0), (backward, DX_BACKWARD_BOUND, 1)):
        print(f"{k['name']} (smooth, {FINE_LEVELS} levels): max err relative to each tensor's largest value "
              + ", ".join(f"{name} {e[i]:.3e}" for name, e in errs.items())
              + "; the hierarchy's passes " + ", ".join(f"{name} {v['max_abs_err']:.3e}"
                                                        for name, v in k["hierarchy"].items())
              + f" (bound {bound_:g}); the faults move the plain version by "
              + ", ".join(f"{fault} {m[i]:.3e}" for fault, m in moves.items())
              + f"; kernel {k['ms']:.4f} ms at {TRAIN_POINTS} points along rays (the first design "
              + f"{k['parent_ms']:.4f} ms, turns A B B A; bound {k['bound_ms']:.4f} ms), "
              + ", ".join(f"{name} {v['ms']:.4f} ms (first design {v['parent_ms']:.4f} ms; bound {v['bound_ms']:.4f} ms)"
                          for name, v in k["hierarchy"].items())
              + f"; plain {k['plain_ms']:.4f} ms; eager autograd of the plain encode {k['library_ms']:.4f} ms",
              flush=True)
        require(k["max_abs_err"] <= bound_, f"{k['name']} disagrees with its plain version")
        require(min(m[i] for m in moves.values()) >= SCAN_MARGIN * bound_,
                f"{k['name']}'s bound {bound_:g} would not catch one of {DX_FAULTS}: {moves}")
    print(f"hashgrid_dx pair against the first design at {len(parent_errs)} cases: dx and grad_g bit-equal "
          f"{not unequal} {unequal}; table gradients max err {max(parent_errs.values()):.3e} "
          f"(bound {DX_BACKWARD_BOUND:g})", flush=True)
    require(not unequal, f"hashgrid_dx or its backward's grad_g differs from the first design at {unequal}")
    require(max(parent_errs.values()) <= DX_BACKWARD_BOUND,
            f"the dx backward's table gradients differ from the first design's beyond {DX_BACKWARD_BOUND:g}: "
            f"{parent_errs}")
    return [forward, backward]


def composite_closed_form(densities, dt, rgbs, background, mask, cotangents,
                          forward_shift=False, reverse_shift=False):
    """Outputs and the densities' gradient by the kernels' formulas in plain
    PyTorch; a shift makes the forward or the reverse scan off by one."""
    g_out, g_w, g_alpha = cotangents
    k = densities.shape[1]
    s = densities * dt
    acc = torch.cumsum(s, dim=1)
    w = torch.exp(-(acc if forward_shift else acc - s)) * (1.0 - torch.exp(-s))
    w_last = torch.exp(-acc[:, -1:])
    out = torch.einsum("nk,nkc->nc", w, rgbs) + w_last * background
    out = torch.where(mask[:, None], out, background[None, :])
    big_g = g_w[:, :k] + torch.where(mask[:, None], torch.einsum("nc,nkc->nk", g_out, rgbs), 0.0)
    g_last = g_w[:, k] + torch.where(mask, g_out @ background - g_alpha[:, 0], 0.0)
    gw = big_g * w
    from_t = gw.sum(dim=1, keepdim=True) - torch.cumsum(gw, dim=1) + gw + (g_last * w_last[:, 0])[:, None]
    after_t = from_t if reverse_shift else from_t - gw
    return out, (big_g * torch.exp(-acc) - after_t) * dt


@contextlib.contextmanager
def dense_composite_from(lib):
    """Inside, the dense composite wrappers launch the dense entry points of
    ``lib``, csrc/ablations/composite_pooled_parent.cu built on its own."""
    from learn_nerf_tpu_torch.kernels import build

    built = build._library
    build._library = types.SimpleNamespace(nerf_composite_forward=lib.nerf_composite_forward_parent,
                                           nerf_composite_backward=lib.nerf_composite_backward_parent,
                                           nerf_error_string=build.library().nerf_error_string)
    try:
        yield
    finally:
        build._library = built


def check_composite_kernels(device, rng, parent):
    """The composite kernels against autograd through ops/volume at the main
    path's shapes and at the edges of their register and chunk paths, with
    the off-by-one checks, the background gradient's bits over two runs,
    every shape bit-equal to the dense kernels of ``parent`` (the source
    before the pool layout had kernels of its own), and each shape timed
    beside its bound."""
    from learn_nerf_tpu_torch.kernels import composite as kc

    def on_card(a):
        return torch.from_numpy(a).to(device)

    def case(n, k, per_sample, extras):
        # Optical depth 1-3: densities up to 2 (a fifth of the slots
        # padding), bin widths around 2 / k (per ray, or per sample).
        densities = (rng.uniform(0, 2, (n, k)) * (rng.rand(n, k) < 0.8)).astype(np.float32)
        deltas = (rng.uniform(0.03, 0.1, (n, k if per_sample else 1)) * 32 / k).astype(np.float32)
        values = [densities, deltas, rng.uniform(-1, 1, (n, k, 3)).astype(np.float32),
                  np.array([-1.0, 0.3, 1.0], np.float32)]
        if extras:
            values.append(rng.uniform(-1, 1, (n, k, extras)).astype(np.float32))
        leaves = [on_card(a).requires_grad_() for a in values]
        mask = on_card(rng.rand(n) < 0.9)
        shapes = [(n, 3), (n, k + 1), (n, 1)] + ([(n, extras)] if extras else [])
        cotangents = [on_card(rng.randn(*shape).astype(np.float32)) for shape in shapes]
        return leaves, mask, cotangents

    def split(leaves):
        return (*leaves[:4], leaves[4] if len(leaves) > 4 else None)

    def present(outs):
        return [o for o in outs if o is not None]

    def errors(leaves, mask, cotangents):
        *inputs, extras = split(leaves)
        outs = present(kc.render_composite(*inputs, mask, extras))
        grads = torch.autograd.grad(outs, leaves, cotangents)
        torch.cuda.synchronize()
        ref = present(kc.render_composite_reference(*inputs, mask, extras))
        ref_grads = torch.autograd.grad(ref, leaves, cotangents)
        require(all(torch.isfinite(a).all().item() for a in (*outs, *grads)),
                "the composite kernels produced non-finite values")
        return (max((a - b).abs().max().item() for a, b in zip(outs, ref)),
                max(relative_errors(grads, ref_grads)))

    # The main path's calls: the train step (per-ray widths, the points as
    # extras), a fixed-K frame's tile of 8192, the hierarchy's two passes
    # (per-sample widths, the points as extras); then per-ray widths with
    # five extras (points and two aux losses), and the edges of the register
    # and chunk paths on one ray more than whole blocks of 8.
    shapes = {f"{n} x {k}": (n, k, per_sample) for n, k, per_sample in COMPOSITE_SHAPES}
    fwd_errs, bwd_errs, cases = {}, {}, {}
    for name, (n, k, per_sample) in shapes.items():
        cases[name] = case(n, k, per_sample, 3)
        fwd_errs[name], bwd_errs[name] = errors(*cases[name])
    five = f"{TRAIN_RAYS} x {TRAIN_SAMPLES}, 5 extras"
    fwd_errs[five], bwd_errs[five] = errors(*case(TRAIN_RAYS, TRAIN_SAMPLES, False, 5))
    for samples in COMPOSITE_EDGE_SAMPLES:
        for per_sample in (False, True):
            name = f"{TRAIN_RAYS + 1} x {samples}{' per sample' if per_sample else ''}"
            fwd_errs[name], bwd_errs[name] = errors(*case(TRAIN_RAYS + 1, samples, per_sample, 3))

    # The dense kernels as the parent source built them, bit for bit: the
    # pool layout's kernels moved out of their template.
    unequal = []
    for name in shapes:
        leaves, mask, cotangents = cases[name]
        *inputs, extras = split([v.detach() for v in leaves])
        runs = []
        for context in (contextlib.nullcontext(), dense_composite_from(parent)):
            with context:
                runs.append([*present(kc.composite_forward_cuda(*inputs, mask, extras)),
                             *present(kc.composite_backward_cuda(*inputs, mask, extras, *cotangents))])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            unequal.append(name)
    print(f"composite: outputs and gradients bit-equal to the parent source's dense kernels at {list(shapes)}: "
          f"{not unequal} {unequal}", flush=True)
    require(not unequal, f"the dense composite kernels differ from the parent source's at {unequal}")

    # Off by one, forward or reverse, at the step's shape (no extras).
    leaves, mask, cotangents = cases[f"{TRAIN_RAYS} x {TRAIN_SAMPLES}"]
    leaves, cotangents = leaves[:4], cotangents[:3]
    plain = [v.detach() for v in leaves]
    depth = (plain[0] * plain[1]).sum(dim=1)
    ref_out = kc.render_composite_reference(*plain, mask)[0]
    ref_grad = torch.autograd.grad(kc.render_composite_reference(*leaves, mask)[:3], leaves[0], cotangents)[0]
    own_out, own_grad = composite_closed_form(*plain, mask, cotangents)
    shifted_out, _ = composite_closed_form(*plain, mask, cotangents, forward_shift=True)
    _, shifted_grad = composite_closed_form(*plain, mask, cotangents, reverse_shift=True)
    scale = ref_grad.abs().max().item()
    form_err = max((own_out - ref_out).abs().max().item(), (own_grad - ref_grad).abs().max().item() / scale)
    forward_moved = (shifted_out - ref_out).abs().max().item()
    reverse_moved = (shifted_grad - ref_grad).abs().max().item() / scale
    print(f"composite inputs: optical depth per ray median {depth.median().item():.3f}, min "
          f"{depth.min().item():.3f}, max {depth.max().item():.3f}; the closed form agrees within "
          f"{form_err:.3e}; an off-by-one scan moves the forward by {forward_moved:.3e} and the reverse "
          f"scan the densities' gradient by {reverse_moved:.3e} of its max", flush=True)
    require(form_err <= 10 * COMPOSITE_GRAD_BOUND, "the closed form of the backward disagrees with autograd")
    require(forward_moved >= SCAN_MARGIN * COMPOSITE_BOUND and reverse_moved >= SCAN_MARGIN * COMPOSITE_GRAD_BOUND,
            "the composite bounds would not catch an off-by-one scan")

    # The background's gradient, summed by the last block in a fixed order.
    leaves, mask, cotangents = cases[f"{RENDER_RAYS} x {TRAIN_SAMPLES}"]
    plain = [v.detach() for v in leaves]
    runs = [kc.composite_backward_cuda(*plain[:4], mask, plain[4], cotangents[0], None, None)[3]
            for _ in range(2)]
    torch.cuda.synchronize()
    same_bits = torch.equal(runs[0], runs[1])
    print(f"composite_backward: the background's gradient over two runs at {RENDER_RAYS} x "
          f"{TRAIN_SAMPLES}: {runs[0].tolist()} / {runs[1].tolist()}, bit-equal {same_bits}", flush=True)
    require(same_bits, "two runs of composite_backward differ in the background's gradient")

    # The train step's two calls, profiled: one kernel each, nothing zeroed.

    leaves, mask, cotangents = cases[f"{TRAIN_RAYS} x {TRAIN_SAMPLES}"]
    plain = [v.detach() for v in leaves]
    step_calls = {
        "forward": lambda: kc.composite_forward_cuda(*plain[:4], mask, plain[4]),
        "backward": lambda: kc.composite_backward_cuda(*plain[:4], mask, plain[4], cotangents[0], None, None,
                                                       None, wanted=(False, True, True, False)),
    }
    def timed(call):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for name, call in step_calls.items():
        timed(call)
        seen = profiled(lambda: timed(call), device, (kc.counter, kc.backward_counter))
        print(f"composite {name} as the train step calls it, profiled: {seen['kernels_launched']} kernel(s), "
              f"{seen['memsets']} memset(s): {[t['name'] for t in seen['top']]}", flush=True)
        require(seen["kernels_launched"] == 1 and seen["memsets"] == 0,
                f"the step's composite {name} ran {seen['kernels_launched']} kernels and {seen['memsets']} memsets")

    # Times at each shape (graph replay), beside the bound of this run's
    # tensors: each input read once and each output written once.  The
    # backward takes all four cotangents and writes every gradient.
    timed = {}
    for name, (n, k, _) in shapes.items():
        leaves, mask, cotangents = cases[name]
        plain = [v.detach() for v in leaves]
        *inputs, extras = split(plain)
        outs = present(kc.composite_forward_cuda(*inputs, mask, extras))
        grads = present(kc.composite_backward_cuda(*inputs, mask, extras, *cotangents))
        graph = present(kc.render_composite_reference(*split(leaves)[:4], mask, split(leaves)[4]))
        ops = (SCAN_OPS + 2 * extras.shape[-1]) * n * k
        entry = dict(
            ms=graph_ms(lambda: kc.composite_forward_cuda(*inputs, mask, extras), 50),
            plain_ms=graph_ms(lambda: kc.render_composite_reference(*inputs, mask, extras), 20),
            backward_ms=graph_ms(lambda: kc.composite_backward_cuda(*inputs, mask, extras, *cotangents), 50),
            # Autograd's backward through the plain ops, eager (its own graph kept).
            backward_plain_ms=cuda_ms(lambda: torch.autograd.grad(graph, leaves, cotangents, retain_graph=True), 10),
        )
        entry["bound_ms"], entry["bound_by"] = bound(nbytes(*plain, mask, *outs), f32_ops=ops)
        entry["backward_bound_ms"], entry["backward_bound_by"] = bound(
            nbytes(*plain, mask, *cotangents, *grads), f32_ops=2 * ops)
        timed[name] = entry
        print(f"composite {name}{' (per-sample widths)' if shapes[name][2] else ''}: forward "
              f"{1e3 * entry['ms']:.2f} us (graph replay), plain {1e3 * entry['plain_ms']:.2f} us, bound "
              f"{1e3 * entry['bound_ms']:.2f} us ({entry['bound_by']}); backward {1e3 * entry['backward_ms']:.2f} us, "
              f"eager autograd {1e3 * entry['backward_plain_ms']:.1f} us, bound "
              f"{1e3 * entry['backward_bound_ms']:.2f} us ({entry['backward_bound_by']})", flush=True)

    step = timed[f"{TRAIN_RAYS} x {TRAIN_SAMPLES}"]
    common = dict(route="cuda", source="learn_nerf_tpu_torch/csrc/composite.cu", library_ms=None)
    forward = dict(
        name="composite", **common,
        replaces="learn_nerf_tpu/ops/volume.py:41-124 at learn_nerf_tpu/render.py:73-79 and "
                 "learn_nerf_tpu/occ_render.py:217-222 (XLA)",
        max_abs_err=max(fwd_errs.values()), ms=step["ms"], plain_ms=step["plain_ms"],
        bound_ms=step["bound_ms"], bound_by=step["bound_by"],
        shapes={name: dict(ms=e["ms"], bound_ms=e["bound_ms"]) for name, e in timed.items()},
    )
    backward = dict(
        name="composite_backward", **common,
        replaces="the VJP of learn_nerf_tpu/ops/volume.py:41-124 under jax.grad (XLA)",
        max_abs_err=max(bwd_errs.values()), ms=step["backward_ms"], plain_ms=step["backward_plain_ms"],
        bound_ms=step["backward_bound_ms"], bound_by=step["backward_bound_by"],
        shapes={name: dict(ms=e["backward_ms"], bound_ms=e["backward_bound_ms"]) for name, e in timed.items()},
    )
    for entry, errs, limit in ((forward, fwd_errs, COMPOSITE_BOUND), (backward, bwd_errs, COMPOSITE_GRAD_BOUND)):
        print(f"{entry['name']}: max err " + ", ".join(f"{a} {b:.2e}" for a, b in errs.items())
              + f" (bound {limit:g})", flush=True)
        require(entry["max_abs_err"] <= limit, f"{entry['name']} disagrees with its plain version")
    return [forward, backward]


def pool_case(rng, device, n, k, rows, counts, extras):
    """A pool of ``rows`` from per-ray survivor counts (each at most k):
    ray r owns rows starts[r] .. starts[r+1] - 1, the counts clamped at the
    pool's end (trailing rays lose samples when it is short), optical
    depth about 1-3 on a full ray; leaves (densities, rgbs, background,
    extras) that require grad, the rest, and the cotangents."""
    starts = np.concatenate([[0], np.minimum(np.cumsum(counts), rows)]).astype(np.int32)
    densities = (rng.uniform(0, 2, rows) * (rng.rand(rows) < 0.8)).astype(np.float32)
    leaves = [densities, rng.uniform(-1, 1, (rows, 3)).astype(np.float32),
              np.array([-1.0, 0.3, 1.0], np.float32), rng.uniform(-1, 1, (rows, extras)).astype(np.float32)]
    leaves = [torch.from_numpy(a).to(device).requires_grad_() for a in leaves]
    deltas = torch.from_numpy((rng.uniform(0.03, 0.1, (n, 1)) * 32 / k).astype(np.float32)).to(device)
    rest = (torch.from_numpy(starts).to(device), deltas, torch.from_numpy(rng.rand(n) < 0.9).to(device))
    cotangents = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(device) for s in ((n, 3), (n, 1), (n, extras))]
    return leaves, rest, cotangents


def pooled_call(fn, leaves, rest, k):
    densities, rgbs, background, extras = leaves
    starts, deltas, mask = rest
    return fn(densities, starts, deltas, rgbs, background, mask, extras, k)


def dense_route(leaves, rest, k):
    """The route the pool layout replaced: the pool gathered back to [N, K]
    slots, the dense kernels, the gradients scattered back to pool order."""
    from learn_nerf_tpu_torch.kernels import composite as kc

    densities, rgbs, background, extras = [v.detach() for v in leaves]
    starts, deltas, mask = rest
    rows, n = densities.shape[0], starts.shape[0] - 1
    first = starts[:-1].long()[:, None]
    slot = torch.arange(k, device=densities.device)[None, :]
    valid = slot < starts[1:].long()[:, None] - first
    index = torch.where(valid, first + slot, rows).reshape(-1)  # row `rows`: the spare

    def gathered():
        def back(v):
            return torch.cat([v, v.new_zeros((1, *v.shape[1:]))])[index].reshape(n, k, *v.shape[1:])
        return back(densities), back(rgbs), back(extras)

    def forward():
        d, r, e = gathered()
        return kc.composite_forward_cuda(d, deltas, r, background, mask, e)

    def backward(g_out, g_alpha, g_ex):
        d, r, e = gathered()
        gd, _, gr, gb, ge = kc.composite_backward_cuda(d, deltas, r, background, mask, e, g_out, None, g_alpha, g_ex,
                                                       wanted=(False, True, True, True))

        def scatter(g, v):
            pool = v.new_zeros((rows + 1, *v.shape[1:]))
            return pool.index_copy_(0, index, g.reshape(n * k, *v.shape[1:]))[:rows]
        return scatter(gd, densities), scatter(gr, rgbs), gb, scatter(ge, extras)

    return forward, backward


def pool_edges(rng, device):
    """``{case: (k, pool_case(...))}``: the pool layout's edges, at 4097 rays
    or more (one past whole groups of every rays-a-warp): rays of 0, 1, 32
    and 64 rows with a part-full tail; five extras; a pool 0.7 of its
    survivors (the trailing rays cut); every ray one row; rays alternating 0
    and 64 rows; a run of 31, 33, 1 rows that straddles chunks and groups;
    8195 rays at a budget-6 tile's counts (no multiple of any rays-a-warp
    but 1)."""
    n = TRAIN_RAYS + 1

    def survivors(n, k, mean):
        return np.minimum(rng.binomial(192, mean / 192, n), k)

    cases = {}
    edge = np.resize([0, 1, 32, 64], n)
    cases["4097 rays of 0, 1, 32, 64 samples, K 64"] = (64, pool_case(rng, device, n, 64, int(edge.sum()) + 77, edge, 3))
    edge = np.resize([0, 1, 32], n)
    cases["4097 rays of 0, 1, 32 samples, 5 extras"] = (32, pool_case(rng, device, n, 32, int(edge.sum()) + 5, edge, 5))
    short = survivors(n, 32, 9.6)
    cases["4097 rays, a pool 0.7 of their survivors"] = (32, pool_case(rng, device, n, 32, int(0.7 * short.sum()), short, 3))
    ones = np.ones(n, np.int64)
    cases["4097 rays of 1 sample each"] = (32, pool_case(rng, device, n, 32, n, ones, 3))
    edge = np.resize([0, 64], n)
    cases["4097 rays alternating 0 and 64 samples"] = (64, pool_case(rng, device, n, 64, int(edge.sum()) + 3, edge, 3))
    edge = np.resize([31, 33, 1], n)
    cases["4097 rays of 31, 33, 1 samples"] = (64, pool_case(rng, device, n, 64, int(edge.sum()), edge, 3))
    tile = survivors(8195, 32, 4.6)
    cases["8195 rays at a budget-6 tile's counts"] = (32, pool_case(rng, device, 8195, 32, 8195 * 6, tile, 3))
    return cases


@contextlib.contextmanager
def rays_per_warp(rays):
    """Inside, the pool-layout wrappers give a warp ``rays`` rays (None: their
    own rule)."""
    from learn_nerf_tpu_torch.kernels import composite as kc

    rule = kc.pooled_rays_per_warp
    if rays is not None:
        kc.pooled_rays_per_warp = lambda n, rows: rays
    try:
        yield
    finally:
        kc.pooled_rays_per_warp = rule


def check_pooled_composite_kernels(device, rng, parent, probes):
    """The composite kernels in the pool layout against their plain version
    at the pooled step's and a pooled frame tile's shapes and at the edges
    (``pool_edges``), each at every rays-a-warp and at the wrappers' own
    rule, with a check that the bounds catch starts shifted by one, the
    forward and the background's gradient bit-equal over two runs, the
    step's two calls and a tile's profiled to one kernel each and no memset,
    each main shape timed beside the kernels they replaced (``parent``, PR
    8's pair, built from csrc/ablations/composite_pooled_parent.cu, in turns
    A B B A; the same grid, a warp a ray), beside the floor of a launch at
    that grid (an empty kernel from ``probes``) and beside the dense route
    they replaced before."""
    from learn_nerf_tpu_torch.kernels import composite as kc
    from learn_nerf_tpu_torch.scripts.composite_ablations import floor_ms, launching_pooled_from, pool_counts

    cases = {}
    for name, (n, k, budget, mean, run) in POOLED_SHAPES.items():
        cases[name] = (k, pool_case(rng, device, n, k, n * budget, pool_counts(rng, n, k, mean, run), 3))
    cases.update(pool_edges(rng, device))

    def errors(k, leaves, rest, cotangents, ref, ref_grads):
        outs = pooled_call(kc.render_composite_pooled, leaves, rest, k)
        grads = torch.autograd.grad(outs, leaves, cotangents)
        torch.cuda.synchronize()
        require(all(torch.isfinite(a).all().item() for a in (*outs, *grads)),
                "the pooled composite kernels produced non-finite values")
        tail = int(rest[0][-1])
        require(all(g[tail:].abs().max().item() == 0 for g in (grads[0], grads[1], grads[3]) if g.shape[0] > tail),
                "the pooled backward left the pool's tail without zeros")
        return (max((a - b).abs().max().item() for a, b in zip(outs, ref)),
                max(relative_errors(grads, ref_grads)))

    fwd_errs, bwd_errs = {}, {}
    for name, (k, (leaves, rest, cotangents)) in cases.items():
        ref = pooled_call(kc.render_composite_pooled_reference, leaves, rest, k)
        ref_grads = torch.autograd.grad(ref, leaves, cotangents)
        ref = [r.detach() for r in ref]
        n, rows = rest[0].shape[0] - 1, leaves[0].shape[0]
        for rays in (None, *kc.POOLED_RAYS_PER_WARP):
            with rays_per_warp(rays):
                key = f"{name}, {kc.pooled_rays_per_warp(n, rows)} a warp{'' if rays else ' (rule)'}"
                fwd_errs[key], bwd_errs[key] = errors(k, leaves, rest, cotangents, ref, ref_grads)

    # Starts shifted by one row: every ray but the first begins a sample late.
    step_name = next(iter(POOLED_SHAPES))
    k, (leaves, rest, cotangents) = cases[step_name]
    shifted = rest[0].clone()
    shifted[1:-1] += 1
    ref = pooled_call(kc.render_composite_pooled_reference, leaves, rest, k)
    moved = pooled_call(kc.render_composite_pooled_reference, leaves, (shifted, *rest[1:]), k)
    ref_grad = torch.autograd.grad(ref, leaves[0], cotangents)[0]
    moved_grad = torch.autograd.grad(moved, leaves[0], cotangents)[0]
    forward_moved = max((a - b).abs().max().item() for a, b in zip(moved, ref))
    grad_moved = ((moved_grad - ref_grad).abs().max() / ref_grad.abs().max()).item()
    print(f"composite_pooled inputs: starts shifted by one move the forward by {forward_moved:.3e} and the "
          f"densities' gradient by {grad_moved:.3e} of its max", flush=True)
    require(forward_moved >= SCAN_MARGIN * POOLED_BOUND and grad_moved >= SCAN_MARGIN * POOLED_GRAD_BOUND,
            "the pooled composite bounds would not catch starts shifted by one")

    # The forward and the background's gradient (summed by the last block in
    # a fixed order) bit-equal over two runs, at each main shape.
    unequal = []
    for name in POOLED_SHAPES:
        k, (leaves, rest, cotangents) = cases[name]
        plain = [v.detach() for v in leaves]
        fwd = [pooled_call(kc.composite_pooled_forward_cuda, plain, rest, k) for _ in range(2)]
        bg = [pooled_call(lambda *a: kc.composite_pooled_backward_cuda(*a, cotangents[0], None), plain, rest, k)[2]
              for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*fwd)):
            unequal.append(f"{name} forward")
        if not torch.equal(*bg):
            unequal.append(f"{name} background gradient")
        print(f"composite_pooled at {name}: the background's gradient over two runs {bg[0].tolist()} / "
              f"{bg[1].tolist()}", flush=True)
    print(f"composite_pooled: forward and background gradient bit-equal over two runs: {not unequal} {unequal}",
          flush=True)
    require(not unequal, f"two runs of the pooled composite kernels differ: {unequal}")

    # The train step's two calls (the points as extras without a
    # cotangent) and a budget-6 tile's, profiled: one kernel each, nothing
    # zeroed.
    def synced(call):  # the host ms of one synchronised call
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for name in list(POOLED_SHAPES)[:2]:
        k, (leaves, rest, cotangents) = cases[name]
        plain = [v.detach() for v in leaves]
        calls = {
            "forward": lambda: pooled_call(kc.composite_pooled_forward_cuda, plain, rest, k),
            "backward": lambda: pooled_call(
                lambda *a: kc.composite_pooled_backward_cuda(*a, cotangents[0], None, None, wanted=(True, True, False)),
                plain, rest, k),
        }
        for which, call in calls.items():
            synced(call)
            seen = profiled(lambda: synced(call), device, (kc.pooled_counter, kc.pooled_backward_counter))
            print(f"composite_pooled {which} at {name} as the train step calls it, profiled: "
                  f"{seen['kernels_launched']} kernel(s), {seen['memsets']} memset(s): "
                  f"{[t['name'] for t in seen['top']]}", flush=True)
            require(seen["kernels_launched"] == 1 and seen["memsets"] == 0,
                    f"the pooled composite {which} at {name} ran {seen['kernels_launched']} kernels and "
                    f"{seen['memsets']} memsets")

    # Times at the main shapes (graph replay): the kernels and the parent's in
    # turns A B B A, the floor of a launch at the kernels' grid, the bound of
    # this run's tensors (the rows the rays own are read, every gradient row
    # is written), the plain version and the dense route.
    timed = {}
    for name in POOLED_SHAPES:
        k, (leaves, rest, cotangents) = cases[name]
        plain = [v.detach() for v in leaves]
        starts, deltas, mask = rest
        n, used, c, rows = starts.shape[0] - 1, int(starts[-1]), plain[3].shape[1], plain[0].shape[0]
        route_forward, route_backward = dense_route(leaves, rest, k)
        graph = pooled_call(kc.render_composite_pooled_reference, leaves, rest, k)
        forward = lambda: pooled_call(kc.composite_pooled_forward_cuda, plain, rest, k)  # noqa: E731
        backward = lambda: pooled_call(  # noqa: E731
            lambda *a: kc.composite_pooled_backward_cuda(*a, *cotangents), plain, rest, k)
        turns = {"ms": [], "backward_ms": [], "parent_ms": [], "backward_parent_ms": []}
        for own in (True, False, False, True):
            with contextlib.nullcontext() if own else launching_pooled_from(parent):
                turns["ms" if own else "parent_ms"].append(graph_ms(forward, 50))
                turns["backward_ms" if own else "backward_parent_ms"].append(graph_ms(backward, 50))
        rays = kc.pooled_rays_per_warp(n, rows)
        ops = (SCAN_OPS + 2 * c) * used
        small = nbytes(starts, deltas, mask, plain[2]) + 4 * n * (4 + c)  # outputs, alphas, extras_out
        entry = dict(
            {key: sum(v) / len(v) for key, v in turns.items()}, turns=turns, rays_per_warp=rays,
            floor_ms=floor_ms(probes, kc.pooled_blocks(n), device),
            plain_ms=graph_ms(lambda: pooled_call(kc.render_composite_pooled_reference, plain, rest, k), 20),
            route_ms=graph_ms(route_forward, 50),
            backward_plain_ms=cuda_ms(lambda: torch.autograd.grad(graph, leaves, cotangents, retain_graph=True), 10),
            backward_route_ms=graph_ms(lambda: route_backward(*cotangents), 50),
        )
        entry["bound_ms"], entry["bound_by"] = bound(4 * used * (4 + c) + small, f32_ops=ops)
        entry["backward_bound_ms"], entry["backward_bound_by"] = bound(
            4 * used * (4 + c) + 4 * rows * (4 + c) + small, f32_ops=2 * ops)
        timed[name] = entry
        us = {key: [round(1e3 * v, 3) for v in vals] for key, vals in turns.items()}
        print(f"composite_pooled {name} ({used} rows used, {rays} a warp): forward {us['ms']} us against the parent's "
              f"{us['parent_ms']} (graph replay, turns A B B A), the launch floor at both grids "
              f"{1e3 * entry['floor_ms']:.2f} us, bound {1e3 * entry['bound_ms']:.2f} us "
              f"({entry['bound_by']}), the [N, K] route {1e3 * entry['route_ms']:.2f} us, plain "
              f"{1e3 * entry['plain_ms']:.2f} us; backward {us['backward_ms']} us against the parent's "
              f"{us['backward_parent_ms']}, bound {1e3 * entry['backward_bound_ms']:.2f} us "
              f"({entry['backward_bound_by']}), the [N, K] route {1e3 * entry['backward_route_ms']:.2f} us, eager "
              f"autograd {1e3 * entry['backward_plain_ms']:.1f} us", flush=True)

    step = timed[step_name]
    common = dict(route="cuda", source="learn_nerf_tpu_torch/csrc/composite.cu", library_ms=None)
    forward = dict(
        name="composite_pooled", **common,
        replaces="learn_nerf_tpu/occ_render.py:613-654 (XLA: the segmented scan, weights and segment_sum blends)",
        max_abs_err=max(fwd_errs.values()), ms=step["ms"], parent_ms=step["parent_ms"], floor_ms=step["floor_ms"],
        plain_ms=step["plain_ms"], route_ms=step["route_ms"], bound_ms=step["bound_ms"], bound_by=step["bound_by"],
        shapes={name: dict(ms=e["ms"], parent_ms=e["parent_ms"], floor_ms=e["floor_ms"],
                           rays_per_warp=e["rays_per_warp"], route_ms=e["route_ms"], bound_ms=e["bound_ms"])
                for name, e in timed.items()},
    )
    backward = dict(
        name="composite_pooled_backward", **common,
        replaces="the VJP of learn_nerf_tpu/occ_render.py:613-654 under jax.grad (XLA)",
        max_abs_err=max(bwd_errs.values()), ms=step["backward_ms"], parent_ms=step["backward_parent_ms"],
        floor_ms=step["floor_ms"], plain_ms=step["backward_plain_ms"], route_ms=step["backward_route_ms"],
        bound_ms=step["backward_bound_ms"], bound_by=step["backward_bound_by"],
        shapes={name: dict(ms=e["backward_ms"], parent_ms=e["backward_parent_ms"], floor_ms=e["floor_ms"],
                           rays_per_warp=e["rays_per_warp"], route_ms=e["backward_route_ms"],
                           bound_ms=e["backward_bound_ms"])
                for name, e in timed.items()},
    )
    for entry, errs, limit in ((forward, fwd_errs, POOLED_BOUND), (backward, bwd_errs, POOLED_GRAD_BOUND)):
        print(f"{entry['name']}: max err " + ", ".join(f"{a} {b:.2e}" for a, b in errs.items())
              + f" (bound {limit:g})", flush=True)
        require(entry["max_abs_err"] <= limit, f"{entry['name']} disagrees with its plain version")
    return [forward, backward]


def baked_vertices(pts, r, lo, hi):
    """The distinct lattice vertices the lookups of ``pts`` read."""
    from learn_nerf_tpu_torch.ops.hashgrid import corner_weights_and_coords

    coords, _ = corner_weights_and_coords(pts, r, lo, hi, smooth=False)
    return torch.unique(coords[..., 0] + r * (coords[..., 1] + r * coords[..., 2])).numel()


def twisted_lookup(grid, pts, r, pack, lo, hi, twist):
    """The plain lookup with one deliberate fault: the x and z corner bits
    swapped (a z-major corner order), or every row read one row on."""
    from learn_nerf_tpu_torch.ops.hashgrid import corner_weights_and_coords

    coords, weights = corner_weights_and_coords(pts, r, lo, hi, smooth=False)
    rows = coords[:, ::pack]
    idx = rows[..., 0] + r * (rows[..., 1] + r * rows[..., 2])
    if twist == "row + 1":
        idx = (idx + 1).clamp(max=r**3 - 1)
    else:
        weights = weights[:, [0, 4, 2, 6, 1, 5, 3, 7]]
    feats = grid.index_select(0, idx.reshape(-1)).float().view(len(pts), 8, -1)
    return (weights[..., None] * feats).sum(dim=-2)


def baked_edge_points(rng, lo, hi, r, device):
    """Points on the bbox's faces, beyond them, on lattice vertices, and the
    last 1, 31, 32, 33 and 2^20 - 37 of a random draw."""
    lo_t, hi_t = np.array(lo, np.float32), np.array(hi, np.float32)
    inside = rng.uniform(lo_t, hi_t, (4096, 3)).astype(np.float32)
    faces = inside.copy()
    axis = rng.randint(0, 3, len(faces))
    faces[np.arange(len(faces)), axis] = np.where(rng.rand(len(faces)) < 0.5, lo_t[axis], hi_t[axis])
    outside = inside + np.sign(inside) * rng.uniform(0.0, 0.5, inside.shape).astype(np.float32)
    ids = rng.randint(0, r, (4096, 3))
    vertices = (lo_t + ids.astype(np.float32) / (r - 1) * (hi_t - lo_t)).astype(np.float32)
    draw = rng.uniform(-0.75, 0.75, (BAKED_POINTS, 3)).astype(np.float32)
    cases = {"bbox faces": faces, "outside the bbox": outside, "lattice vertices": vertices}
    cases.update({f"{n} points": draw[-n:] for n in BAKED_EDGE_POINTS})
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in cases.items()}


def check_baked_kernel(root, device, rng, parent, probes):
    """The baked lookup at the README's ``--baked 384``: the serving scene's
    fine NGP tree baked to 384^3 in bf16 on the card, then the kernel against
    its plain version at packs 1, 2, 4 and 8 on 2^20 random points and on
    2^20 points along rays, on an f32 table, on the bbox's faces and beyond,
    on lattice vertices, at r = 2 and 3 and at the edges of its thread grid;
    every pack bit-equal to pack 1 and to the kernel it replaced (``parent``,
    a ``baked_ablations`` entry point); timed beside that kernel, beside
    ``grid_sample`` and beside the card's rate for random rows (``probes``)."""
    from learn_nerf_tpu_torch import baked
    from learn_nerf_tpu_torch.checkpoint import load_params_pickle, ngp_params_from_flax
    from learn_nerf_tpu_torch.kernels import baked as kbaked
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.models import InstantNGPModel
    from learn_nerf_tpu_torch.scripts.baked_ablations import frame_tiles, lookup_with, probe_ms, probe_shapes

    grids, tables = fine_schedule(FINE_LEVELS)
    model = InstantNGPModel(table_sizes=tables, grid_sizes=grids, bbox_min=(-0.7,) * 3, bbox_max=(0.7,) * 3)
    model.load_state_dict(ngp_params_from_flax(load_params_pickle(str(root / "ngp.pkl"))["fine"]))
    model = model.to(device).eval()
    r = BAKE_RESOLUTION
    encodes = ke.counter.launches
    t0 = time.perf_counter()
    table = baked.bake_instant_ngp(model, r, torch.bfloat16, pack=1).grid
    bake_s = time.perf_counter() - t0
    require(ke.counter.launches > encodes and torch.isfinite(table).all().item(),
            "the bake did not run the encode kernel, or its table is not finite")
    del model
    lo, hi = (-0.7,) * 3, (0.7,) * 3
    lookup = lambda grid, pts, p, res=r: kbaked.launch_lookup(grid, pts, res, p, lo, hi)
    replaced = lambda grid, pts, p, res=r: lookup_with(parent, grid, pts, res, p, lo, hi)
    plain = lambda grid, pts, p, res=r: kbaked.baked_lookup_reference(grid, pts, res, p, lo, hi)

    x = torch.from_numpy(rng.uniform(-0.75, 0.75, (BAKED_POINTS, 3)).astype(np.float32)).to(device)
    ray_x = torch.from_numpy(ray_points(rng, BAKED_POINTS // 128, 128, 0.01, -0.7, 0.7)).to(device)
    inputs = {"random": x, "along rays": ray_x, **baked_edge_points(rng, lo, hi, r, device)}
    # The main path's other shapes: a baked pooled frame tile's pool (its
    # unused rows all one point) and a fixed-K tile.
    timed = {"random": x, "along rays": ray_x,
             **{name: torch.from_numpy(pts).to(device) for name, pts in frame_tiles(rng).items()}}
    small = {res: torch.from_numpy(rng.uniform(-1, 1, (res**3, 16)).astype(np.float32)).to(device).to(torch.bfloat16)
             for res in (2, 3)}
    base = {name: lookup(table, pts, 1) for name, pts in inputs.items()}
    base.update({f"r = {res}": lookup(t, x[:4096], 1, res) for res, t in small.items()})
    errs, unequal, unequal_parent, packs, pack_s = {}, [], [], {}, {}
    # The least bytes at any pack: one copy of each distinct lattice vertex
    # a point needs (16 features each), the points and the output.  A
    # pack-p table holds each vertex in up to p rows, of which a lookup
    # needs one.
    least = lambda pts: baked_vertices(pts, r, lo, hi) * 16 * table.element_size() + nbytes(pts) + len(pts) * 16 * 4
    bounds = {name: bound(least(pts))[0] for name, pts in timed.items()}
    for p in baked.PACKS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = table if p == 1 else baked.pack_baked_grid(table, r, p)
        torch.cuda.synchronize()
        pack_s[p] = time.perf_counter() - t0
        cases = [(name, grid, pts, r) for name, pts in inputs.items()]
        cases += [(f"r = {res}", baked.pack_baked_grid(t, res, p), x[:4096], res) for res, t in small.items()]
        for name, g, pts, res in cases:
            out = lookup(g, pts, p, res)
            torch.cuda.synchronize()
            require(torch.isfinite(out).all().item() and out.shape == (len(pts), 16),
                    f"baked_lookup (pack {p}, {name}): non-finite values or the wrong shape")
            errs[f"pack {p}, {name}"] = (out - plain(g, pts, p, res)).abs().max().item()
            if not torch.equal(out, base[name]):
                unequal.append(f"pack {p}, {name}")
            if not torch.equal(out, replaced(g, pts, p, res)):
                unequal_parent.append(f"pack {p}, {name}")
            del out
        # Each shape by graph replay, the kernel and the one it replaced in
        # turns (A B B A); then the card's rate for the random runs that 2^20
        # points read from this table (its rows apart, and as the table holds
        # them: the rows of corners c and c + 4 side by side), over its bytes.
        times = {name: ([], []) for name in timed}
        for turn in (0, 1, 1, 0):
            for name, pts in timed.items():
                fn = (lambda: lookup(grid, pts, p)) if turn == 0 else (lambda: replaced(grid, pts, p))
                times[name][turn].append(graph_ms(fn, 20 if len(pts) >= BAKED_POINTS else 50))
        rates = {pattern: probe_ms(probes, grid, nbytes(grid), run, BAKED_POINTS * per_point)
                 for pattern, (run, per_point) in probe_shapes(grid.dtype, p).items()}
        packs[p] = dict(
            ms={name: sum(t[0]) / 2 for name, t in times.items()},
            parent_ms={name: sum(t[1]) / 2 for name, t in times.items()},
            bound_ms=bounds, card_rate_ms=rates["row pairs"], card_rate_rows_apart_ms=rates["rows"],
        )
        if p == BAKED_PACK:
            run, per_point = probe_shapes(grid.dtype, p)["row pairs"]
            small_rate_ms = probe_ms(probes, grid, 32 << 20, run, BAKED_POINTS * per_point)
            plain_ms = cuda_ms(lambda: plain(grid, x, p), 3)
        del grid, cases
        torch.cuda.empty_cache()

    # An f32 table of the same values gives the same bits (bf16 -> f32 is
    # exact and the sums are the same).
    wide = table.float()
    out = lookup(wide, x, 1)
    torch.cuda.synchronize()
    errs["f32 table, pack 1"] = (out - plain(wide, x, 1)).abs().max().item()
    if not torch.equal(out, base["random"]):
        unequal.append("f32 table, pack 1")
    if not torch.equal(out, replaced(wide, x, 1)):
        unequal_parent.append("f32 table, pack 1")
    f32_ms = [graph_ms(lambda: lookup(wide, x, 1), 20) for _ in range(2)]
    f32_parent_ms = [graph_ms(lambda: replaced(wide, x, 1), 20) for _ in range(2)]
    run, per_point = probe_shapes(wide.dtype, 1)["row pairs"]
    f32_rate_ms = probe_ms(probes, wide, nbytes(wide), run, BAKED_POINTS * per_point)
    del wide, out
    torch.cuda.empty_cache()

    ref = plain(table, x, 1)
    moves = {twist: (twisted_lookup(table, x, r, 1, lo, hi, twist) - ref).abs().max().item()
             for twist in ("corner order", "row + 1")}
    # The library call for the same function: grid_sample on the table as a
    # [1, F, z, y, x] volume, the points scaled to [-1, 1].  It takes the
    # volume and the points in one dtype: in f32 it computes this lookup
    # (up to its own rounding of the positions); on the bf16 volume the
    # points round to bf16 too, a coarser function, timed for comparison.
    volume = table.view(r, r, r, 16).permute(3, 0, 1, 2).contiguous()[None]
    coords = ((x - torch.tensor(lo, device=device)) / (hi[0] - lo[0]) * 2 - 1).view(1, -1, 1, 1, 3)
    sample = lambda v, c: torch.nn.functional.grid_sample(v, c, mode="bilinear", padding_mode="border",
                                                          align_corners=True)
    bf16_coords = coords.to(torch.bfloat16)
    library_bf16_ms = cuda_ms(lambda: sample(volume, bf16_coords), 10)
    volume = volume.float()
    library_err = (sample(volume, coords).view(16, -1).t() - ref).abs().max().item()
    library_ms = cuda_ms(lambda: sample(volume, coords), 10)
    del volume, coords, bf16_coords, ref
    torch.cuda.empty_cache()

    main = packs[BAKED_PACK]
    result = dict(
        name="baked_lookup", route="cuda", source="learn_nerf_tpu_torch/csrc/baked.cu",
        replaces="learn_nerf_tpu/baked.py:109-162 (XLA)", max_abs_err=max(errs.values()),
        ms=main["ms"]["random"], ms_rays=main["ms"]["along rays"], parent_ms=main["parent_ms"]["random"],
        plain_ms=plain_ms, bound_ms=main["bound_ms"]["random"], bound_by="bytes", library_ms=library_ms,
        card_rate_ms=main["card_rate_ms"],
        shapes={**{f"pack {p}": e for p, e in packs.items()},
                "f32 pack 1 random": dict(ms=f32_ms, parent_ms=f32_parent_ms, card_rate_ms=f32_rate_ms)},
    )
    shares = lambda e, key: ", ".join(
        f"{name} {e['ms'][name]:.4f} ms (replaced kernel {e['parent_ms'][name]:.4f}; {100 * e[key][name] / e['ms'][name]:.1f} % of its bound {e[key][name]:.4f})"
        for name in timed)
    print(f"baked_lookup at {r}^3 x 16 bf16 (bake {bake_s:.3f} s on the card; packing "
          + ", ".join(f"{p}: {s:.3f} s" for p, s in pack_s.items() if p > 1)
          + f"): max abs err {result['max_abs_err']:.3e} (bound {BAKED_BOUND:g}) over "
          f"{len(errs)} cases (packs 1-8 x random, along rays, bbox faces, outside, vertices, "
          f"{BAKED_EDGE_POINTS} points, r = 2 and 3; f32 table); every pack bit-equal to pack 1: "
          f"{not unequal} {unequal}; a z-major corner order moves the output by {moves['corner order']:.3e}, "
          f"a row offset by one by {moves['row + 1']:.3e}; "
          + f"bit-equal to the kernel it replaced: {not unequal_parent} {unequal_parent}; "
          + "; ".join(f"pack {p}: {shares(e, 'bound_ms')}; the card's rate for the random runs of 2^20 points "
                      f"in this table: {e['card_rate_ms']:.4f} ms as the table holds them (the kernel at "
                      f"{100 * e['card_rate_ms'] / e['ms']['random']:.1f} % of it), {e['card_rate_rows_apart_ms']:.4f} "
                      f"ms with the rows apart" for p, e in packs.items())
          + f"; the same runs at pack {BAKED_PACK} from 32 MB (in L2): {small_rate_ms:.4f} ms"
          + f"; f32 table pack 1 {f32_ms} ms (replaced kernel {f32_parent_ms}; the card's rate {f32_rate_ms:.4f} ms)"
          + f"; plain (pack {BAKED_PACK}) {plain_ms:.3f} ms; grid_sample "
          f"{library_ms:.4f} ms on the f32 volume (differs from the plain lookup by {library_err:.3e}), "
          f"{library_bf16_ms:.4f} ms on the bf16 volume with bf16 points", flush=True)
    require(result["max_abs_err"] <= BAKED_BOUND, "baked_lookup disagrees with its plain version")
    require(not unequal, f"baked_lookup differs from pack 1 in {unequal}")
    require(not unequal_parent, f"baked_lookup differs from the kernel it replaced in {unequal_parent}")
    require(min(moves.values()) >= SCAN_MARGIN * BAKED_BOUND,
            f"baked_lookup's bound {BAKED_BOUND:g} would not catch a wrong corner order or row")
    del table
    torch.cuda.empty_cache()
    return result


def build_selection_libraries():
    """``{name: library}``: the pair as first written
    (``csrc/ablations/selection_parent.cu``) and csrc/selection.cu alone
    with each of SELECTION_FAULTS, all built at once."""
    from learn_nerf_tpu_torch.scripts import selection_ablations

    faults = {name: [("selection.cu", old, new)] for name, (old, new) in SELECTION_FAULTS.items()}
    return selection_ablations.build_selection_libraries([selection_ablations.PARENT, *faults], faults)


def bits_of(v):
    return v.view(torch.int32) if v.dtype == torch.float32 else v


def rays_that_differ(a, b):
    """``[N]`` bool: the rays where two selections differ in any bit."""
    diff = (a.mask != b.mask) | (a.count != b.count) | (bits_of(a.dt) != bits_of(b.dt))[:, 0]
    diff |= ((bits_of(a.ts) != bits_of(b.ts)) | (a.sample_mask != b.sample_mask)).any(dim=1)
    if a.points is not None:
        diff |= (bits_of(a.points) != bits_of(b.points)).any(dim=2).any(dim=1)
    return diff


def prune_gaps(rays, u, grid, state, span, eps):
    """Per ray, the least relative distance ``|exp(-acc_prev) / eps - 1|``
    over its occupied candidates under the plain prune's scan (inf where it
    has none), the scan's own rounding: the largest ``|acc_prev - acc_prev
    in f64|`` where ``exp(-acc_prev)`` is within a factor 4 of eps (the
    relative error it puts on ``exp(-acc_prev)`` there), and the occupied
    candidates before the prune."""
    from learn_nerf_tpu_torch.kernels import selection as ksel

    cand_ts, occ, dt, _ = ksel.select_candidates_reference(rays, u, grid, state, 1e-3, 0.0, span)
    d = state.densities[grid.cell_indices(rays[:, None, 0] + rays[:, None, 1] * cand_ts[..., None])]
    approx = torch.where(occ, d, 0.0) * dt
    acc = torch.cumsum(approx, dim=1) - approx
    acc64 = torch.cumsum(approx.double(), dim=1) - approx.double()
    transmittance = torch.exp(-acc)
    gap = torch.where(occ, (transmittance / eps - 1.0).abs(), float("inf")).amin(dim=1)
    near = occ & (transmittance > eps / 4) & (transmittance < 4 * eps)
    rounding = torch.where(near, (acc.double() - acc64).abs(), 0.0).max().item()
    return gap, rounding, int(occ.sum())


def plain_device_ms(call, device, tries=3):
    """Device ms (busy time under torch.profiler) and kernels of one call of
    a plain version, profiled again while the trace holds no kernel."""
    from learn_nerf_tpu_torch.scripts.profile_render import profile_call

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed()
    for _ in range(tries):
        seen = profile_call(timed, device)
        if seen["kernels_launched"]:
            break
    return seen["device_ms"], seen["kernels_launched"]


def check_selection_kernels(device, views, probes, libs):
    """select_strided_kernel and pool_pack_kernel against their plain
    versions and against the pair they replaced (csrc/ablations/
    selection_parent.cu, bit for bit, the prune included) on the card (see
    SELECT_RAYS above), each check shown to catch a deliberate fault
    (SELECTION_FAULTS, STALE_WORDS), a pooled tile's selection and pack
    profiled to two kernels and no memset, both kernels timed by graph
    replay in turns A B B A beside the replaced pair (the pack beside the
    parent's clamp, cumsum and pack) and the plain route's device time; their
    kernel-line entries."""
    from unittest import mock

    from learn_nerf_tpu_torch.acceleration import OccupancyGrid, OccupancyGridState
    from learn_nerf_tpu_torch.kernels import selection as ksel
    from learn_nerf_tpu_torch.occ_render import OccupancyRenderer
    from learn_nerf_tpu_torch.scripts.frame_matrix import frame_view, shell_grid_state
    from learn_nerf_tpu_torch.scripts.hashgrid_ablations import sector_us
    from learn_nerf_tpu_torch.scripts.selection_ablations import (PARENT, ball_densities, launch_parent_pack,
                                                                   launch_parent_select, selection_grids,
                                                                   selection_rays)

    rng = np.random.RandomState(SEED + 19)
    grid, states = selection_grids(device)
    shell_grid = OccupancyGrid(bbox_min=(-1.0,) * 3, bbox_max=(1.0,) * 3, resolution=128)
    shell = shell_grid_state(shell_grid, device)
    padded_grid = OccupancyGrid(bbox_min=grid.bbox_min, bbox_max=grid.bbox_max, resolution=126)
    padded = OccupancyGridState(densities=torch.from_numpy(ball_densities(126, (0.25, -0.1, -0.3), 0.3)).to(device),
                                step=16)
    step_rays = selection_rays(rng, SELECT_RAYS, device=device)
    tile_rays = torch.from_numpy(views[0].bare_rays(128, 64)).to(device)  # a served tile of 8192 rays
    shell_rays = torch.from_numpy(frame_view().bare_rays(800, 800)[320_000:328_192]).to(device)
    uniforms = lambda n, c: torch.from_numpy(rng.rand(n, c).astype(np.float32)).to(device)  # noqa: E731
    u_step, u_tile = uniforms(SELECT_RAYS, SELECT_CANDIDATES), uniforms(8192, SELECT_CANDIDATES)
    span_renderer = OccupancyRenderer(model=None, grid=grid, bbox_min=grid.bbox_min, bbox_max=grid.bbox_max,
                                      candidates=96, samples=SELECT_SAMPLES, span_candidates=64)
    span = span_renderer._span(tile_rays, states["ball"], None)
    cases = {  # name: (rays, u, grid, state, K, eps, span)
        "step, ball grid": (step_rays, u_step, grid, states["ball"], SELECT_SAMPLES, 0.0, None),
        "step, off-centre ball": (step_rays, u_step, grid, states["off-centre ball"], SELECT_SAMPLES, 0.0, None),
        "step, warmup grid": (step_rays, u_step, grid, states["warmup"], SELECT_SAMPLES, 0.0, None),
        "step, opaque off-centre ball, eps 1e-2": (step_rays, u_step, grid, states["opaque off-centre ball"],
                                                   SELECT_SAMPLES, PRUNE_EPS, None),
        "step, 126^3 grid (padded words)": (step_rays, u_step, padded_grid, padded, SELECT_SAMPLES, 0.0, None),
        "tile, ball grid": (tile_rays, u_tile, grid, states["ball"], SELECT_SAMPLES, 0.0, None),
        "tile, opaque ball, eps 1e-2": (tile_rays, u_tile, grid, states["opaque ball"], SELECT_SAMPLES, PRUNE_EPS,
                                        None),
        "tile, shell grid, eps 1e-2": (shell_rays, u_tile, shell_grid, shell, SELECT_SAMPLES, PRUNE_EPS, None),
        "tile, span 64, 96 candidates": (tile_rays, u_tile[:, :96].contiguous(), grid, states["ball"],
                                         SELECT_SAMPLES, 0.0, span),
        "tile, span 64, 96 candidates, eps 1e-2": (tile_rays, u_tile[:, :96].contiguous(), grid,
                                                   states["opaque ball"], SELECT_SAMPLES, PRUNE_EPS, span),
    }
    for n, c, k in SELECT_EDGES:
        cases[f"edge: {n} rays x {c} candidates -> {k}"] = (
            step_rays[:n] if n <= SELECT_RAYS else selection_rays(rng, n, device=device), uniforms(n, c), grid,
            states["ball"], k, 0.0, None)
    parent = libs[PARENT]

    def run(case, lib=None):
        rays, u, g, state, k, eps, sp = case
        return ksel.launch_select_strided(rays, u, g, state, k, 1e-3, eps, sp, True, lib=lib)

    def run_parent(case):
        rays, u, g, state, k, eps, sp = case
        return launch_parent_select(parent, rays, u, g, state, k, 1e-3, eps, sp, True)

    selections, wants, gaps = {}, {}, {}

    def fails(name, got):
        """The check each case must pass: bit for bit with the prune off,
        decisions outside PRUNE_MARGIN with it on."""
        differ = rays_that_differ(got, wants[name])
        return bool(differ.any()) if name not in gaps else bool((gaps[name][differ] > PRUNE_MARGIN).any())

    unequal, unequal_parent, pruned, roundings, counts = [], [], {}, [], {}
    for name, case in cases.items():
        rays, u, g, state, k, eps, sp = case
        got = selections[name] = run(case)
        wants[name] = ksel.select_strided_reference(rays, u, g, state, k, 1e-3, eps, sp, True)
        counts[name] = (int(got.count.min()), int(got.count.max()), int(got.mask.sum()))
        if rays_that_differ(got, run_parent(case)).any():
            unequal_parent.append(name)
        if eps > 0.0:
            gaps[name], rounding, occupied = prune_gaps(rays, u, g, state, sp, eps)
            roundings.append(rounding)
            differ = rays_that_differ(got, wants[name])
            pruned[name] = (occupied - int(got.count.sum()), int(differ.sum()),
                            float(gaps[name][differ].max()) if differ.any() else 0.0,
                            int((gaps[name] <= PRUNE_MARGIN).sum()))
        if fails(name, got):
            unequal.append(name)
    step = selections["step, ball grid"]
    require(int(selections["step, warmup grid"].count.max()) == SELECT_CANDIDATES,
            "the warmup grid did not occupy every candidate")
    require((step.count > 0).any() and (step.count[step.mask] == 0).any() and not step.mask.all(),
            "the step's rays do not hold occupied, empty and missed rays")

    # The pack, bit for bit, at budgets that hold and that drop, and at the
    # edges of its chunks and blocks; equal to the plain pack of the sample
    # mask too.
    tile = selections["tile, opaque ball, eps 1e-2"]
    packs = {name: ((step_rays, step) if n == SELECT_RAYS else (tile_rays, tile)) + (n * per_ray,)
             for name, (n, per_ray) in PACK_BUDGETS.items()}
    for n, first, per_ray in PACK_EDGES:
        rays, sel = (step_rays, step) if first + n <= SELECT_RAYS else (tile_rays, tile)
        cut = slice(first, first + n)
        packs[f"edge: {n} rays from ray {first}, {per_ray} a ray"] = (
            rays[cut], ksel.Selection(*(v[cut] for v in sel[:5]), None), n * per_ray)
    unequal_packs, dropped = [], {}

    def pack_fails(name, got):
        rays, sel, budget = packs[name]
        want = ksel.pack_pool_from_counts_reference(rays, sel.ts, sel.count, budget)
        by_mask = ksel.pack_pool_reference(rays, sel.ts, sel.sample_mask, budget)
        return not all(torch.equal(bits_of(a), bits_of(b)) and torch.equal(bits_of(a), bits_of(c))
                       for a, b, c in zip(got, want, by_mask))

    for name, (rays, sel, budget) in packs.items():
        got = ksel.launch_pool_pack(rays, sel.ts, sel.count, budget)
        dropped[name] = (int(got.selected), int(got.dropped))
        parent_pool = launch_parent_pack(parent, rays, sel.ts, sel.count, budget)
        if pack_fails(name, got) or not all(torch.equal(bits_of(a), bits_of(b)) for a, b in zip(got, parent_pool)):
            unequal_packs.append(name)
    require(dropped["step pool, budget 4 a ray (drops)"][1] > 0 and dropped["step pool, budget 32 a ray"][1] == 0,
            f"the pack's budgets do not both drop and hold: {dropped}")

    # Each deliberate fault must be caught by the same checks.
    caught = {}
    fault_cases = {"a rank off by one": "step, ball grid",
                   "x and z swapped in the cell index": "step, opaque off-centre ball, eps 1e-2",
                   "x and z swapped in a word's bit index": "step, off-centre ball"}
    for fault, lib in libs.items():
        if fault in fault_cases:
            caught[fault] = fails(fault_cases[fault], run(cases[fault_cases[fault]], lib))
        elif fault != PARENT:  # the pack's, on every pool; the outputs filled beforehand
            caught[fault] = False
            for name, (rays, sel, budget) in packs.items():
                out = ksel.Pool(*(torch.full_like(v, -1) for v in ksel.launch_pool_pack(rays, sel.ts, sel.count,
                                                                                        budget)))
                got = ksel.launch_pool_pack(rays, sel.ts, sel.count, budget, out=out, lib=lib)
                caught[fault] = caught[fault] or pack_fails(name, got)
    ball_words = grid.occupancy_words(states["ball"])
    with mock.patch.object(OccupancyGrid, "occupancy_words", lambda self, state: ball_words):
        caught[STALE_WORDS] = fails("step, off-centre ball", run(cases["step, off-centre ball"]))

    # A pooled tile as the renderer runs it: the selection and the pack, two
    # kernels, no clamp or scan between them and no memset.
    tile_renderer = OccupancyRenderer(model=None, grid=grid, bbox_min=grid.bbox_min, bbox_max=grid.bbox_max,
                                      candidates=SELECT_CANDIDATES, samples=SELECT_SAMPLES)

    def pooled_tile():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sel = tile_renderer._select(tile_rays, states["opaque ball"], PRUNE_EPS, u_tile, None)
        ksel.pool_pack(tile_rays, sel, 8192 * 6)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    pooled_tile()
    seen = profiled(pooled_tile, device, (ksel.counter, ksel.pack_counter))
    tile_kernels = (seen["kernels_launched"], seen["memsets"], sorted(seen["port_kernels"] or {}))

    # Times: the step's selection (with points, as the dense step takes it),
    # a served tile's (eps 1e-2), the step's pool and a tile's, each in turns
    # beside the replaced pair.
    timed = {"step 4096 x 192 -> 32": "step, ball grid",
             "tile 8192 x 192 -> 32, eps 1e-2": "tile, opaque ball, eps 1e-2"}
    select_times = {}
    for name, case_name in timed.items():
        case = cases[case_name]
        rays, u, g, state, k, eps, sp = case
        turns = {"ms": [], "parent_ms": []}
        for own in (True, False, False, True):
            turns["ms" if own else "parent_ms"].append(graph_ms((lambda: run(case)) if own else
                                                                (lambda: run_parent(case)), 50))
        plain_ms, plain_kernels = plain_device_ms(
            lambda: ksel.select_strided_reference(rays, u, g, state, k, 1e-3, eps, sp, True), device)
        n, c = u.shape
        out = selections[case_name]
        words = g.occupancy_words(state)
        # u, the rays and the outputs: the grid's reads depend on the data
        # and stay in L2 (a step touches a few % of its cells).
        bound_ms, bound_by = bound(nbytes(u, rays, *[v for v in out if v is not None]))
        # The card's rate for the test's n * c random reads: the words' 8-byte
        # rows over their bytes (with the prune, the densities', as the
        # parent's).
        select_times[name] = dict(
            {key: sum(v) / len(v) for key, v in turns.items()}, turns=turns, plain_ms=plain_ms,
            plain_kernels=plain_kernels, bound_ms=bound_ms, bound_by=bound_by,
            card_rate_ms=sector_us(probes, words.numel() // 2 if eps == 0.0 else 1 << 20, n * c, device) / 1e3,
            parent_card_rate_ms=sector_us(probes, 1 << 20, n * c, device) / 1e3)
    pack_times = {}
    for name in ("step pool, budget 32 a ray", "tile 8192 x 6"):
        rays, sel, budget = packs[name]
        out = ksel.launch_pool_pack(rays, sel.ts, sel.count, budget)
        turns = {"ms": [], "parent_ms": []}
        for own in (True, False, False, True):
            turns["ms" if own else "parent_ms"].append(graph_ms(
                (lambda: ksel.launch_pool_pack(rays, sel.ts, sel.count, budget)) if own else
                (lambda: launch_parent_pack(parent, rays, sel.ts, sel.count, budget)), 50))
        plain_ms, plain_kernels = plain_device_ms(
            lambda: ksel.pack_pool_from_counts_reference(rays, sel.ts, sel.count, budget), device)
        bound_ms, bound_by = bound(pack_bytes(rays, sel, budget, out))
        pack_times[name] = dict({key: sum(v) / len(v) for key, v in turns.items()}, turns=turns, plain_ms=plain_ms,
                                plain_kernels=plain_kernels, bound_ms=bound_ms, bound_by=bound_by)

    us = lambda times: {name: {k: [round(1e3 * v, 3) for v in vals] for k, vals in t["turns"].items()}  # noqa: E731
                        for name, t in times.items()}
    print(f"select_strided: {len(cases)} cases, rays that differ from the plain version {unequal or 'none'}, from the "
          f"replaced kernel {unequal_parent or 'none'}; (min c, max c, rays in the box) {counts}; with the prune "
          f"(eps {PRUNE_EPS:g}): (candidates pruned, rays that differ, the largest of their least gaps, rays with a "
          f"candidate within the margin) {pruned} (margin {PRUNE_MARGIN:g}; the f32 scan's own rounding of acc_prev "
          f"{max(roundings):.3e}); graph replay, turns A B B A, us {us(select_times)}; times {select_times}",
          flush=True)
    print(f"pool_pack: {len(packs)} pools, (selected, dropped) {dropped}, unequal {unequal_packs or 'none'}; "
          f"a pooled tile's selection and pack profiled: (kernels, memsets, the port's) {tile_kernels}; graph "
          f"replay, turns A B B A (the replaced clamp, cumsum and pack), us {us(pack_times)}; times {pack_times}; "
          f"faults caught {caught}", flush=True)
    require(not unequal, f"select_strided disagrees with its plain version in {unequal}")
    require(not unequal_parent, f"select_strided differs from the kernel it replaced in {unequal_parent}")
    require(not unequal_packs, f"pool_pack disagrees with its plain version or the kernel it replaced in "
            f"{unequal_packs}")
    require(all(caught.values()) and len(caught) == len(SELECTION_FAULTS) + 1, f"a fault went uncaught: {caught}")
    require(tile_kernels == (2, 0, ["pool_pack", "select_strided"]),
            f"a pooled tile's selection and pack launched more than the two kernels: {tile_kernels}")
    require(2 * max(roundings) <= PRUNE_MARGIN, f"the prune margin {PRUNE_MARGIN:g} is under twice the scan's "
            f"rounding {max(roundings):.3e}")
    require(pruned["tile, opaque ball, eps 1e-2"][0] > 0 and pruned["step, opaque off-centre ball, eps 1e-2"][0] > 0,
            "the prune cut nothing")
    first = select_times["step 4096 x 192 -> 32"]
    step_pack = pack_times["step pool, budget 32 a ray"]
    return [
        dict(name="select_strided", route="cuda", source="learn_nerf_tpu_torch/csrc/selection.cu",
             replaces="learn_nerf_tpu/occ_render.py:279-327 with acceleration.py:114-131 and :389-428, "
                      "ops/sampling.py:31, ops/geometry.py:21-62 (XLA)",
             max_abs_err=0.0, ms=first["ms"], parent_ms=first["parent_ms"], plain_ms=first["plain_ms"],
             bound_ms=first["bound_ms"], bound_by=first["bound_by"], library_ms=None,
             card_rate_ms=first["card_rate_ms"], shapes=select_times),
        dict(name="pool_pack", route="cuda", source="learn_nerf_tpu_torch/csrc/selection.cu",
             replaces="learn_nerf_tpu/occ_render.py:586-606 (XLA: the slot cumsum, scatter and gathers)",
             max_abs_err=0.0, ms=step_pack["ms"], parent_ms=step_pack["parent_ms"], plain_ms=step_pack["plain_ms"],
             bound_ms=step_pack["bound_ms"], bound_by=step_pack["bound_by"], library_ms=None, shapes=pack_times),
    ]


@contextlib.contextmanager
def plain_routes():
    """Inside, the port takes its plain versions for CUDA tensors too (the
    encoding, the composite of both renderers, which call it from
    ``render.composite_samples``, the pooled composite, the selection and
    the pack): the card's own plain route, for ``check_train_step``."""
    from learn_nerf_tpu_torch import render
    from learn_nerf_tpu_torch.kernels import composite as kc
    from learn_nerf_tpu_torch.kernels import hashgrid_dx as kd
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.ops import hashgrid as hg

    from learn_nerf_tpu_torch import occ_render
    from learn_nerf_tpu_torch.kernels import selection as ksel

    saved = (ke._encode_on_card, kd._dx_on_card, render.render_composite, occ_render.render_composite_pooled,
             occ_render.select_strided, occ_render.pool_pack)
    (ke._encode_on_card, kd._dx_on_card, render.render_composite, occ_render.render_composite_pooled,
     occ_render.select_strided, occ_render.pool_pack) = (
        hg.hash_grid_encode_reference, hg.hash_grid_encode_dx_reference, kc.render_composite_reference,
        kc.render_composite_pooled_reference, lambda *args, words=None: ksel.select_strided_reference(*args),
        lambda rays, sel, budget: ksel.pack_pool_from_counts_reference(rays, sel.ts, sel.count, budget))
    try:
        yield
    finally:
        (ke._encode_on_card, kd._dx_on_card, render.render_composite, occ_render.render_composite_pooled,
         occ_render.select_strided, occ_render.pool_pack) = saved


def check_train_step(root, device, rng):
    """One full-width train step's loss and gradients by the kernel route on
    the card, against the plain route on the card (the same points to the
    bit) and against the plain route on the CPU, from the same weights,
    batch, uniforms and grid.

    The CPU's sample positions differ from the card's in the last place
    (4.8e-7 at t ~ 2), which the finest lattice (cells of 7e-4) turns into
    weights that differ by 1e-3, and a ReLU that flips for one point moves
    the rows that point alone touches by percents of the largest gradient.
    So table gradients are held by their L2 norm, relative, and every other
    gradient by its max; the bounds against the CPU are two to four times
    what an H100 measured (2.7e-3 and 1.8e-4); against the card's own plain
    route both measured 3e-7.

    The pooled step (the pool at the batch's auto budget) is held the same
    way, and at a budget that holds every survivor to the dense step on the
    card (its loss within POOLED_DENSE_BOUND, no gradient missing)."""
    from learn_nerf_tpu_torch.checkpoint import load_params_pickle, ngp_params_from_flax
    from learn_nerf_tpu_torch.data.dataset import load_dataset
    from learn_nerf_tpu_torch.kernels import composite as kc
    from learn_nerf_tpu_torch.kernels import hashgrid_backward as kb
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.kernels import selection as ksel
    from learn_nerf_tpu_torch.models import InstantNGPModel
    from learn_nerf_tpu_torch.train import OccupancyTrainLoop

    params = load_params_pickle(str(root / "ngp.pkl"))
    rays = np.concatenate([v.rays() for v in load_dataset(str(root / "train")).views])
    batch = torch.from_numpy(rays[rng.permutation(len(rays))[:TRAIN_RAYS]])
    u = torch.from_numpy(rng.rand(TRAIN_RAYS, 192).astype(np.float32))
    draws = (torch.from_numpy(rng.rand(128, 3).astype(np.float32)),
             torch.from_numpy(rng.randn(128, 3).astype(np.float32)))
    grids, sizes = fine_schedule(FINE_LEVELS)

    def step(dev, budget=None):
        model = InstantNGPModel(table_sizes=sizes, grid_sizes=grids, bbox_min=(-0.7,) * 3, bbox_max=(0.7,) * 3)
        model.load_state_dict(ngp_params_from_flax(params["fine"]))
        loop = OccupancyTrainLoop(model, lr=1e-2, bbox_min=(-0.7,) * 3, bbox_max=(0.7,) * 3,
                                  density_penalty=1e-3, device=dev)
        loop.grid_state = loop.grid.state_from_checkpoint(params, dev)
        total, values = loop._loss(loop.renderer, loop.background, batch.to(dev), budget, u=u.to(dev),
                                   density_draws=tuple(d.to(dev) for d in draws))
        total.backward()
        grads = {name: p.grad.cpu() for name, p in loop.model.named_parameters()}
        grads["background"] = loop.background.grad.cpu()
        if budget is not None:
            step.dropped = int(values["fine_pool_dropped"])
        return total.item(), grads

    # The auto budget of this batch on this grid, resolved once (on the CPU)
    # for both devices.
    cpu_loop = OccupancyTrainLoop(InstantNGPModel(table_sizes=[2**10], grid_sizes=[16], bbox_min=(-0.7,) * 3,
                                                  bbox_max=(0.7,) * 3), lr=1e-2, bbox_min=(-0.7,) * 3,
                                  bbox_max=(0.7,) * 3, pool_budget_per_ray="auto", pool_start_step=0)
    cpu_loop.grid_state = cpu_loop.grid.state_from_checkpoint(params)
    with contextlib.redirect_stdout(io.StringIO()):
        per_ray = cpu_loop._resolve_pool_budget(batch)
    budget = TRAIN_RAYS * per_ray

    counters = (ke.counter, kb.counter, kc.counter, kc.backward_counter, kc.pooled_counter,
                kc.pooled_backward_counter, ksel.counter, ksel.pack_counter)
    results = {}
    for name, step_budget, want_launched in (("train step", None, [2, 2, 1, 1, 0, 0, 1, 0]),
                                             ("pooled train step", budget, [2, 2, 0, 0, 1, 1, 1, 1])):
        if step_budget is not None:  # the pack right after the selection: no clamp or scan between them
            following = after_selection(kernel_sequence(lambda: step(device, step_budget), device))
            print(f"pooled train step: the kernels right after the selection {following}", flush=True)
            require(len(following) == 1 and "pool_pack_kernel" in (following[0] or ""),
                    f"the pooled train step launched other kernels between the selection and the pack: {following}")
        for c in counters:
            c.reset()
        got = step(device, step_budget)
        launched = [c.launches for c in counters]
        require(launched == want_launched and not any(c.plain_calls for c in counters),
                f"the card's {name} launched (encode, backward, composite, its backward, pooled composite, its "
                f"backward, selection, pack) {launched}")
        with plain_routes():
            card_plain = step(device, step_budget)
        require([c.launches for c in counters] == launched, "the card's plain route launched a kernel")
        cpu_plain = step(torch.device("cpu"), step_budget)
        if step_budget is not None:
            print(f"pooled train step: auto budget {per_ray} samples/ray, a pool of {budget}, "
                  f"{step.dropped} dropped", flush=True)
        results[name] = got, card_plain, cpu_plain

    def compare(name, loss, got, reference, loss_bound, table_bound, other_bound):
        ref_loss, want = reference
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        tables = {k: ((got[k] - want[k]).norm() / want[k].norm()).item() for k in want if "table" in k}
        others = {k: ((got[k] - want[k]).abs().max() / want[k].abs().max()).item()
                  for k in want if "table" not in k}
        worst_table, worst = max(tables, key=tables.get), max(others, key=others.get)
        print(f"{name}: loss {loss:.7f} vs {ref_loss:.7f} "
              f"(relative {loss_err:.2e}, bound {loss_bound:g}); table gradients, L2 relative: worst "
              f"{worst_table} {tables[worst_table]:.2e} (bound {table_bound:g}); other gradients, "
              f"relative to each tensor's max: worst {worst} {others[worst]:.2e} (bound "
              f"{other_bound:g})", flush=True)
        require(np.isfinite(loss) and loss_err <= loss_bound, f"the card step's loss disagrees with {name}")
        require(max(tables.values()) <= table_bound and max(others.values()) <= other_bound,
                f"the card step's gradients disagree with {name}")

    def missing(got, want):
        return [name for name in want if got[name].abs().max() == 0 or (
            "table" in name and ((want[name].abs() > 1e-3 * want[name].abs().max()) & (got[name] == 0)).any().item())]

    for name, ((loss, got), card_plain, cpu_plain) in results.items():
        compare(f"{name}, kernel route on the card vs the plain route on the card", loss, got, card_plain,
                *STEP_BOUNDS_SAME_CARD)
        compare(f"{name}, kernel route on the card vs the plain route on the CPU", loss, got, cpu_plain,
                *STEP_BOUNDS_CPU)
        want = cpu_plain[1]
        touched = {k: (got[k] != 0).any(dim=1).float().mean().item() for k in want if "table" in k}
        print(f"{name}: rows with a gradient, share of each table: "
              + ", ".join(f"{v:.3f}" for v in touched.values()) + f"; gradients missing: {missing(got, want)}",
              flush=True)
        require(not missing(got, want), f"the card's {name} left gradients missing: {missing(got, want)}")

    # With a pool that holds every survivor, the pooled step is the dense one.
    loss, got = results["train step"][0]
    ample_loss, ample = step(device, TRAIN_RAYS * TRAIN_SAMPLES)
    loss_err = abs(ample_loss - loss) / abs(loss)
    others = max(((ample[k] - got[k]).abs().max() / got[k].abs().max()).item() for k in got if "table" not in k)
    print(f"pooled train step at an ample budget ({step.dropped} dropped) vs the dense step on the card: loss "
          f"{ample_loss:.7f} vs {loss:.7f} (relative {loss_err:.2e}, bound {POOLED_DENSE_BOUND:g}); other "
          f"gradients, relative to each tensor's max: worst {others:.2e}; gradients missing: "
          f"{missing(ample, got)}", flush=True)
    require(step.dropped == 0 and loss_err <= POOLED_DENSE_BOUND and not missing(ample, got),
            "the pooled step at an ample budget disagrees with the dense step")


def graph_flags(root, pooled):
    """check_graph_step's train flags: bench_occupancy's width, the density
    penalty, auto pooling from step 0 when ``pooled``."""
    pool = ["--occ_train_budget", "auto", "--occ_train_budget_start", "0"] if pooled else []
    return ["--instant_ngp", "--occupancy", "--seed", str(SEED), "--lr", "1e-2", "--batch_size", str(TRAIN_RAYS),
            "--occ_warmup", str(TRAIN_WARMUP), "--density_penalty", "1e-3", *pool, str(root / "train")]


def graph_loop(root, device, pooled):
    """train_nerf's loop of ``graph_flags`` on ``device`` (the model from
    ``torch.manual_seed(SEED)``); the pooled one on the scene's ball grid
    (``ngp.pkl``'s, past warmup), whose refreshes then change its words."""
    from learn_nerf_tpu_torch.checkpoint import load_params_pickle
    from learn_nerf_tpu_torch.data.dataset import ModelMetadata
    from learn_nerf_tpu_torch.scripts import train_nerf

    args = train_nerf.build_parser().parse_args(graph_flags(root, pooled))
    torch.manual_seed(SEED)
    loop = train_nerf.make_loop(args, ModelMetadata.from_json(str(root / "train" / "metadata.json")), args.lr,
                                device)
    if pooled:
        loop.grid_state = loop.grid.state_from_checkpoint(load_params_pickle(str(root / "ngp.pkl")), device)
    return loop


def graph_batches(root, device, steps, rays_a_batch=TRAIN_RAYS):
    """``steps`` batches of ``rays_a_batch`` rays of the train scene, drawn from
    GRAPH_SEED, on ``device``."""
    from learn_nerf_tpu_torch.data.dataset import load_dataset

    rays = np.concatenate([view.rays() for view in load_dataset(str(root / "train")).views])
    rng = np.random.RandomState(GRAPH_SEED)
    return [torch.from_numpy(rays[rng.choice(rays.shape[0], rays_a_batch, replace=False)]).to(device)
            for _ in range(steps)]


def relative_l2(a, b):
    """``||a - b|| / ||b||`` over lists of tensors."""
    num = sum(float((x.detach().double() - y.detach().double()).pow(2).sum()) for x, y in zip(a, b))
    den = sum(float(y.detach().double().pow(2).sum()) for y in b)
    return (num / den) ** 0.5


def graph_against_eager(root, device, pooled, steps):
    """``steps`` free-running steps of the graph route (``step_auto``) and
    of two eager loops from the same start (``step()`` fed the graph loop's
    draws of each step: the candidate and penalty draws from its static
    buffers, the refresh's from the same seed).  Returns the fine loss's
    relative gaps by step of the graph loop to the first eager loop and of
    the second eager loop to the first (every dict read after the run), the
    parameters' relative L2 gaps at the end likewise, and the graph loop."""
    batches = graph_batches(root, device, steps)
    graph, eager, again = (graph_loop(root, device, pooled) for _ in range(3))
    got, want, noise = [], [], []
    for batch in batches:
        got.append(graph.step_auto(GRAPH_SEED, batch))
        draws = graph_draws(graph)
        for loop, out in ((eager, want), (again, noise)):
            out.append(loop.step(batch, generator=refresh_generator(loop, device), **draws))

    def gaps(a, b):
        return [abs(float(x["fine"]) - float(y["fine"])) / float(y["fine"]) for x, y in zip(a, b)]

    params = (relative_l2(graph._leaves(), eager._leaves()), relative_l2(again._leaves(), eager._leaves()))
    return gaps(got, want), gaps(noise, want), params, graph


def graph_draws(loop, rays=TRAIN_RAYS):
    """The draws the graph loop's prologue made for its last step of
    ``rays`` rays (copies of its static buffers), as ``step()`` takes
    them."""
    inputs = loop._inputs[rays]
    return dict(u=inputs["u"].clone(), density_draws=(inputs["coords_u"].clone(), inputs["dirs_normal"].clone()))


def refresh_generator(loop, device):
    """A generator seeded as ``step_auto`` seeds a grid refresh before
    ``loop``'s next step."""
    from learn_nerf_tpu_torch.train import GRID_TAG, fold_seed

    return torch.Generator(device=device).manual_seed(fold_seed(GRAPH_SEED, GRID_TAG, loop._host_step))


def sync_loop(src, dst):
    """``dst`` (a loop that steps eagerly) at ``src``'s state: parameters,
    Adam's moments and step counts and, in the occupancy loop, the grid,
    the host step and the auto budget."""
    from learn_nerf_tpu_torch.acceleration import OccupancyGridState

    with torch.no_grad():
        for a, b in zip(dst._leaves(), src._leaves()):
            a.copy_(b)
    for a, b in zip(dst._leaves(), src._leaves()):
        dst.optimizer.state[a] = {k: v.clone() for k, v in src.optimizer.state[b].items()}
    dst.step_count, dst._opt_count = src.step_count, src._opt_count
    if hasattr(src, "grid_state"):
        dst.grid_state = OccupancyGridState(src.grid_state.densities.clone(), src.grid_state.step)
        dst._host_step = src._host_step
        dst._auto_per_ray, dst._auto_resolved_at = src._auto_per_ray, src._auto_resolved_at


def graph_in_step(root, device, pooled, steps):
    """``steps`` steps of the graph route, each against eager ``step()``
    from the graph loop's state just before it (copied into an eager loop)
    and fed its draws.  Returns the graph loop and, by step, both routes'
    logged values (the graph loop's dicts read after the run) and whether
    both grids are bit-equal after the step."""
    batches = graph_batches(root, device, steps)
    graph, eager = graph_loop(root, device, pooled), graph_loop(root, device, pooled)
    got, want, grids = [], [], []
    for batch in batches:
        sync_loop(graph, eager)
        got.append(graph.step_auto(GRAPH_SEED, batch))
        want.append(eager.step(batch, generator=refresh_generator(eager, device), **graph_draws(graph)))
        grids.append(torch.equal(graph.grid_state.densities, eager.grid_state.densities))
    floats = [[{k: float(v) for k, v in values.items()} for values in route] for route in (got, want)]
    return graph, *floats, grids


def graph_sizes(root, device):
    """The composite backward's scratch across batch sizes on the dense
    graph loop, from a scratch as small as a fresh process's: steps of
    TRAIN_RAYS rays (the first eager, the second captured), one eager
    ``step()`` and two ``step_auto`` steps of twice as many (their scratch
    outgrows the captured one, and their key is captured), three steps of
    TRAIN_RAYS (replays of the first graph) and one of twice as many.
    Each ``step_auto`` step is held against eager ``step()`` from the
    graph loop's state and draws.  Returns the graph loop, both routes'
    logged values and the grids' agreement by step (as ``graph_in_step``),
    whether the outgrown scratch was retired rather than freed, and the
    replays and captures."""
    from learn_nerf_tpu_torch.kernels import composite as kc

    big = 2 * TRAIN_RAYS
    card = torch.empty(0, device=device).device  # the scratch's key: the device with its index
    ticket, partials = kc._scratch[card]
    kc._retired.append(partials)
    kc._scratch[card] = (ticket, torch.empty(0, device=card))
    small, large = graph_batches(root, device, 5), graph_batches(root, device, 3, big)
    graph, eager = graph_loop(root, device, False), graph_loop(root, device, False)
    got, want, grids = [], [], []

    def compare(batch):
        sync_loop(graph, eager)
        got.append(graph.step_auto(GRAPH_SEED, batch))
        want.append(eager.step(batch, generator=refresh_generator(eager, device),
                               **graph_draws(graph, batch.shape[0])))
        grids.append(torch.equal(graph.grid_state.densities, eager.grid_state.densities))

    for batch in small[:2]:
        compare(batch)
    captured = kc._scratch[card][1]
    draws = torch.Generator(device=device).manual_seed(GRAPH_SEED)
    graph.step(large[0], generator=refresh_generator(graph, device),
               u=torch.rand((big, graph.renderer.candidates), generator=draws, device=device),
               density_draws=(torch.rand((graph.density_penalty_batch_size, 3), generator=draws, device=device),
                              torch.randn((graph.density_penalty_batch_size, 3), generator=draws, device=device)))
    for batch in (*large[1:], *small[2:], large[1]):
        compare(batch)
    outgrown = kc._scratch[card][1] is not captured
    retired = any(t is captured for t in kc._retired)
    floats = [[{k: float(v) for k, v in values.items()} for values in route] for route in (got, want)]
    return graph, *floats, grids, outgrown and retired, (graph.graph_replays, graph.captures)


def in_step_faults(got, want, grids):
    """The steps whose forward values (all but ``grad_norm``, which the
    backward's atomics move) or grid differ between the routes, and the
    largest relative gap of ``grad_norm``."""
    differ = [i for i, (a, b, same) in enumerate(zip(got, want, grids))
              if not same or {k: v for k, v in a.items() if k != "grad_norm"}
              != {k: v for k, v in b.items() if k != "grad_norm"}]
    return differ, max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"] for a, b in zip(got, want))


@contextlib.contextmanager
def graph_fault(name, loop_class=None):
    """Inside, the graph route of ``loop_class`` (by default the occupancy
    loop) has the deliberate fault ``name`` (one of GRAPH_FAULTS or
    HIERARCHY_GRAPH_FAULTS)."""
    from learn_nerf_tpu_torch import step_graph
    from learn_nerf_tpu_torch.acceleration import StaticGridState
    from learn_nerf_tpu_torch.train import OccupancyTrainLoop, TrainLoop

    loop_class = loop_class or OccupancyTrainLoop
    if name == HIERARCHY_GRAPH_FAULTS[0]:
        owner, attr = TrainLoop, "_draw_inputs"
        original = TrainLoop._draw_inputs

        def faulty(self, inputs, batch, names):  # the fine uniforms of the first step, kept
            kept = self.__dict__.setdefault("_fine_drawn", False)
            self._fine_drawn = True
            return original(self, inputs, batch, [n for n in names if not (kept and n == "u_fine")])
    elif name == GRAPH_FAULTS[0]:
        owner, attr = StaticGridState, "follow"
        original = StaticGridState.follow

        def faulty(self, state):  # the words of the first state, kept through every refresh
            out = original(self, state)
            first = self.__dict__.setdefault("_first_words", self.words.clone())
            self.words.copy_(first)
            return out
    elif name == GRAPH_FAULTS[1]:
        owner, attr = loop_class, "_hot_step"
        original = loop_class._hot_step

        def faulty(self, batch, *rest):  # the buffer keeps the first batch
            return original(self, self.__dict__.setdefault("_first_batch", batch), *rest)
    else:
        owner, attr = step_graph, "_unpacked"
        original = step_graph._unpacked

        def faulty(outputs):  # views of the graph's outputs, which the next replay writes
            order, groups = outputs
            values = {key: stacked[i] for stacked, keys in groups.values() for i, key in enumerate(keys)}
            return {key: values[key] for key in order}
    own = attr in owner.__dict__
    setattr(owner, attr, faulty)
    try:
        yield
    finally:
        if own:
            setattr(owner, attr, original)
        else:
            delattr(owner, attr)


def check_graph_step(root, device):
    """The occupancy loop's hot route on the card: ``step_auto`` as
    CUDA-graph replays, dense and auto-pooled (see GRAPH_STEPS and the
    lines before it): every step against eager ``step()`` from the same
    state and draws (the forward values and the grid bit-equal,
    ``grad_norm`` within GRAPH_GRAD_NORM_BOUND), GRAPH_STEPS free-running
    steps within GRAPH_LOSS_BOUND and GRAPH_PARAM_BOUND of the eager route
    (the eager route against itself printed beside), one replay a step
    after the first and one capture a key, at most GRAPH_HOST_LAUNCHES host
    launches a replayed step and, in its trace, each of the port's kernels
    run as many times as the counters claim for it, the composite ticket
    back at 0, the launch counters moved once a step on each route; the
    same across batch sizes (``graph_sizes``); each deliberate fault
    (GRAPH_FAULTS) caught; and a full state saved on the CPU resumed on the
    card, its next step the CPU's and the graph route going on."""
    from learn_nerf_tpu_torch.kernels import composite as kc

    for pooled in (False, True):
        name = "pooled (auto)" if pooled else "dense"
        counters = kernel_counters()
        for c in counters.values():
            c.reset()
        loop, got, want, grids = graph_in_step(root, device, pooled, GRAPH_STEPS)
        counts = {k: c.launches for k, c in counters.items()}
        differ, grad_gap = in_step_faults(got, want, grids)
        keys = sorted(loop._graphs._graphs, key=str)
        print(f"graph step, {name}, {GRAPH_STEPS} steps, each against eager step() from its state: forward values "
              f"or grid differ at steps {differ}; grad_norm gap max {grad_gap:.3e} (bound "
              f"{GRAPH_GRAD_NORM_BOUND:g}); first steps {got[:2]} vs {want[:2]}; {loop.graph_replays} replays, "
              f"{loop.captures} captures, keys {keys}", flush=True)
        require(not differ and grad_gap <= GRAPH_GRAD_NORM_BOUND,
                f"graph step, {name}: the replayed steps disagree with the eager steps")
        require(loop.graph_replays == GRAPH_STEPS - 1 and loop.captures == len(keys) >= (1 if pooled else 2),
                f"graph step, {name}: {loop.graph_replays} replays and {loop.captures} captures in {GRAPH_STEPS} "
                "steps")
        ticket = int(kc._scratch[loop.background.device][0].item())
        require(ticket == 0, f"graph step, {name}: the composite ticket stands at {ticket} after the replays")
        # Two loops took each step: a step's launches, counted once on each
        # route (the table-gradient kernel twice a step: the batch's points
        # and the density penalty's).
        require(counts["select_strided"] >= 2 * GRAPH_STEPS and counts["hashgrid_backward"] == 4 * GRAPH_STEPS
                and counts["composite_backward"] + counts["composite_pooled_backward"] == 2 * GRAPH_STEPS,
                f"graph step, {name}: the launch counters did not move once a step on each route: {counts}")
        while loop._refresh_due():
            loop.step_auto(GRAPH_SEED, graph_batches(root, device, 1)[0])
        batch = graph_batches(root, device, 1)[0]

        def replay():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.step_auto(GRAPH_SEED, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        replay()
        seen = traced_until_matched(f"graph step, {name}", replay, device)
        print(f"graph step, {name}: a replayed step under the profiler: {seen['host_launches']} host launches, "
              f"{seen['kernels_launched']} kernels, {seen['device_ms']:.3f} device ms of {seen['profiled_ms']:.3f} "
              f"ms; the port's kernels it ran {seen['port_calls']} ({seen['port_graph_calls']} in replays), the "
              f"launches its counters claim {seen['claimed']} ({seen['claimed_graph']} by replays)", flush=True)
        times = replay_device_ms(list(loop._graphs._graphs.values())[-1][0], device)
        print(f"graph step, {name}: one replay {times['events_ms']:.4f} ms by CUDA events, "
              f"{times['kernel_sum_ms']:.4f} ms its {times['kernels']} kernels' sum and {times['busy_ms']:.4f} ms "
              f"busy under the profiler", flush=True)
        require(1 <= seen["host_launches"] <= GRAPH_HOST_LAUNCHES,
                f"graph step, {name}: a replayed step made {seen['host_launches']} host launches")
        require(seen["claimed_graph"] and trace_matches(seen),
                f"graph step, {name}: the replayed step ran the port's kernels {seen['port_calls']} "
                f"({seen['port_graph_calls']} in replays), but its counters claim {seen['claimed']} "
                f"({seen['claimed_graph']} by replays)")
        del loop
        gaps, noise, (param_gap, param_noise), loop = graph_against_eager(root, device, pooled, GRAPH_STEPS)
        print(f"graph step, {name}, {GRAPH_STEPS} free-running steps: fine loss gap to the eager route max "
              f"{max(gaps):.3e} (bound {GRAPH_LOSS_BOUND:g}; the eager route to itself {max(noise):.3e}); parameters' "
              f"relative L2 gap {param_gap:.3e} (bound {GRAPH_PARAM_BOUND:g}; eager to itself {param_noise:.3e})",
              flush=True)
        require(max(gaps) <= GRAPH_LOSS_BOUND and param_gap <= GRAPH_PARAM_BOUND,
                f"graph step, {name}: the graph route strayed from the eager route")
        del loop
        torch.cuda.empty_cache()

    loop, got, want, grids, kept, (replays, captures) = graph_sizes(root, device)
    del loop
    differ, grad_gap = in_step_faults(got, want, grids)
    print(f"graph step across batch sizes ({TRAIN_RAYS} rays captured, {2 * TRAIN_RAYS} eager and captured, "
          f"{TRAIN_RAYS} replayed): forward values or grid differ at steps {differ}; grad_norm gap max "
          f"{grad_gap:.3e}; the captured composite scratch outgrown and kept {kept}; {replays} replays, "
          f"{captures} captures", flush=True)
    require(not differ and grad_gap <= GRAPH_GRAD_NORM_BOUND and kept and (replays, captures) == (len(got) - 1, 2),
            "graph step across batch sizes: the replays disagree with the eager steps, or the scratch a graph "
            "captured was freed")
    torch.cuda.empty_cache()

    for fault in GRAPH_FAULTS:
        with graph_fault(fault):
            loop, got, want, grids = graph_in_step(root, device, True, GRAPH_FAULT_STEPS)
        del loop
        differ, _ = in_step_faults(got, want, grids)
        print(f"graph step fault, {fault}: the routes differ at steps {differ}", flush=True)
        require(differ, f"graph step: the fault '{fault}' went unseen")
    torch.cuda.empty_cache()

    # A full state saved on the CPU resumes on the card: the same step with
    # the same draws gives the CPU's loss; then the graph route goes on.
    loop = graph_loop(root, device, False)
    cpu = graph_loop(root, torch.device("cpu"), False)
    batches = [b.cpu() for b in graph_batches(root, torch.device("cpu"), 2)]
    rng = np.random.RandomState(GRAPH_SEED)
    draws = [dict(u=torch.from_numpy(rng.rand(TRAIN_RAYS, 192).astype(np.float32)),
                  density_draws=(torch.from_numpy(rng.rand(128, 3).astype(np.float32)),
                                 torch.from_numpy(rng.randn(128, 3).astype(np.float32)))) for _ in range(2)]
    generator = torch.Generator().manual_seed(GRAPH_SEED)
    cpu.step(batches[0], generator=generator, **draws[0])
    path = root / "cpu_state.pt"
    cpu.save_full(str(path))
    loop.load_full(str(path))
    path.unlink()
    cpu_loss = float(cpu.step(batches[1], generator=generator, **draws[1])["fine"])
    card = dict(u=draws[1]["u"].to(device), density_draws=tuple(d.to(device) for d in draws[1]["density_draws"]))
    card_loss = float(loop.step(batches[1].to(device), generator=refresh_generator(loop, device), **card)["fine"])
    gap = abs(card_loss - cpu_loss) / cpu_loss
    for batch in graph_batches(root, device, 2):
        values = loop.step_auto(GRAPH_SEED, batch)
    print(f"a full state saved on the CPU, resumed on the card: the next step's loss {card_loss:.7f} vs the CPU's "
          f"{cpu_loss:.7f} (relative {gap:.2e}, bound {STEP_BOUNDS_CPU[0]:g}); then {loop.graph_replays} replay(s), "
          f"fine {float(values['fine']):.6f}", flush=True)
    require(gap <= STEP_BOUNDS_CPU[0] and loop.graph_replays == 1 and np.isfinite(float(values["fine"])),
            "a full state saved on the CPU did not resume on the card")
    del loop, cpu
    torch.cuda.empty_cache()


def hierarchy_graph_loop(root, device, name):
    """train_nerf's loop of the HIERARCHY_RUNS model ``name`` at full width
    with the density penalty on (the models from ``torch.manual_seed(SEED)``)."""
    from learn_nerf_tpu_torch.data.dataset import ModelMetadata
    from learn_nerf_tpu_torch.scripts import train_nerf

    flags = [*HIERARCHY_FLAGS, *HIERARCHY_RUNS[name][0], "--density_penalty", HIERARCHY_PENALTY, str(root / "train")]
    args = train_nerf.build_parser().parse_args(flags)
    torch.manual_seed(SEED)
    return train_nerf.make_loop(args, ModelMetadata.from_json(str(root / "train" / "metadata.json")), args.lr,
                                device)


def loop_state(loop):
    """A copy of ``loop``'s parameters, Adam's state and step counts, as
    ``sync_loop`` reads them from a loop."""
    leaves = [p.detach().clone() for p in loop._leaves()]
    adam = {c: {k: v.clone() for k, v in loop.optimizer.state[p].items()} for c, p in zip(leaves, loop._leaves())}
    return types.SimpleNamespace(_leaves=lambda: leaves, optimizer=types.SimpleNamespace(state=adam),
                                 step_count=loop.step_count, _opt_count=loop._opt_count)


def hierarchy_in_step(root, device, name, steps, on_graph=None):
    """``steps`` hot-route steps of the hierarchy loop of ``name``, then,
    once that loop and its graphs are gone (a vanilla Ref-NeRF graph pool
    and an eager step beside it do not fit the card together), each step
    again by eager ``step()`` from the graph loop's state just before it
    (``loop_state``, copied into an eager loop) with a generator seeded as
    ``step_auto`` seeds the step, which draws inside the loss.
    ``on_graph(loop)`` runs on the graph loop after its steps.  Returns both
    routes' logged values by step (the graph loop's dicts read after its
    run) and each route's launches by step (``counted``: no plain version
    may run)."""
    from learn_nerf_tpu_torch.train import TRAIN_TAG, fold_seed

    batches = graph_batches(root, device, steps)
    graph = hierarchy_graph_loop(root, device, name)
    states, routes = [], ([], [])
    for batch in batches:
        states.append(loop_state(graph))
        routes[0].append(counted(name, lambda: graph.step_auto(GRAPH_SEED, batch)))
    got = [{k: float(v) for k, v in values.items()} for values, _ in routes[0]]
    if on_graph is not None:
        on_graph(graph)
    del graph
    gc.collect()
    torch.cuda.empty_cache()
    eager = hierarchy_graph_loop(root, device, name)
    for batch, state in zip(batches, states):
        sync_loop(state, eager)
        generator = torch.Generator(device=device).manual_seed(fold_seed(GRAPH_SEED, TRAIN_TAG, eager.step_count))
        routes[1].append(counted(name, lambda: eager.step(batch, generator=generator)))
    want = [{k: float(v) for k, v in values.items()} for values, _ in routes[1]]
    launches = [tuple({k: n for k, (n, _) in counts.items() if n} for _, counts in step) for step in zip(*routes)]
    return got, want, launches


def hierarchy_step_launches(name):
    """A hierarchy step's launches of ``name``'s model with the density
    penalty on (see HIERARCHY_GRAPH_STEPS)."""
    flags = HIERARCHY_RUNS[name][0]
    want = dict(composite=2, composite_backward=2)
    if "--instant_ngp" in flags:
        want.update(hashgrid_encode=4, hashgrid_backward=4)
        if "--ref_nerf" in flags:
            want.update(hashgrid_dx=4, hashgrid_dx_backward=2)
    return want


def check_hierarchy_graph_step(root, device):
    """The hierarchy loop's hot route on the card: ``step_auto`` as
    CUDA-graph replays for each HIERARCHY_RUNS model at full width, with
    the density penalty (see HIERARCHY_GRAPH_STEPS and the lines before it):
    every step against eager ``step()`` from the same state and the draws
    of the same seed (the forward values bit-equal, ``grad_norm`` within
    GRAPH_GRAD_NORM_BOUND), one capture and a replay a step after the
    first, the composite ticket back at 0 after both passes' launches, each
    route's launches once a step as HIERARCHY_GRAPH_STEPS says, at most
    HIERARCHY_HOST_LAUNCHES host launches a replayed step in the profile,
    whose trace runs each of the port's kernels as often as the counters
    claim, the graph pool and the peak memory printed; then each
    deliberate fault (HIERARCHY_GRAPH_FAULTS) caught on the NGP loop."""
    from learn_nerf_tpu_torch.kernels import composite as kc
    from learn_nerf_tpu_torch.scripts.profile_train import graph_pool_bytes
    from learn_nerf_tpu_torch.train import TrainLoop

    for name, steps in HIERARCHY_GRAPH_STEPS.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        seen = {}

        def on_graph(loop):
            """The checks that need the graph loop: its captures and
            replays, the ticket, the pool, a profiled and a timed replay."""
            seen.update(replays=loop.graph_replays, captures=loop.captures, pool=graph_pool_bytes(loop),
                        keys=sorted(loop._graphs._graphs, key=str),
                        ticket=int(kc._scratch[loop.background.device][0].item()))
            batch = graph_batches(root, device, 1)[0]

            def replay():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.step_auto(GRAPH_SEED, batch)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            replay()
            seen["trace"] = traced_until_matched(f"hierarchy graph step, {name}", replay, device)
            seen["times"] = replay_device_ms(list(loop._graphs._graphs.values())[0][0], device, reps=4)
            seen["graph_peak"] = torch.cuda.max_memory_allocated(device)

        got, want, launches = hierarchy_in_step(root, device, name, steps, on_graph)
        peak = torch.cuda.max_memory_allocated(device)
        differ, grad_gap = in_step_faults(got, want, [True] * steps)
        per_step = hierarchy_step_launches(name)
        wrong = [i for i, (a, b) in enumerate(launches) if a != per_step or b != per_step]
        trace, times = seen["trace"], seen["times"]
        print(f"hierarchy graph step, {name}, {steps} steps, each against eager step() from its state: forward "
              f"values differ at steps {differ}; grad_norm gap max {grad_gap:.3e} (bound {GRAPH_GRAD_NORM_BOUND:g}); "
              f"first steps {got[:2]} vs {want[:2]}; {seen['replays']} replays, {seen['captures']} captures, keys "
              f"{seen['keys']}; launches a step not {per_step} on either route at steps {wrong} (first "
              f"{launches[0]}); graph pool {seen['pool']} B, peak allocated {seen['graph_peak']} B with the graphs, "
              f"{peak} B in all", flush=True)
        print(f"hierarchy graph step, {name}: a replayed step under the profiler: {trace['host_launches']} host "
              f"launches, {trace['kernels_launched']} kernels, {trace['device_ms']:.3f} device ms of "
              f"{trace['profiled_ms']:.3f} ms; the port's kernels it ran {trace['port_calls']} "
              f"({trace['port_graph_calls']} in replays), the launches its counters claim {trace['claimed']} "
              f"({trace['claimed_graph']} by replays); one replay {times['events_ms']:.4f} ms by CUDA events, "
              f"{times['kernel_sum_ms']:.4f} ms its {times['kernels']} kernels' sum and {times['busy_ms']:.4f} ms "
              f"busy under the profiler", flush=True)
        require(not differ and grad_gap <= GRAPH_GRAD_NORM_BOUND,
                f"hierarchy graph step, {name}: the replayed steps disagree with the eager steps")
        # The profiled and the timed replay come after the counted steps.
        require(seen["replays"] == steps - 1 and seen["captures"] == 1 and seen["keys"] == [(TRAIN_RAYS,)],
                f"hierarchy graph step, {name}: {seen['replays']} replays and {seen['captures']} captures in "
                f"{steps} steps")
        require(seen["ticket"] == 0, f"hierarchy graph step, {name}: the composite ticket stands at "
                f"{seen['ticket']} after the replays")
        require(not wrong, f"hierarchy graph step, {name}: the launch counters did not move once a step on each "
                f"route: {launches}")
        require(1 <= trace["host_launches"] <= HIERARCHY_HOST_LAUNCHES,
                f"hierarchy graph step, {name}: a replayed step made {trace['host_launches']} host launches")
        require(trace["claimed_graph"] and trace_matches(trace),
                f"hierarchy graph step, {name}: the replayed step ran the port's kernels {trace['port_calls']} "
                f"({trace['port_graph_calls']} in replays), but its counters claim {trace['claimed']} "
                f"({trace['claimed_graph']} by replays)")

    for fault in HIERARCHY_GRAPH_FAULTS:
        gc.collect()
        torch.cuda.empty_cache()
        with graph_fault(fault, TrainLoop):
            got, want, _ = hierarchy_in_step(root, device, "hierarchy ngp", HIERARCHY_GRAPH_FAULT_STEPS)
        differ, _ = in_step_faults(got, want, [True] * len(got))
        print(f"hierarchy graph step fault, {fault}: the routes differ at steps {differ}", flush=True)
        require(differ, f"hierarchy graph step: the fault '{fault}' went unseen")
    gc.collect()
    torch.cuda.empty_cache()


def graph_runs(n):
    """``--graph_runs``: check_graph_step's comparison alone, ``n`` times
    on the card, dense and pooled; prints each run's largest fine loss gap
    and parameter gap of the graph route and of the eager route to the
    eager route, then one JSON line of them all."""
    from learn_nerf_tpu_torch.kernels import build
    from learn_nerf_tpu_torch.scripts.common import default_device

    device = default_device()
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build.BUILD_DIR) as tmp:
        root = Path(tmp)
        with contextlib.redirect_stdout(io.StringIO()):
            write_scene(root, np.random.RandomState(SEED))
        write_train_scene(root / "train", np.random.RandomState(SEED + 7))
        for run in range(n):
            for pooled in (False, True):
                gaps, noise, params, loop = graph_against_eager(root, device, pooled, GRAPH_STEPS)
                del loop
                results.append(dict(run=run, pooled=pooled, graph=gaps, eager=noise, params=params))
                print(f"graph run {run}, {'pooled' if pooled else 'dense'}: fine loss gap max, graph {max(gaps):.3e}, "
                      f"eager to itself {max(noise):.3e}; parameters, graph {params[0]:.3e}, eager to itself "
                      f"{params[1]:.3e}", flush=True)
                torch.cuda.empty_cache()
    print(json.dumps({"graph_runs": results}))
    return 0


def write_train_scene(root, rng, views=TRAIN_VIEWS):
    """A posed dataset of the ball the occupancy grid models: PNG + JSON
    views from a sphere of radius 2, the ball (radius 0.45) coloured by
    position on a grey background."""
    from PIL import Image

    from learn_nerf_tpu_torch.data.camera import CameraView

    root.mkdir()
    (root / "metadata.json").write_text(json.dumps({"min": [-0.7] * 3, "max": [0.7] * 3}))
    for i in range(views):
        z = -rng.randn(3)
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        view = CameraView(tuple(z.tolist()), tuple((-2.0 * z).tolist()), tuple(x.tolist()),
                          tuple(np.cross(z, x).tolist()), 0.7, 0.7)
        rays = view.bare_rays(TRAIN_SIDE, TRAIN_SIDE).astype(np.float64)
        o, d = rays[:, 0], rays[:, 1]
        b = (o * d).sum(-1)
        disc = b**2 - ((o**2).sum(-1) - 0.45**2)
        hit = disc > 0
        t_hit = -b - np.sqrt(np.where(hit, disc, 0.0))
        surface = o + d * t_hit[:, None]
        colors = np.where(hit[:, None], (surface / 0.45 * 0.5 + 0.5) * 255.0, 128.0)
        image = np.clip(colors, 0, 255).astype(np.uint8).reshape(TRAIN_SIDE, TRAIN_SIDE, 3)
        Image.fromarray(image).save(root / f"{i:04}.png")
        (root / f"{i:04}.json").write_text(view.to_json())


def kernel_counters():
    from learn_nerf_tpu_torch.kernels import baked as kbaked
    from learn_nerf_tpu_torch.kernels import composite as kc
    from learn_nerf_tpu_torch.kernels import fused_mlp as fm
    from learn_nerf_tpu_torch.kernels import fused_render as fr
    from learn_nerf_tpu_torch.kernels import hashgrid as kh
    from learn_nerf_tpu_torch.kernels import hashgrid_backward as kb
    from learn_nerf_tpu_torch.kernels import hashgrid_dx as kd
    from learn_nerf_tpu_torch.kernels import hashgrid_encode as ke
    from learn_nerf_tpu_torch.kernels import ngp_mlp as km
    from learn_nerf_tpu_torch.kernels import selection as ksel
    from learn_nerf_tpu_torch.kernels import table_gather as tg
    from learn_nerf_tpu_torch.occ_render import block_word_counter

    return dict(fused_mlp=fm.counter, fused_render=fr.counter, table_gather=tg.counter,
                hashgrid_corners=kh.counter, hashgrid_encode=ke.counter,
                hashgrid_backward=kb.counter, hashgrid_dx=kd.counter, hashgrid_dx_backward=kd.backward_counter,
                composite=kc.counter,
                composite_backward=kc.backward_counter, composite_pooled=kc.pooled_counter,
                composite_pooled_backward=kc.pooled_backward_counter, baked_lookup=kbaked.counter,
                select_strided=ksel.counter, pool_pack=ksel.pack_counter, ngp_mlp=km.counter,
                **{BLOCK_WORD_SELECTION: block_word_counter})


def plain_called(counts):
    """``{kernel: plain calls}`` of the wrappers that ran a plain version,
    the block-word lever's plain candidate test (plain by decision) apart."""
    return {k: plain for k, (_, plain) in counts.items() if plain and k != BLOCK_WORD_SELECTION}


@contextlib.contextmanager
def recording_steps():
    """Inside, every gradient step of either train loop appends its logging
    dict (tensors on the card, read after the run; a replayed step's is its
    own clone) and its lr to the yielded list."""
    from learn_nerf_tpu_torch import train

    original, steps = train.grad_step, []

    def grad_step(loop, loss_fn, *graph):
        values = original(loop, loss_fn, *graph)
        steps.append((values, loop.optimizer.param_groups[0]["lr"]))
        return values

    train.grad_step = grad_step
    try:
        yield steps
    finally:
        train.grad_step = original


class Interrupted(Exception):
    """Raised from ``train_nerf``'s step hook to stop a run as a crash would."""


def train_run(root, name, flags, checkpoint, steps=TRAIN_STEPS, data="train", stop_at=None, expect=None,
              rays=TRAIN_RAYS):
    """One ``train_nerf`` run of ``steps`` steps (stopped, as by a crash,
    once ``stop_at`` steps are done; a resumed run takes the ``expect``
    steps that remain); returns its kernel counts, the per-step (logging
    dict, lr), the last steps' rates and the loop (None when stopped).  A
    whole run's loss must fall."""
    from learn_nerf_tpu_torch.scripts import train_nerf

    argv = [*flags, "--steps", str(steps), "--save_path", str(root / checkpoint), str(root / data)]
    marks = {}

    def on_step(done, loop):
        if done in (1, 8, steps - 64, steps - 48, steps):
            torch.cuda.synchronize()
            marks[done] = time.perf_counter()
        if done == stop_at:
            raise Interrupted

    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    log = io.StringIO()
    marks[0] = time.perf_counter()
    loop = None
    with contextlib.redirect_stdout(log), recording_steps() as records:
        try:
            loop = train_nerf.main(argv, on_step=on_step)
        except Interrupted:
            pass
    counts = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
    text = log.getvalue()
    lines = [line for line in text.splitlines() if line.startswith("step ")]
    fine = [float(v["fine"]) for v, _ in records]
    done = expect or stop_at or steps
    require(len(records) == done and np.isfinite(fine).all()
            and all(np.isfinite(float(v)) for line in lines for v in re.findall(r"=(\S+)", line)),
            f"{name} ran {len(records)} steps, or logged a value that is not finite")
    head = max(len(fine) // 6, 1)
    first, last = float(np.mean(fine[:head])), float(np.mean(fine[-head:]))
    rate = {n: n / (marks[steps] - marks[steps - n]) for n in (64, 48) if steps - n in marks and steps in marks}
    notes = [line for line in text.splitlines() if line.startswith(("auto pool budget", "cosine", "skipping"))]
    grid = f"; grid updates {loop.grid_state.step}" if hasattr(loop, "grid_state") else ""
    if hasattr(loop, "graph_replays"):  # either loop: every step after the first a graph replay
        grid += f"; {loop.graph_replays} graph replays, {loop.captures} captures"
        require(loop.graph_replays == done - 1 and loop.captures >= 1,
                f"{name}: {loop.graph_replays} graph replays and {loop.captures} captures in {done} steps")
    print(f"{name}, {len(records)} steps of {rays} rays: first step(s) "
          f"{marks[min(marks.keys() - {0})] - marks[0]:.3f} s (dataset, shuffle and model set-up included); "
          + "; ".join(f"last {n} steps {r:.2f} steps/s, {r * rays:.0f} rays/s" for n, r in rate.items())
          + f"; fine loss, mean of the first {head} steps {first:.5f}, of the last {head} {last:.5f}{grid}; "
          f"{notes}; {lines[-1] if lines else ''}; (launches, plain calls) {counts}", flush=True)
    require(done != steps or last < first, f"{name}: the fine loss did not fall")
    require(not plain_called(counts), f"{name} called a plain version: {counts}")
    torch.cuda.empty_cache()
    return counts, records, rate, loop


def evaluate(root, checkpoint, flags=(), mode=("--instant_ngp", "--occupancy"), data="heldout",
             views=HELDOUT_VIEWS, batch=8192):
    """The port's eval_psnr over a dataset's views (the held-out views of
    the ball by default); the mean PSNR, each view's PSNR and SSIM."""
    from learn_nerf_tpu_torch.scripts import eval_psnr

    argv = [*mode, "--seed", str(SEED), "--batch_size", str(batch),
            "--model_path", str(root / checkpoint), *flags, str(root / data)]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        scores, ssims = eval_psnr.main(argv)
    mean = float(re.search(r"mean_psnr=(\S+)", log.getvalue()).group(1))
    require(len(scores) == views and np.isfinite(scores).all(), f"eval_psnr on {checkpoint}: {scores}")
    return mean, scores, ssims


def baked_fidelity(root, checkpoint):
    """PSNR of each held-out view's baked frame (``--baked 384
    --baked_pack 4``) against its live frame, the same seed for both."""
    from learn_nerf_tpu_torch.data.dataset import load_dataset
    from learn_nerf_tpu_torch.scripts import render_nerf
    from learn_nerf_tpu_torch.utils.metrics import psnr

    views = load_dataset(str(root / "heldout")).views
    frames = []
    for flags in ([], BAKED_EVAL_FLAGS):
        argv = ["--instant_ngp", "--occupancy", "--seed", str(SEED), "--batch_size", "8192",
                "--model_path", str(root / checkpoint), *flags, str(root / "heldout" / "metadata.json")]
        with contextlib.redirect_stdout(io.StringIO()):
            session = render_nerf.RenderSession(render_nerf.argparser().parse_args(argv))
            frames.append([session.render_view(v, width=v.image().shape[1], height=v.image().shape[0])
                           for v in views])
        del session
        torch.cuda.empty_cache()
    return [psnr(baked, live) for live, baked in zip(*frames)]


def train_phase(root, profile):
    """The port's train CLI at full width on the card, dense and then pooled
    from step POOL_START (the flagship ``--occ_train_budget auto``, with
    macro steps of 8 that straddle the switch), each trained checkpoint
    scored on held-out views by ``eval_psnr`` and served; returns ``{run:
    {kernel: (launches, plain calls)}}`` and the dense run's mean PSNR."""
    from learn_nerf_tpu_torch.scripts import profile_train

    flags = ["--instant_ngp", "--occupancy", "--seed", str(SEED), "--lr", "1e-2",
             "--batch_size", str(TRAIN_RAYS), "--occ_warmup", str(TRAIN_WARMUP)]
    pooled_flags = [*flags, "--occ_train_budget", "auto", "--occ_train_budget_start", str(POOL_START),
                    "--steps_per_dispatch", "8"]
    refreshes = TRAIN_STEPS // 16
    counts, pooled_at = {}, {}
    for run, run_flags, checkpoint in (("train", flags, "trained.pkl"),
                                       ("train pooled", pooled_flags, "trained_pooled.pkl")):
        counts[run], records, _, loop = train_run(root, run, run_flags, checkpoint)
        require(loop.grid_state.step == refreshes, f"{run}: {loop.grid_state.step} grid updates")
        pooled_at[run] = [(i, int(v["fine_pool_dropped"])) for i, (v, _) in enumerate(records)
                          if "fine_pool_dropped" in v]
        per_ray = loop._auto_per_ray
        del loop
    want = {
        "train": dict(hashgrid_encode=TRAIN_STEPS + refreshes, hashgrid_backward=TRAIN_STEPS,
                      composite=TRAIN_STEPS, composite_backward=TRAIN_STEPS, composite_pooled=0,
                      composite_pooled_backward=0, select_strided=TRAIN_STEPS, pool_pack=0),
        "train pooled": dict(hashgrid_encode=TRAIN_STEPS + refreshes, hashgrid_backward=TRAIN_STEPS,
                             composite=POOL_START, composite_backward=POOL_START,
                             composite_pooled=TRAIN_STEPS - POOL_START,
                             composite_pooled_backward=TRAIN_STEPS - POOL_START, pool_pack=TRAIN_STEPS - POOL_START),
    }
    for run, expected in want.items():
        require(all(counts[run][k][0] == v for k, v in expected.items()),
                f"the {run} run's launches {counts[run]} are not {expected}")
    # The pooled run also selects once for each demand measurement of its
    # auto budget (at least the first).
    require(counts["train pooled"]["select_strided"][0] > TRAIN_STEPS,
            f"the pooled run's demand did not select on the card: {counts['train pooled']}")
    require(not pooled_at["train"], "the dense run took a pooled step")
    pooled = pooled_at["train pooled"]
    dropped = [d for _, d in pooled]
    print(f"train pooled: steps {pooled[0][0]}-{pooled[-1][0]} pooled, {per_ray} samples a ray at the end, "
          f"fine_pool_dropped max {max(dropped)}", flush=True)
    require([i for i, _ in pooled] == list(range(POOL_START, TRAIN_STEPS)),
            "the pooled run did not pool exactly the steps from POOL_START on")
    require(max(dropped) == 0, f"the pooled run dropped samples: {dropped}")

    write_train_scene(root / "heldout", np.random.RandomState(SEED + 10), views=HELDOUT_VIEWS)
    dense_psnr, dense_scores, _ = evaluate(root, "trained.pkl")
    pooled_psnr, pooled_scores, _ = evaluate(root, "trained_pooled.pkl")
    shortfall = dense_psnr - pooled_psnr
    print(f"eval_psnr on {HELDOUT_VIEWS} held-out views: dense mean_psnr={dense_psnr:.3f} "
          f"({[round(v, 3) for v in dense_scores]}), pooled mean_psnr={pooled_psnr:.3f} "
          f"({[round(v, 3) for v in pooled_scores]}); the pooled run's shortfall {shortfall:.3f} dB (bound "
          f"{POOLED_PSNR_SHORTFALL:g} dB)", flush=True)
    require(shortfall <= POOLED_PSNR_SHORTFALL, "the pooled run fell short of the dense run's PSNR")
    baked_psnr, baked_scores, _ = evaluate(root, "trained.pkl", BAKED_EVAL_FLAGS)
    fidelity = baked_fidelity(root, "trained.pkl")
    baked_shortfall = dense_psnr - baked_psnr
    print(f"eval_psnr {' '.join(BAKED_EVAL_FLAGS)} on the dense run: mean_psnr={baked_psnr:.3f} "
          f"({[round(float(v), 3) for v in baked_scores]}); the baked shortfall {baked_shortfall:.3f} dB (bound "
          f"{BAKED_PSNR_SHORTFALL:g} dB); the baked frames against the live frames: PSNR "
          f"{[round(float(v), 3) for v in fidelity]} dB (floor {BAKED_FRAME_PSNR:g} dB)", flush=True)
    require(baked_shortfall <= BAKED_PSNR_SHORTFALL, "the baked field fell short of the live field's PSNR")
    require(min(fidelity) >= BAKED_FRAME_PSNR, f"the baked frames are under {BAKED_FRAME_PSNR:g} dB "
            "against the live frames")

    served, _ = serve_mode(root, "trained ngp occupancy", NGP_MODES["ngp occupancy"], bf16=False,
                           checkpoint="trained.pkl", requests=1)
    served_pooled, _ = serve_mode(root, "trained ngp pooled", ["--instant_ngp", "--occupancy",
                                                               "--occ_budget_per_ray", "auto"],
                                  bf16=False, checkpoint="trained_pooled.pkl", requests=1)
    if profile:
        args = profile_train.argparser().parse_args([*flags, str(root / "train")])
        result = profile_train.profile_args(args)
        print("profile:", json.dumps({"mode": "ngp occupancy train step", **result}), flush=True)
        args = profile_train.argparser().parse_args([*flags, "--pooled", str(root / "train")])
        for mode, result in profile_train.profile_args(args).items():
            print("profile:", json.dumps({"mode": f"ngp occupancy train step, bench_pooled grid, {mode}", **result}),
                  flush=True)
    return {**counts, "trained ngp occupancy": served, "trained ngp pooled": served_pooled}, dense_psnr


def counted(name, call):
    """``call()`` with every kernel count set to 0 before it; returns its
    result and ``{kernel: (launches, plain calls)}``, and fails if a plain
    version ran."""
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    result = call()
    counts = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
    require(not plain_called(counts), f"{name} called a plain version: {counts}")
    return result, counts


def lever_phase(root, device, dense_psnr):
    """The dense trained checkpoint through the render-family CLIs with the
    selection levers, its weights over the scene's ball grid:
    ``eval_psnr`` pooled with span 64 and with span 64 and block words 4
    against the plain pooled score (shortfall at most
    LEVER_PSNR_SHORTFALL; a weak check on an ~8 dB image, printed beside
    the dense run's own ``dense_psnr``: quality_gate holds the levers on a
    checkpoint whose own grid culls), ``render_new_dataset`` (two RGBD views, pooled,
    span 64) and ``render_nerf_spin`` (4 frames); and
    ``marching_cubes --resolution 128`` on the checkpoint itself (its
    sweep by the encode kernel against the plain encode on the card,
    within MESH_BOUND).  Returns ``{run: {kernel: (launches,
    plain calls)}}``."""
    from learn_nerf_tpu_torch.data.camera import CameraView
    from learn_nerf_tpu_torch.data.dataset import ModelMetadata
    from learn_nerf_tpu_torch.scripts import marching_cubes, render_nerf, render_nerf_spin, render_new_dataset

    from learn_nerf_tpu_torch.checkpoint import load_params_pickle, save_params_pickle

    # After 96 steps the trained grid still holds its initial value, decayed
    # (every cell occupied), where the levers select what the plain route
    # selects. The lever runs take the trained weights over the grid of the
    # ball the views show (write_scene's), where the levers change the
    # selection.
    params = load_params_pickle(str(root / "trained.pkl"))
    grid = np.asarray(params["occupancy_densities"])
    params.update(occupancy_densities=load_params_pickle(str(root / "ngp.pkl"))["occupancy_densities"],
                  occupancy_resolution=128)
    save_params_pickle(str(root / "trained_ball.pkl"), params)
    print(f"lever runs: the trained weights over the scene's ball grid (its own grid: {float((grid > 0.01).mean()):.4f} "
          f"of the cells occupied, from {grid.min():.6g} to {grid.max():.6g})", flush=True)
    pooled = ["--instant_ngp", "--occupancy", "--occ_budget_per_ray", "auto"]
    plain_psnr, plain_scores, _ = evaluate(root, "trained_ball.pkl", mode=pooled)
    counts = {}
    for label, flags in LEVER_RUNS.items():
        (mean, scores, _), counts[f"eval_psnr {label}"] = counted(
            label, lambda: evaluate(root, "trained_ball.pkl", flags, mode=pooled))
        print(f"eval_psnr {' '.join(pooled + flags)} on the dense run over the ball grid: mean_psnr={mean:.3f} "
              f"({[round(float(v), 3) for v in scores]}) beside the plain pooled {plain_psnr:.3f} "
              f"({[round(float(v), 3) for v in plain_scores]}) and the dense run's own {dense_psnr:.3f}; shortfall "
              f"{plain_psnr - mean:.4f} dB (bound {LEVER_PSNR_SHORTFALL:g} dB)", flush=True)
        require(plain_psnr - mean <= LEVER_PSNR_SHORTFALL, f"eval_psnr with {label} fell short of the plain pooled score")

    out = root / "distilled"
    argv = [*pooled, *SPAN_FLAGS, "--seed", str(SEED), "--batch_size", "8192", "--num_images", "2", "--size",
            str(SIDE // 2), "--model_path", str(root / "trained_ball.pkl"), str(root / "heldout" / "metadata.json"),
            str(out)]
    _, counts["render_new_dataset"] = counted("render_new_dataset", lambda: quiet(render_new_dataset.main, argv))
    from PIL import Image

    depths = []
    for i in range(2):
        rgb = np.asarray(Image.open(out / f"{i:05}.png"))
        depths.append(np.asarray(Image.open(out / f"{i:05}_depth.png")))
        require(rgb.shape == (SIDE // 2, SIDE // 2, 3) and depths[-1].shape == (SIDE // 2, SIDE // 2)
                and depths[-1].dtype == np.uint16 and (out / f"{i:05}.json").exists(),
                f"render_new_dataset view {i}: {rgb.shape}, {depths[-1].shape} {depths[-1].dtype}")
    require((out / "metadata.json").read_text() == (root / "heldout" / "metadata.json").read_text(),
            "render_new_dataset did not copy metadata.json")
    # View 0 again through the CLI's session (the same seed, so the same
    # draws): its depth is finite and is what the CLI wrote.
    args = render_new_dataset.argparser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        session = render_nerf.RenderSession(args, include_depth_outputs=True)
    view = CameraView.from_json(str(out / "00000.json"))
    frame = session.render_arrays(view, SIDE // 2, SIDE // 2)
    depth = render_new_dataset.depth_image(view, frame["alphas"], frame["coords"], args.max_depth)
    del session
    opaque = [float((d < 0xFFFF).mean()) for d in depths]
    print(f"render_new_dataset, 2 views of {SIDE // 2}x{SIDE // 2} ({' '.join(pooled + SPAN_FLAGS)}): opaque "
          f"share of the depth images {[round(v, 4) for v in opaque]}, alpha of view 0 in "
          f"[{frame['alphas'].min():.4f}, {frame['alphas'].max():.4f}]; (launches, plain calls) "
          f"{counts['render_new_dataset']}", flush=True)
    require(np.isfinite(depth).all() and np.isfinite(frame["coords"]).all()
            and np.array_equal((depth.reshape(SIDE // 2, SIDE // 2) * 0xFFFF).astype(np.uint16), depths[0]),
            "render_new_dataset's depth is not finite or not the frame's")

    metadata = str(root / "heldout" / "metadata.json")
    args = marching_cubes.argparser().parse_args(
        ["--instant_ngp", "--model_path", str(root / "trained.pkl"), metadata, "unused.obj"])
    meta = ModelMetadata.from_json(metadata)
    fine = marching_cubes.load_fine(args, meta, device)
    coords = marching_cubes.grid_coordinates(meta.bbox_min, meta.bbox_max, MESH_RESOLUTION).reshape(-1, 3)
    volume, _ = counted("the marching_cubes sweep", lambda: marching_cubes.occupancy_volume(fine, coords, 8192, device))
    with plain_routes():
        plain = marching_cubes.occupancy_volume(fine, coords, 8192, device)
    err = float(np.abs(volume - plain).max())
    del fine
    obj = root / "ball.obj"
    threshold = round(float(volume.min() + volume.max()) / 2, 3)  # a surface between the extremes
    log, counts["marching_cubes"] = counted("marching_cubes", lambda: quiet(marching_cubes.main, [
        "--instant_ngp", "--resolution", str(MESH_RESOLUTION), "--threshold", str(threshold),
        "--model_path", str(root / "trained.pkl"), metadata, str(obj)]))
    print(f"marching_cubes --resolution {MESH_RESOLUTION}: the sweep's {coords.shape[0]} occupancies by the encode "
          f"kernel against the plain encode on the card: max abs err {err:.3e} (bound {MESH_BOUND:g}), occupancy "
          f"mean {volume.mean():.4f}, threshold {threshold}; {log.strip().splitlines()[-1]}; (launches, plain calls) "
          f"{counts['marching_cubes']}", flush=True)
    require(err <= MESH_BOUND, "the marching_cubes sweep disagrees with the plain route")

    spin = root / "spin.png"
    _, counts["render_nerf_spin"] = counted("render_nerf_spin", lambda: quiet(render_nerf_spin.main, [
        *pooled, *SPAN_FLAGS, "--seed", str(SEED), "--batch_size", "8192", "--width", str(SIDE // 2), "--height",
        str(SIDE // 2), "--frames", "4", "--model_path", str(root / "trained_ball.pkl"), metadata,
        str(root / "heldout" / "0000.json"), str(spin)]))
    reel = np.asarray(Image.open(spin))
    print(f"render_nerf_spin, 4 frames: reel {reel.shape}; (launches, plain calls) {counts['render_nerf_spin']}",
          flush=True)
    require(reel.shape == (SIDE // 2, 4 * SIDE // 2, 3) and reel.std() > 0, f"render_nerf_spin's reel is {reel.shape}")
    for run, c in counts.items():
        require(c["hashgrid_encode"][0] > 0, f"{run} never launched hashgrid_encode: {c}")
    for run in ("render_new_dataset", "render_nerf_spin", *(f"eval_psnr {label}" for label in LEVER_RUNS)):
        require(counts[run]["composite_pooled"][0] > 0, f"{run} did not composite in the pool layout: {counts[run]}")
    torch.cuda.empty_cache()
    return counts


def quiet(main, argv):
    """``main(argv)`` with its standard output captured; returns the text."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        main(argv)
    return log.getvalue()


def print_normal_mse(name, records):
    """Print a run's fine ``normal_mse``: the mean of its first sixth of
    steps and of its last, as train_run reads its loss.  It is printed and
    not held to fall: with the JAX package's weight (3e-4) it rises while
    the density sharpens, in the JAX package too (PERF.md, section 6)."""
    normal = [float(v["fine_normal_mse"]) for v, _ in records]
    head = max(len(normal) // 6, 1)
    first, last = float(np.mean(normal[:head])), float(np.mean(normal[-head:]))
    print(f"{name}: fine normal_mse, mean of the first {head} steps {first:.5f}, of the last {head} {last:.5f}",
          flush=True)
    require(np.isfinite(normal).all(), f"{name}: a normal_mse that is not finite")


def ref_nerf_phase(root, device, profile):
    """The Ref-NeRF hybrid through ``train_nerf --instant_ngp --ref_nerf
    --occupancy`` at bench_occupancy's width on the ball (TRAIN_STEPS
    steps: the loss falls, normal_mse is printed; the encode, table-gradient,
    hashgrid_dx, its backward and composite kernels launched on every
    step, the encode and hashgrid_dx kernels once more a grid refresh, no
    plain version), scored by ``eval_psnr`` on the held-out views, served,
    and its frame held to the eager route (``check_frame_graph_mode``).  Returns ``{run: {kernel: (launches, plain calls)}}``."""
    from learn_nerf_tpu_torch.scripts import profile_train

    mode = ["--instant_ngp", "--ref_nerf", "--occupancy"]
    flags = [*mode, "--seed", str(SEED), "--lr", "1e-2", "--batch_size", str(TRAIN_RAYS),
             "--occ_warmup", str(TRAIN_WARMUP)]
    name = "train ref-nerf ngp"
    counts, records, _, loop = train_run(root, name, flags, "trained_refnerf.pkl")
    refreshes = TRAIN_STEPS // 16
    require(loop.grid_state.step == refreshes, f"{name}: {loop.grid_state.step} grid updates")
    del loop
    want = dict(hashgrid_encode=TRAIN_STEPS + refreshes, hashgrid_backward=TRAIN_STEPS,
                hashgrid_dx=TRAIN_STEPS + refreshes, hashgrid_dx_backward=TRAIN_STEPS, composite=TRAIN_STEPS,
                composite_backward=TRAIN_STEPS, composite_pooled=0)
    require(all(counts[k][0] == v for k, v in want.items()), f"the {name} run's launches {counts} are not {want}")
    print_normal_mse(name, records)
    mean, scores, ssims = evaluate(root, "trained_refnerf.pkl", mode=mode)
    print(f"eval_psnr {' '.join(mode)} on the {name} run ({TRAIN_STEPS} steps), {HELDOUT_VIEWS} held-out views: "
          f"mean_psnr={mean:.3f} ({[round(float(v), 3) for v in scores]}), "
          f"ssim {[round(float(v), 4) for v in ssims]}", flush=True)
    served, _ = serve_mode(root, "trained ref-nerf ngp occupancy", mode, bf16=False,
                           checkpoint="trained_refnerf.pkl", requests=1)
    check_frame_graph_mode(root, device, "trained ref-nerf ngp occupancy", mode, False,
                           checkpoint="trained_refnerf.pkl")
    if profile:
        args = profile_train.argparser().parse_args([*flags, str(root / "train")])
        print("profile:", json.dumps({"mode": "ref-nerf ngp occupancy train step", **profile_train.profile_args(args)}),
              flush=True)
        torch.cuda.empty_cache()
    return {name: counts, "trained ref-nerf ngp occupancy": served}


def hierarchy_step_check(root, device, rng):
    """One full-width hierarchy step of each HIERARCHY_RUNS model (the
    flags' own loop, ``train_nerf.make_loop``): loss and gradients by the
    kernel route against the plain route on the card, from the same
    weights, batch and uniforms, one graph alive at a time.  Both passes'
    composite pairs (K = 64 and the long-ray path at K = 192, which share the
    background's gradient) and, in NGP, both models' encode and
    table-gradient kernels launch once each; the plain route launches
    none."""
    from learn_nerf_tpu_torch.data.dataset import load_dataset
    from learn_nerf_tpu_torch.scripts import train_nerf

    data = load_dataset(str(root / "train"))
    rays = np.concatenate([v.rays() for v in data.views])
    batch = torch.from_numpy(rays[rng.permutation(len(rays))[:TRAIN_RAYS]]).to(device)
    u_coarse = torch.from_numpy(rng.rand(TRAIN_RAYS, COARSE_SAMPLES).astype(np.float32)).to(device)
    u_fine = torch.from_numpy(rng.rand(TRAIN_RAYS, FINE_SAMPLES).astype(np.float32)).to(device)
    counters = kernel_counters()
    for name, (flags, _) in HIERARCHY_RUNS.items():
        args = train_nerf.build_parser().parse_args([*HIERARCHY_FLAGS, *flags, str(root / "train")])
        torch.manual_seed(SEED)
        loop = train_nerf.make_loop(args, data.metadata, args.lr, device)
        leaves = [(f"{m}.{n}", p) for m, model in loop._models.items() for n, p in model.named_parameters()]
        leaves.append(("background", loop.background))

        def step():
            loop.optimizer.zero_grad(set_to_none=True)
            total, values = loop._loss(loop.renderer, loop.background, batch, u_coarse=u_coarse, u_fine=u_fine)
            total.backward()
            normal = {k: float(v.detach()) for k, v in values.items() if k.endswith("normal_mse")}
            return total.item(), {k: p.grad.detach().clone() for k, p in leaves}, normal

        for c in counters.values():
            c.reset()
        loss, got, normal = step()
        launched = {k: c.launches for k, c in counters.items() if c.launches}
        ngp = "--instant_ngp" in flags
        want = dict(composite=2, composite_backward=2, **(dict(hashgrid_encode=2, hashgrid_backward=2) if ngp else {}))
        if ngp and "--ref_nerf" in flags:
            want.update(hashgrid_dx=2, hashgrid_dx_backward=2)
        require(launched == want, f"{name}: the kernel route's step launched {launched}, not {want}")
        with plain_routes():
            ref_loss, want_grads, ref_normal = step()
        require({k: c.launches for k, c in counters.items() if c.launches} == launched,
                f"{name}: the plain route launched a kernel")
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        tables = {k: ((got[k] - want_grads[k]).norm() / want_grads[k].norm()).item() for k in got if "table" in k}
        others = {k: ((got[k] - want_grads[k]).abs().max() / want_grads[k].abs().max()).item()
                  for k in got if "table" not in k}
        flat_got, flat_want = (torch.cat([g[k].flatten() for k in got]) for g in (got, want_grads))
        errs = {"tables L2": max(tables.values(), default=0.0), "others max": max(others.values()),
                "all L2": ((flat_got - flat_want).norm() / flat_want.norm()).item(),
                "normal_mse": max((abs(normal[k] - v) / abs(v) for k, v in ref_normal.items()), default=0.0)}
        worst = max(others, key=others.get)
        worst_table = max(tables, key=tables.get) if tables else None
        missing = [k for k in got if got[k].abs().max() == 0]
        bounds = HIERARCHY_GRAD_BOUNDS[name]
        print(f"{name} step, kernel route vs plain route on the card: loss {loss:.7f} vs {ref_loss:.7f} "
              f"(relative {loss_err:.2e}, bound {HIERARCHY_LOSS_BOUND:g}); gradients: table gradients by L2, "
              f"relative, worst {worst_table} {errs['tables L2']:.2e}; other gradients relative to each tensor's "
              f"max, worst {worst} {errs['others max']:.2e}, background {others['background']:.2e}; all "
              f"gradients together by L2, relative, {errs['all L2']:.2e}; normal_mse terms "
              + ", ".join(f"{k} {normal[k]:.7f} vs {v:.7f}" for k, v in ref_normal.items())
              + f" (relative, worst {errs['normal_mse']:.2e}; bounds {bounds}); gradients that are zero: {missing}",
              flush=True)
        require(np.isfinite(loss) and loss_err <= HIERARCHY_LOSS_BOUND, f"{name}: the step's loss disagrees")
        require(all(errs[k] <= v for k, v in bounds.items()) and not missing, f"{name}: the step's gradients disagree")
        del loop, leaves, got, want_grads
        torch.cuda.empty_cache()


def hierarchy_phase(root, profile):
    """``train_nerf`` without ``--occupancy`` at full width on the ball:
    each HIERARCHY_RUNS run (the loss falls; the composite pair, forward and
    backward, at 4096 x 64 and 4096 x 192 on every step; in NGP the encode
    and table-gradient kernels twice a step), each scored by ``eval_psnr``
    on the held-out views; then the f32 run again, stopped after step
    RESUME_AT + 1 with its full state saved at RESUME_AT, and resumed from
    that state to the end: the step counter and the lr continue, and every
    resumed step's losses equal the uninterrupted run's within
    RESUME_BOUND.  With ``profile``, each run's step profiled
    (``scripts.profile_train --hierarchy``).  Returns ``{run: {kernel:
    (launches, plain calls)}}``."""
    counts, records = {}, {}
    for name, (flags, steps) in HIERARCHY_RUNS.items():
        checkpoint = name.replace(" ", "_") + ".pkl"
        counts[name], records[name], _, loop = train_run(root, name, [*HIERARCHY_FLAGS, *flags], checkpoint,
                                                         steps=steps)
        del loop
        ngp = "--instant_ngp" in flags
        dx = ngp and "--ref_nerf" in flags
        want = dict(composite=2 * steps, composite_backward=2 * steps, composite_pooled=0,
                    hashgrid_encode=2 * steps if ngp else 0, hashgrid_backward=2 * steps if ngp else 0,
                    hashgrid_dx=2 * steps if dx else 0, hashgrid_dx_backward=2 * steps if dx else 0)
        require(all(counts[name][k][0] == v for k, v in want.items()),
                f"the {name} run's launches {counts[name]} are not {want}")
        if name in REF_NERF_RUNS:
            print_normal_mse(name, records[name])
        mode = [f for f in flags if f in ("--instant_ngp", "--bf16", "--ref_nerf")]
        mean, scores, ssims = evaluate(root, checkpoint, mode=mode)
        print(f"eval_psnr {' '.join(mode)} on the {name} run ({steps} steps), {HELDOUT_VIEWS} held-out views: "
              f"mean_psnr={mean:.3f} ({[round(float(v), 3) for v in scores]}), "
              f"ssim {[round(float(v), 4) for v in ssims]}", flush=True)

    name = "hierarchy f32"
    flags, steps = HIERARCHY_RUNS[name]
    state = root / "hierarchy_state.pt"
    resume_flags = [*HIERARCHY_FLAGS, *flags, "--full_state_path", str(state), "--save_interval", str(RESUME_AT - 1)]
    _, stopped, _, _ = train_run(root, f"{name}, stopped after step {RESUME_AT + 1}", resume_flags,
                                 "hierarchy_resumed.pkl", steps=steps, stop_at=RESUME_AT + 1)
    from learn_nerf_tpu_torch.checkpoint import peek_train_state_step

    saved_at = peek_train_state_step(str(state))
    _, resumed, _, loop = train_run(root, f"{name}, resumed from its full state", resume_flags,
                                    "hierarchy_resumed.pkl", steps=steps, expect=steps - RESUME_AT)
    whole = records[name]
    diffs = [max(abs(float(a[k]) - float(b[k])) for k in ("coarse", "fine"))
             for (a, _), (b, _) in zip(stopped[:RESUME_AT] + resumed, whole[:RESUME_AT] + whole[RESUME_AT:])]
    lrs_equal = [lr for _, lr in stopped[:RESUME_AT] + resumed] == [lr for _, lr in whole]
    bit_equal = all(d == 0 for d in diffs[RESUME_AT:])
    print(f"{name} resume: full state saved at step {saved_at}; resumed run {len(resumed)} steps, ends at train step "
          f"{loop.step_count} and optimizer step {loop._opt_count}; lr of every step equal to the uninterrupted "
          f"run's: {lrs_equal} (resumed lr {resumed[0][1]:.6e} -> {resumed[-1][1]:.6e}); losses against the "
          f"uninterrupted run: max abs difference {max(diffs):.3e} (bound {RESUME_BOUND:g}), bit-equal after the "
          f"resume: {bit_equal}", flush=True)
    require(saved_at == RESUME_AT and loop.step_count == loop._opt_count == steps and lrs_equal,
            f"{name}: the resumed run's step counter or lr did not continue")
    require(max(diffs) <= RESUME_BOUND, f"{name}: the resumed run's losses left the uninterrupted run's")
    del loop
    torch.cuda.empty_cache()
    if profile:
        from learn_nerf_tpu_torch.scripts import profile_train

        for name, (flags, _) in HIERARCHY_RUNS.items():
            args = profile_train.argparser().parse_args([*HIERARCHY_FLAGS, *flags, "--hierarchy", str(root / "train")])
            print("profile:", json.dumps({"mode": f"{name} train step", **profile_train.profile_args(args)}), flush=True)
            torch.cuda.empty_cache()
    return counts


def dp_flags(root):
    """The data-parallel phase's train flags: bench_occupancy's width, auto
    pooling from DP_POOL_START."""
    return ["--instant_ngp", "--occupancy", "--seed", str(SEED), "--lr", "1e-2", "--batch_size", str(TRAIN_RAYS),
            "--occ_warmup", str(TRAIN_WARMUP), "--occ_train_budget", "auto", "--occ_train_budget_start",
            str(DP_POOL_START), str(root / "train")]


def dp_batches(root, world):
    """DP_STEPS global batches of ``world * TRAIN_RAYS`` rays of the train
    scene, drawn from DP_SEED: the same in every process."""
    from learn_nerf_tpu_torch.data.dataset import load_dataset

    rays = np.concatenate([view.rays() for view in load_dataset(str(root / "train")).views])
    rng = np.random.RandomState(DP_SEED)
    return [rays[rng.choice(rays.shape[0], world * TRAIN_RAYS, replace=False)] for _ in range(DP_STEPS)]


def dp_train(root, device, mesh, batches):
    """The phase's loop (train_nerf's, on ``device`` over ``mesh``) through
    ``batches``, each timed to its end; returns the loop, the steps' logged
    values (on the host) and their ms."""
    from learn_nerf_tpu_torch.data.dataset import ModelMetadata
    from learn_nerf_tpu_torch.scripts import train_nerf

    args = train_nerf.build_parser().parse_args(dp_flags(root))
    torch.manual_seed(SEED)
    loop = train_nerf.make_loop(args, ModelMetadata.from_json(str(root / "train" / "metadata.json")), args.lr,
                                device, mesh)
    values, ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = loop.step_auto(DP_SEED, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        values.append({k: float(v) for k, v in step.items()})
    return loop, values, ms


def state_digest(loop):
    """sha256 of the loop's parameters and grid, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for t in [*loop._leaves(), loop.grid_state.densities]:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_rank(rank, world, port, root, out):
    """One rank of the data-parallel phase's part (a), in its own process:
    joins the group over gloo on the shared card, trains its rows of the
    global batches, times the gradient all-reduce, and writes its losses,
    step times, state digest and kernel counts to ``out`` (JSON)."""
    from learn_nerf_tpu_torch.parallel.mesh import all_reduce_mean_, default_mesh, init_distributed

    root = Path(root)
    require(init_distributed(f"localhost:{port}", world, rank, device_type="cuda", backend="gloo"),
            "the rank did not join the group")
    mesh = default_mesh()
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    batches = [b[rank * TRAIN_RAYS:(rank + 1) * TRAIN_RAYS] for b in dp_batches(root, world)]
    loop, values, ms = dp_train(root, mesh.devices[0], mesh, batches)
    counts = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
    grads = [p.grad for p in loop._leaves()]
    reduce_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_mean_(grads, mesh)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    Path(out).write_text(json.dumps(dict(
        device=str(mesh.devices[0]), backend=torch.distributed.get_backend(), values=values, ms=ms,
        reduce_ms=reduce_ms, gradient_floats=sum(g.numel() for g in grads), digest=state_digest(loop),
        bucket=loop._auto_per_ray, counts=counts)))
    torch.distributed.destroy_process_group()


def nccl_rank(root, out):
    """The data-parallel phase's part (b), in a process launched with
    torchrun's environment: ``train_nerf`` with ``--profile_dir`` as a
    one-rank NCCL group; then the all-reduce of its gradients timed with
    CUDA events.  Writes the log, the backend, the kernel counts and the
    all-reduce ms to ``out`` (JSON)."""
    from learn_nerf_tpu_torch.parallel.mesh import all_reduce_mean_
    from learn_nerf_tpu_torch.scripts import train_nerf

    root = Path(root)
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    argv = [*dp_flags(root)[:-1], "--steps", str(DP_STEPS), "--save_path", str(root / "nccl.pkl"),
            "--profile_dir", str(root / "nccl_trace"), str(root / "train")]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        loop = train_nerf.main(argv)
    counts = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
    grads = [p.grad for p in loop._leaves()]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    all_reduce_mean_(grads, loop._dp)
    start.record()
    for _ in range(20):
        all_reduce_mean_(grads, loop._dp)
    end.record()
    torch.cuda.synchronize()
    Path(out).write_text(json.dumps(dict(
        log=log.getvalue(), backend=torch.distributed.get_backend(), world=torch.distributed.get_world_size(),
        counts=counts, reduce_ms=start.elapsed_time(end) / 20, gradient_floats=sum(g.numel() for g in grads))))
    torch.distributed.destroy_process_group()


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_processes(name, commands, env, timeout=600):
    """Start every command at once (from the checkout's root), wait for all;
    fails unless each exits 0."""
    here = str(Path(__file__).resolve().parent)
    procs = [subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        require(p.returncode == 0, f"{name}: a process exited {p.returncode}:\n{out[-4000:]}")


def dp_against_one(root, device, env):
    """The data-parallel phase's part (a): DP_RANKS rank processes (gloo,
    sharing the card) through the global batches, then one process on them
    twice.  Returns the ranks' outputs, their seconds with the processes'
    start, the first one-process run's values, ms, digest and auto bucket,
    the fine loss's relative gap by step of rank 0 to that run and of the
    second one-process run to the first, and whether the two one-process
    runs ended bit-equal."""
    port = free_port()
    outs = [root / f"dp_rank{r}.json" for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    run_processes("the data-parallel ranks", [
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.dp_rank({r}, {DP_RANKS}, {port}, {str(root)!r}, "
                               f"{str(outs[r])!r})"] for r in range(DP_RANKS)], env)
    ranks_s = time.perf_counter() - t0
    ranks = [json.loads(out.read_text()) for out in outs]
    runs = []
    for _ in range(2):
        loop, values, ms = dp_train(root, device, None, dp_batches(root, DP_RANKS))
        runs.append((values, ms, state_digest(loop), loop._auto_per_ray))
        del loop
        torch.cuda.empty_cache()
    (ref, ref_ms, ref_digest, ref_bucket), (again, _, again_digest, _) = runs

    def relative(a, b):
        return [abs(x["fine"] - y["fine"]) / y["fine"] for x, y in zip(a, b)]

    return (ranks, ranks_s, ref, ref_ms, ref_digest, ref_bucket, relative(ranks[0]["values"], ref),
            relative(again, ref), again_digest == ref_digest)


def dp_runs(n):
    """``--dp_runs``: the data-parallel phase's part (a) alone, ``n`` times
    on the card, on the train scene; prints each run's largest fine loss
    gap of the ranks to one process and of one process to itself, then one
    JSON line of every run's gaps by step."""
    import os

    from learn_nerf_tpu_torch.kernels import build
    from learn_nerf_tpu_torch.parallel.mesh import LAUNCHER_ENV
    from learn_nerf_tpu_torch.scripts.common import default_device

    device = default_device()
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    env = {k: v for k, v in os.environ.items() if k not in (*LAUNCHER_ENV, "LOCAL_RANK", "MASTER_PORT")}
    env["CUDA_VISIBLE_DEVICES"] = "0"
    build.library()  # built once, before the ranks load it
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build.BUILD_DIR) as tmp:
        root = Path(tmp)
        write_train_scene(root / "train", np.random.RandomState(SEED + 7))
        for run in range(n):
            *_, gaps, self_gaps, self_equal = dp_against_one(root, device, env)
            results.append(dict(ranks=gaps, one_process=self_gaps, one_process_bit_equal=self_equal))
            print(f"data parallel run {run}: fine loss relative gap, ranks to one process max {max(gaps):.3e}, "
                  f"one process to itself max {max(self_gaps):.3e} (bit-equal state {self_equal})", flush=True)
    print(json.dumps({"dp_runs": results}))
    return 0


def parallel_phase(root, device):
    """Data parallelism on the card (see DP_RANKS and the lines before it):
    (a) DP_RANKS ranks sharing the card over gloo against one process on
    the global batch (the first loss bit-equal, the others within
    DP_LOSS_BOUND; parameters and grids bit-equal across the ranks; the
    train kernels launched on every step of every rank, the pool layout's
    from DP_POOL_START on); (b) ``train_nerf``
    as a one-rank NCCL group with ``--profile_dir`` (the loss falls, the
    checkpoint is written, the trace names hashgrid_encode); (c) frames
    over a device list against the one-device frame; (d) ``check_bbox`` and
    ``cv_nerf`` on the train scene.  Returns ``{run: {kernel: (launches,
    plain calls)}}``."""
    import os

    from learn_nerf_tpu_torch.checkpoint import load_params_pickle
    from learn_nerf_tpu_torch.data.camera import CameraView
    from learn_nerf_tpu_torch.parallel.mesh import LAUNCHER_ENV, Mesh, default_mesh
    from learn_nerf_tpu_torch.scripts import check_bbox, cv_nerf, render_nerf

    counts = {}
    env = {k: v for k, v in os.environ.items() if k not in (*LAUNCHER_ENV, "LOCAL_RANK", "MASTER_PORT")}
    env["CUDA_VISIBLE_DEVICES"] = "0"  # the ranks share one card
    # (a) the ranks, then the one process on the global batches, twice.
    ranks, ranks_s, ref, ref_ms, ref_digest, ref_bucket, gaps, self_gaps, self_equal = dp_against_one(
        root, device, env)
    refreshes = -(-DP_STEPS // 16)
    want = dict(hashgrid_encode=DP_STEPS + refreshes, hashgrid_backward=DP_STEPS, composite=DP_POOL_START,
                composite_backward=DP_POOL_START, composite_pooled=DP_STEPS - DP_POOL_START,
                composite_pooled_backward=DP_STEPS - DP_POOL_START)

    def median(xs):
        return float(np.median(xs))

    dense, pooled = slice(2, DP_POOL_START), slice(DP_POOL_START + 2, DP_STEPS)
    print(f"data parallel (a): {DP_RANKS} ranks sharing {ranks[0]['device']} over {ranks[0]['backend']}, "
          f"{TRAIN_RAYS} rays a rank, {DP_STEPS} steps ({ranks_s:.1f} s with the processes' start): step ms median "
          f"dense {[round(median(r['ms'][dense]), 3) for r in ranks]}, pooled "
          f"{[round(median(r['ms'][pooled]), 3) for r in ranks]}; one process on {DP_RANKS * TRAIN_RAYS} rays: "
          f"dense {median(ref_ms[dense]):.3f}, pooled {median(ref_ms[pooled]):.3f}; gloo all-reduce of the "
          f"{ranks[0]['gradient_floats']}-float gradient {[round(median(r['reduce_ms']), 3) for r in ranks]} ms; "
          f"auto bucket {[r['bucket'] for r in ranks]} (one process {ref_bucket}); fine loss relative gap to one "
          f"process max {max(gaps):.3e} (bound {DP_LOSS_BOUND:g}), by step {[float(f'{g:.2e}') for g in gaps]}; "
          f"one process run again: max {max(self_gaps):.3e}, by step {[float(f'{g:.2e}') for g in self_gaps]}, "
          f"state bit-equal {self_equal}; "
          f"digests equal across ranks {ranks[0]['digest'] == ranks[1]['digest']} (one process's "
          f"{'equal' if ref_digest == ranks[0]['digest'] else 'differs'}); (launches, plain calls) "
          f"{ranks[0]['counts']}", flush=True)
    require(all(r["backend"] == "gloo" for r in ranks) and len({r["digest"] for r in ranks}) == 1,
            "the ranks' parameters or grids differ")
    require(all(r["values"] == ranks[0]["values"] for r in ranks), "the ranks logged different values")
    require(all(r["bucket"] == ref_bucket for r in ranks), "the ranks' auto bucket is not one process's")
    require(all(v.get("fine_pool_dropped", 0) == 0 for r in ranks for v in r["values"]), "a rank dropped samples")
    require(gaps[0] == 0, f"the ranks' first loss is not one process's: relative gap {gaps[0]:.3e}")
    require(max(gaps) <= DP_LOSS_BOUND, f"the ranks' losses left one process's: relative gap {max(gaps):.3e}, "
            f"bound {DP_LOSS_BOUND:g}")
    for r, rank in enumerate(ranks):
        got = {k: tuple(v) for k, v in rank["counts"].items()}
        require(all(got[k][0] == v for k, v in want.items()) and all(p == 0 for _, p in got.values()),
                f"rank {r}'s launches {got} are not {want}, or it called a plain version")
        counts[f"data parallel rank {r}"] = got

    # (b) train_nerf as a one-rank NCCL group, as torchrun launches it.
    out = root / "nccl.json"
    nccl_env = dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE="1", RANK="0",
                    LOCAL_RANK="0")
    run_processes("train_nerf in a one-rank NCCL group", [
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.nccl_rank({str(root)!r}, {str(out)!r})"]], nccl_env)
    nccl = json.loads(out.read_text())
    fine = [float(v) for v in re.findall(r"^step \d+: fine=(\S+)", nccl["log"], re.M)]
    traces = sorted((root / "nccl_trace").glob("*.json"))
    named = any("hashgrid_encode" in trace.read_text() for trace in traces)
    got = {k: tuple(v) for k, v in nccl["counts"].items()}
    head = DP_STEPS // 4
    print(f"data parallel (b): train_nerf, {[line for line in nccl['log'].splitlines() if line.startswith('process')]}"
          f", {len(fine)} steps, fine loss mean of the first {head} {np.mean(fine[:head]):.5f}, of the last {head} "
          f"{np.mean(fine[-head:]):.5f}; NCCL all-reduce of the {nccl['gradient_floats']}-float gradient "
          f"{nccl['reduce_ms']:.4f} ms (CUDA events, 20 calls); traces {[t.name for t in traces]} name "
          f"hashgrid_encode: {named}; (launches, plain calls) {got}", flush=True)
    require(nccl["backend"] == "nccl" and nccl["world"] == 1, f"the group is {nccl['backend']} of {nccl['world']}")
    require(len(fine) == DP_STEPS and np.mean(fine[-head:]) < np.mean(fine[:head]), "the NCCL run's loss did not fall")
    require(int(load_params_pickle(str(root / "nccl.pkl"))["occupancy_host_step"]) == DP_STEPS,
            "rank 0 did not write the NCCL run's checkpoint")
    require(named, "the NCCL run's profiler trace does not name hashgrid_encode")
    require(all(got[k][0] == v for k, v in want.items()) and all(p == 0 for _, p in got.values()),
            f"the NCCL run's launches {got} are not {want}")
    counts["data parallel nccl train_nerf"] = got

    # (c) frames over a device list on the card.
    view = CameraView.from_json(str(root / "0000.json"))
    meshes = {"[cuda:0, cuda:0]": Mesh(devices=(torch.device("cuda", 0),) * 2)}
    if torch.cuda.device_count() > 1:
        meshes["every card"] = default_mesh()
    for name, (mode, bf16) in MESH_FRAME_MODES.items():
        args = render_nerf.argparser().parse_args(mode_flags(root, mode, bf16) + [str(root / "metadata.json")])
        with contextlib.redirect_stdout(io.StringIO()):
            one = render_nerf.RenderSession(args, device=torch.device("cuda", 0)).render_arrays(view, SIDE, SIDE)
        for label, mesh in meshes.items():
            with contextlib.redirect_stdout(io.StringIO()):
                session = render_nerf.RenderSession(args, mesh=mesh)
                frame, counts[f"mesh frame {name} {label}"] = counted(
                    name, lambda: session.render_arrays(view, SIDE, SIDE))
            err = float(np.abs(frame["outputs"] - one["outputs"]).max())
            print(f"data parallel (c): {name} frame over {label}: max abs err against one device {err:.3e} (bound "
                  f"{MESH_FRAME_BOUND:g}); (launches, plain calls) {counts[f'mesh frame {name} {label}']}",
                  flush=True)
            require(np.isfinite(frame["outputs"]).all() and err <= MESH_FRAME_BOUND,
                    f"the {name} frame over {label} left the one-device frame")
            del session
        torch.cuda.empty_cache()
    for label in meshes:
        c = {name: counts[f"mesh frame {name} {label}"] for name in MESH_FRAME_MODES}
        require(c["vanilla hierarchy --bf16"]["fused_mlp"][0] > 0
                and c["vanilla occupancy --bf16"]["fused_render"][0] > 0
                and c["ngp hierarchy"]["hashgrid_encode"][0] > 0 and c["ngp pooled"]["composite_pooled"][0] > 0,
                f"a frame over {label} did not launch its kernels: {c}")

    # (d) the last CLIs on the card.
    log, counts["check_bbox"] = counted("check_bbox", lambda: quiet(check_bbox.main, [str(root / "train")]))
    colours = {k: json.loads(v) for k, v in re.findall(r"^(\w+) color (\[.*\])$", log, re.M)}
    background = 128 / 127.5 - 1.0
    print(f"data parallel (d): check_bbox on the train scene: {colours} (the background is {background:.6f})",
          flush=True)
    require(sorted(colours) == ["max", "mean", "min"]
            and all(abs(c - background) < 1e-6 for v in colours.values() for c in v),
            "check_bbox: rays that miss the bbox see more than the background")
    argv = ["--instant_ngp", "--seed", str(SEED), "--lr", "1e-2", "--batch_size", str(TRAIN_RAYS),
            "--coarse_samples", str(COARSE_SAMPLES), "--fine_samples", str(FINE_SAMPLES), "--folds", str(CV_FOLDS),
            "--train_iters", str(CV_STEPS), str(root / "train")]
    with contextlib.redirect_stdout(io.StringIO()):
        results, counts["cv_nerf"] = counted("cv_nerf", lambda: cv_nerf.main(argv))
    print(f"data parallel (d): cv_nerf, {CV_FOLDS} folds of {CV_STEPS} steps: held-out losses "
          f"{[(round(loss, 5), Path(name).name) for loss, name in results]}; (launches, plain calls) "
          f"{counts['cv_nerf']}", flush=True)
    require(len(results) == TRAIN_VIEWS and all(np.isfinite(loss) for loss, _ in results),
            f"cv_nerf held out {len(results)} views")
    require(counts["cv_nerf"]["hashgrid_encode"][0] > 0 and counts["cv_nerf"]["composite"][0] > 0,
            f"cv_nerf did not launch the hierarchy's kernels: {counts['cv_nerf']}")
    torch.cuda.empty_cache()
    return counts


def cube_color(origins, dirs, half=0.5):
    """Colour rays by the face of the cube ``[-half, half]^3`` they first hit
    (black where they miss): the cube of the repo's synthetic test scene."""
    bmin, bmax = -half, half
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (bmin - origins) / dirs
        t1 = (bmax - origins) / dirs
    near = np.minimum(t0, t1)
    far = np.maximum(t0, t1)
    t_enter = np.maximum(near.max(axis=-1), 0.0)
    t_exit = far.min(axis=-1)
    hit = t_enter < t_exit
    pts = origins + dirs * t_enter[:, None]
    axis = np.argmax(np.abs(pts), axis=-1)
    sign = np.take_along_axis(pts, axis[:, None], axis=-1)[:, 0] > 0
    palette = np.array([[255, 60, 60], [60, 255, 60], [60, 60, 255], [255, 255, 60], [60, 255, 255],
                        [255, 60, 255]], dtype=np.uint8)
    colors = palette[axis * 2 + sign.astype(int)]
    colors[~hit] = 0
    return colors


def orbit_views(n, distance=2.0, fov=1.0):
    """``n`` cameras on a wavy orbit around the origin, looking at it."""
    from learn_nerf_tpu_torch.data.camera import CameraView

    views = []
    for i in range(n):
        theta = 2 * np.pi * i / n
        phi = 0.3 * np.sin(3 * theta)
        z = -np.array([np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)])
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        views.append(CameraView(tuple(z.tolist()), tuple((-z * distance).tolist()), tuple(x.tolist()),
                                tuple(y.tolist()), fov, fov))
    return views


def write_blender_capture(out_dir, res=BLENDER_SIDE, n_views=BLENDER_TRAIN_VIEWS, fov=BLENDER_FOV):
    """The Blender stand-in in the original NeRF format: ``n_views`` train
    and BLENDER_TEST_VIEWS test orbit views (at distance 2.3) of the cube,
    ``transforms_{split}.json`` with OpenGL ``transform_matrix`` columns
    (x right, y up, z backward) and ``{split}/r_i.png``, built by inverting
    the Blender converter's decode, as ``tools/make_blender_standin.py``
    writes it."""
    from PIL import Image

    for split, views in (("train", orbit_views(n_views, fov=fov)),
                         ("test", orbit_views(BLENDER_TEST_VIEWS, distance=2.3, fov=fov))):
        (out_dir / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i, view in enumerate(views):
            rays = view.bare_rays(res, res)
            Image.fromarray(cube_color(rays[:, 0], rays[:, 1]).reshape(res, res, 3)).save(
                out_dir / split / f"r_{i}.png")
            mat = np.eye(4)
            mat[:3, 0] = view.x_axis
            mat[:3, 1] = -np.asarray(view.y_axis)
            mat[:3, 2] = -np.asarray(view.camera_direction)
            mat[:3, 3] = view.camera_origin
            frames.append(dict(file_path=f"./{split}/r_{i}", transform_matrix=mat.tolist()))
        (out_dir / f"transforms_{split}.json").write_text(json.dumps(dict(camera_angle_x=fov, frames=frames)))


def quality_gate(root, seeds):
    """The JAX package's Blender stand-in gate through the port: the
    capture from write_blender_capture, converted by the port's
    ``convert.blender``, trained by ``train_nerf`` with the JAX recipe
    (GATE_FLAGS, GATE_STEPS steps, vanilla f32) at each seed, and scored by
    ``eval_psnr --occupancy`` on the test views; then scored with the
    levers (LEVER_RUNS) against the plain route, fixed-K and pooled
    (GATE_LEVER_MODES), each shortfall at most GATE_LEVER_SHORTFALL.
    Returns ``{seed: (mean PSNR, mean SSIM, {mode: {run: dB}})}`` and the
    last training run's kernel counts."""
    from learn_nerf_tpu_torch.checkpoint import load_params_pickle
    from learn_nerf_tpu_torch.convert import blender

    capture = root / "blender_capture"
    write_blender_capture(capture)
    for split in ("train", "test"):
        blender.main(["--split", split, str(capture), str(root / f"blender_{split}")])
    results = {}
    for seed in seeds:
        checkpoint = f"blender_{seed}.pkl"
        counts, _, _, loop = train_run(root, f"quality gate, seed {seed}", [*GATE_FLAGS, "--seed", str(seed)],
                                       checkpoint, steps=GATE_STEPS, data="blender_train", rays=GATE_RAYS)
        del loop
        require(counts["composite"][0] == counts["composite_backward"][0] == GATE_STEPS,
                f"the quality gate's run launched {counts}")
        mean, scores, ssims = evaluate(root, checkpoint, mode=("--occupancy",), data="blender_test",
                                       views=BLENDER_TEST_VIEWS, batch=4096)
        print(f"quality gate, seed {seed}: eval_psnr --occupancy on {BLENDER_TEST_VIEWS} test views: "
              f"mean_psnr={mean:.3f} mean_ssim={float(np.mean(ssims)):.4f} "
              f"({[round(float(v), 3) for v in scores]}); the JAX package's {JAX_GATE_PSNR} dB, floor "
              f"{GATE_FLOOR:g} dB", flush=True)
        grid = np.asarray(load_params_pickle(str(root / checkpoint))["occupancy_densities"])
        levers = {}
        for mode, flags in GATE_LEVER_MODES.items():
            plain = mean if mode == "fixed-K" else evaluate(root, checkpoint, mode=flags, data="blender_test",
                                                              views=BLENDER_TEST_VIEWS, batch=4096)[0]
            levers[mode] = {"plain": plain}
            for label, lever_flags in LEVER_RUNS.items():
                (levers[mode][label], _, _), _ = counted(label, lambda: evaluate(
                    root, checkpoint, lever_flags, mode=flags, data="blender_test", views=BLENDER_TEST_VIEWS,
                    batch=4096))
        print(f"quality gate, seed {seed}, its own grid {float((grid > 0.01).mean()):.4f} occupied: eval_psnr "
              f"with the levers beside the plain route, mean dB {levers} (shortfall bounds {GATE_LEVER_SHORTFALL} "
              f"dB)", flush=True)
        for mode, runs in levers.items():
            for label in LEVER_RUNS:
                require(runs["plain"] - runs[label] <= GATE_LEVER_SHORTFALL[label],
                        f"quality gate, seed {seed}: eval_psnr {mode} with {label} fell short of the plain route")
        results[seed] = (mean, float(np.mean(ssims)), levers)
        torch.cuda.empty_cache()
    return results, counts


def ngp_tree(rng, levels):
    """Full-width NGP tree in flax's layout: unit-scale tables, lecun-normal
    ``Dense_i`` kernels (64 wide, density_dim 16, 2 color layers, d_freqs
    4), small biases."""
    grids, tables = fine_schedule(levels)
    shapes = [(2 * levels, 64), (64, 16), (24 + 16, 64), (64, 64), (64, 3)]
    tree = {
        f"Dense_{i}": dict(
            kernel=(rng.randn(*s) / np.sqrt(s[0])).astype(np.float32),
            bias=(0.1 * rng.randn(s[1])).astype(np.float32),
        )
        for i, s in enumerate(shapes)
    }
    tree["HashGridEncoding_0"] = {
        f"table_{i}": rng.uniform(-1, 1, (min(g**3, t), 2)).astype(np.float32)
        for i, (g, t) in enumerate(zip(grids, tables))
    }
    return tree


def set_density_bias(tree, levels, rng):
    """Shift the density head's bias so the field's mean density in the
    ball (radius 0.45) is ``NGP_DENSITY``; returns the bias."""
    from learn_nerf_tpu_torch.checkpoint import ngp_params_from_flax
    from learn_nerf_tpu_torch.models import InstantNGPModel

    grids, tables = fine_schedule(levels)
    model = InstantNGPModel(table_sizes=tables, grid_sizes=grids, bbox_min=(-0.7,) * 3,
                            bbox_max=(0.7,) * 3)
    tree["Dense_1"]["bias"][0] = 0.0
    model.load_state_dict(ngp_params_from_flax(tree))
    x = rng.uniform(-0.45, 0.45, (16384, 3)).astype(np.float32)
    x = x[(x**2).sum(-1) < 0.45**2]
    with torch.inference_mode():
        raw = model(torch.from_numpy(x), torch.zeros(x.shape), spatial_only=True)[:, 0]
    bias = float(np.log(NGP_DENSITY) - np.log(torch.exp(raw).mean().item()))
    tree["Dense_1"]["bias"][0] = bias
    return bias


def write_scene(root, rng):
    """metadata.json, three orbit views, and a full-width checkpoint."""
    from learn_nerf_tpu_torch.checkpoint import save_params_pickle
    from learn_nerf_tpu_torch.data.camera import CameraView

    (root / "metadata.json").write_text(json.dumps({"min": [-0.7] * 3, "max": [0.7] * 3}))
    views = []
    for i in range(REQUESTS):
        theta = 2 * np.pi * i / REQUESTS
        z = -np.array([np.cos(theta), np.sin(theta), 0.3])
        z /= np.linalg.norm(z)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        view = CameraView(tuple(z.tolist()), tuple((-2.0 * z).tolist()),
                          tuple(x.tolist()), tuple(y.tolist()), 1.0, 1.0)
        (root / f"{i:04}.json").write_text(view.to_json())
        views.append(view)
    # Occupied: a ball of radius 0.45 around the origin; empty elsewhere.
    res = 128
    centers = (np.arange(res, dtype=np.float32) + 0.5) / res * 1.4 - 0.7
    zz, yy, xx = np.meshgrid(centers, centers, centers, indexing="ij")  # x fastest
    ball = (xx**2 + yy**2 + zz**2 < 0.45**2).reshape(-1)
    params = dict(
        coarse=flax_tree(rng), fine=flax_tree(rng),
        background=np.array([1.0, 1.0, 1.0], np.float32),
        occupancy_densities=np.where(ball, 5.0, 0.0).astype(np.float32),
        occupancy_resolution=res,
    )
    save_params_pickle(str(root / "nerf.pkl"), params)
    print(f"occupancy grid: {ball.mean():.3f} of {res}^3 cells occupied", flush=True)

    # The NGP checkpoint draws from its own seed: the vanilla phases see
    # the same weights and uniforms whether or not the NGP phases run.
    ngp_rng = np.random.RandomState(SEED + 1)
    coarse, fine = ngp_tree(ngp_rng, COARSE_LEVELS), ngp_tree(ngp_rng, FINE_LEVELS)
    biases = [set_density_bias(tree, levels, ngp_rng)
              for tree, levels in ((coarse, COARSE_LEVELS), (fine, FINE_LEVELS))]
    save_params_pickle(str(root / "ngp.pkl"), dict(
        params, coarse=coarse, fine=fine,
    ))
    print(f"NGP checkpoint: {COARSE_LEVELS} + {FINE_LEVELS} levels, density bias "
          f"{biases[0]:.4f} (coarse) / {biases[1]:.4f} (fine) for mean density "
          f"{NGP_DENSITY:g} in the ball", flush=True)
    return views


def check_frames(root, views, device, rng, modes, bf16):
    """The kernel route (card) against the plain route (CPU) on a 16x16
    view through each mode's frame renderer, with the same uniforms (and,
    for a pooled mode, the same budget, resolved on the CPU)."""
    from learn_nerf_tpu_torch.occ_render import render_frame_occupancy, resolve_auto_budget
    from learn_nerf_tpu_torch.render import render_frame
    from learn_nerf_tpu_torch.scripts import render_nerf

    rays = torch.from_numpy(views[0].bare_rays(16, 16))
    for name, mode in modes.items():
        argv = [*(["--bf16"] if bf16 else []), "--model_path", str(root / checkpoint_name(mode)),
                *mode, str(root / "metadata.json")]
        args = render_nerf.argparser().parse_args(argv)
        card = render_nerf.RenderSession(args, device=device)
        # A baked mode's CPU session serves the card's bake (a CPU bake of
        # 384^3 vertices through 16 hash-grid levels would take minutes).
        with serving_bake(copy.deepcopy(card.field).cpu() if "--baked" in mode else None):
            sessions = [card, render_nerf.RenderSession(args, device=torch.device("cpu"))]
        r = sessions[0].renderer
        occupancy = "--occupancy" in mode
        if occupancy:
            u = torch.from_numpy(rng.rand(1, 256, r.candidates).astype(np.float32))
        else:
            u = [(torch.from_numpy(rng.rand(256, r.coarse_ts).astype(np.float32)),
                  torch.from_numpy(rng.rand(256, r.fine_ts).astype(np.float32)))]
        cpu = sessions[1]
        budget = None
        if args.occ_budget_per_ray == "auto":
            budget = resolve_auto_budget(cpu.renderer, cpu.grid_state, rays, args.occ_t_eps, quiet=True)
        outs, following = [], None
        for s in sessions:
            dev = s.device
            with torch.inference_mode():
                if occupancy:
                    frame = functools.partial(
                        render_frame_occupancy, s.renderer, rays.to(dev), s.background, s.grid_state, tile_size=256,
                        transmittance_eps=args.occ_t_eps, uniforms=u.to(dev), budget_per_ray=budget)
                    if budget is not None and dev.type == "cuda":  # a pooled frame's kernels, in order
                        held = {}
                        following = after_selection(kernel_sequence(lambda: held.update(out=frame()), dev))
                        out = held["out"]
                    else:
                        out = frame()
                else:
                    out = render_frame(s.renderer, rays.to(dev), s.background, tile_size=256,
                                       uniforms=[(a.to(dev), b.to(dev)) for a, b in u])
            outs.append(out["outputs"].cpu())
        err = (outs[0] - outs[1]).abs().max().item()
        extra = f"; pool budget {budget} samples/ray, dropped {int(out['dropped'])}" if budget else ""
        print(f"{name} frame, kernel route vs plain route: max abs err {err:.3e} "
              f"(bound {FRAME_BOUND:g}){extra}", flush=True)
        if occupancy and budget is None and "--instant_ngp" in mode:
            with torch.inference_mode():
                ref, _ = cpu.renderer.render_rays(rays, cpu.background, cpu.grid_state, u=u[0])
            depth = -torch.log(ref["weights"][:, -1])
            depth = depth[depth > 1e-3]
            print(f"{name} inputs: optical depth of the {depth.numel()} rays that cross the ball: "
                  f"median {depth.median().item():.3f}, min {depth.min().item():.3f}, "
                  f"max {depth.max().item():.3f}", flush=True)
        if following is not None:
            # Each pooled tile packs right after its selection: no clamp or
            # scan between them (the block-word modes select by plain ops).
            print(f"{name} frame: the kernels right after each selection {following}", flush=True)
            require(all("pool_pack_kernel" in (f or "") for f in following)
                    and (following or "--occ_block_gather" in mode),
                    f"{name}: a pooled tile launched other kernels between the selection and the pack: {following}")
        require(torch.isfinite(outs[0]).all().item(), f"{name} frame is not finite")
        require(err <= FRAME_BOUND, f"{name} kernel route disagrees with the plain route")
        require(outs[0].std().item() > 1e-3, f"{name} frame is flat")


def same_frames(got, want):
    """Whether two frames' output dicts hold the same keys and bits."""
    return set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def graph_and_eager_frames(session, rays, frames=FRAME_GRAPH_FRAMES, render=None):
    """``frames`` frames of ``rays`` by the session's tile replays, then the
    same frames by its eager route (``session.graphs`` None) from the same
    generator states of ``session.generator`` (and the same escalated pool
    floor); returns both lists of output dicts.  ``render(rays)`` renders a
    frame: a ``RenderSession``'s own by default."""
    render = render or session._render
    generator, graphs = session.generator, session.graphs
    pool = getattr(session, "frames", None) or session
    floor = getattr(pool, "_escalated_floor", 0)
    states, got, want = [], [], []
    with torch.inference_mode():
        for _ in range(frames):
            states.append(generator.get_state())
            got.append(render(rays))
        session.graphs = None
        try:
            if hasattr(pool, "_escalated_floor"):
                pool._escalated_floor = floor
            for state in states:
                generator.set_state(state)
                want.append(render(rays))
        finally:
            session.graphs = graphs
    return got, want


def replay_device_ms(graph, device, reps=20):
    """One replay of ``graph`` timed three ways: by CUDA events (the mean of
    ``reps`` back-to-back replays after a warm one), and under the profiler
    as the sum of its kernels' durations and the union of its device
    intervals (``profile_render.device_summary``)."""
    from learn_nerf_tpu_torch.scripts.profile_render import device_summary

    graph.replay()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    events_ms = start.elapsed_time(end) / reps
    for _ in range(3):  # the profiler now and then records no device event (see ``profiled``)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize(device)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)["traceEvents"]
        kernels = [float(e["dur"]) / 1e3 for e in trace if e.get("ph") == "X" and e.get("cat") == "kernel"]
        if kernels:
            break
    return dict(events_ms=events_ms, kernel_sum_ms=sum(kernels), busy_ms=device_summary(trace)[0],
                kernels=len(kernels))


@contextlib.contextmanager
def frame_fault(name):
    """Inside, the frame graphs have the deliberate fault ``name`` (one of
    FRAME_GRAPH_FAULTS)."""
    from learn_nerf_tpu_torch import frame_graph

    if name == FRAME_GRAPH_FAULTS[0]:
        owner, attr = frame_graph.TileBuffers, "get"
        original = frame_graph.TileBuffers.get

        def faulty(self, buffer, shape, dtype, device):  # the rays copied into a scratch tensor, not the buffer
            buf = original(self, buffer, shape, dtype, device)
            seen = self.__dict__.setdefault("_seen", set())
            if buffer != "rays" or (shape, device) not in seen:
                seen.add((shape, device))
                return buf
            return torch.empty_like(buf)
    elif name == FRAME_GRAPH_FAULTS[1]:
        owner, attr = frame_graph.FrameGraphs, "follow"
        original = frame_graph.FrameGraphs.follow

        def faulty(self, reads):  # the first reads kept: nothing is dropped after
            if self._stamp is None:
                original(self, reads)
    else:
        owner, attr = frame_graph.TileOutputs, "add"
        original = frame_graph.TileOutputs.add

        def faulty(self, i, out):  # each tile's outputs copied after the next tile ran
            pending = self.__dict__.pop("_pending", None)
            if pending is not None:
                original(self, *pending)
            if i == self.num_tiles - 1:
                original(self, i, out)
            else:
                self._pending = (i, out)
    setattr(owner, attr, faulty)
    try:
        yield
    finally:
        setattr(owner, attr, original)


def changed_grid(session, in_place=True):
    """The session's grid with every cell of an odd x index emptied: in
    place (its densities' ``_version`` moves), or as a new state."""
    from learn_nerf_tpu_torch.acceleration import OccupancyGridState

    frames = session.frames
    r = frames.renderer.grid.resolution
    densities = frames.grid_state.densities if in_place else frames.grid_state.densities.clone()
    with torch.no_grad():
        densities.view(r, r, r)[..., 1::2] = 0.0
    if not in_place:
        frames.grid_state = OccupancyGridState(densities, frames.grid_state.step)


def frame_graph_session(root, device, mode, bf16, depth, bake=None, checkpoint=None):
    """``render_nerf``'s session of one mode on ``device`` (of ``checkpoint``
    when given), serving ``bake`` in a baked mode when given."""
    from learn_nerf_tpu_torch.scripts import render_nerf

    argv = mode_flags(root, mode, bf16, checkpoint) + [str(root / "metadata.json")]
    with serving_bake(bake):
        return render_nerf.RenderSession(render_nerf.argparser().parse_args(argv), device=device,
                                         include_depth_outputs=depth)


@contextlib.contextmanager
def replayed_launches():
    """Inside, ``{"launches": {kernel: launches}, "replays": n, "graphs":
    {ids}}``: the launches (by the name the CUDA function carries) that
    graph replays add to the wrappers' counters, the replays and the graphs
    replayed, filled as they replay."""
    from learn_nerf_tpu_torch.step_graph import StepGraphs

    names = {id(c): COUNTER_KERNELS.get(k, k) for k, c in kernel_counters().items()}
    claims = dict(launches={}, replays=0, graphs=set())
    replay = StepGraphs._replay

    def counting(self, graph, moved):
        replay(self, graph, moved)
        claims["replays"] += 1
        claims["graphs"].add(id(graph))
        for c, n, _ in moved:
            if n:  # a counter whose replays move only plain calls (the block words' candidate test)
                claims["launches"][names[id(c)]] = claims["launches"].get(names[id(c)], 0) + n

    StepGraphs._replay = counting
    try:
        yield claims
    finally:
        StepGraphs._replay = replay


def traced_call(call, device):
    """``profile_render.profile_call`` of ``call``, with the launches the
    wrappers' counters claim for that same call (``claimed``), those of
    them that graph replays claim (``claimed_graph``), the replays
    (``replays``) and the number of graphs replayed (``graphs``)."""
    from learn_nerf_tpu_torch.scripts.profile_render import profile_call

    counters = kernel_counters()
    before = {k: c.launches for k, c in counters.items()}
    with replayed_launches() as claims:
        seen = profile_call(call, device)
    claimed = {COUNTER_KERNELS.get(k, k): c.launches - before[k] for k, c in counters.items()
               if c.launches != before[k]}
    return dict(seen, claimed=claimed, claimed_graph=dict(claims["launches"]), replays=claims["replays"],
                graphs=len(claims["graphs"]))


def eager_calls(calls, in_graphs):
    """``{kernel: runs}`` of ``calls`` outside the graph replays."""
    return {k: v - in_graphs.get(k, 0) for k, v in calls.items() if v != in_graphs.get(k, 0)}


def replays_back_the_claims(seen):
    """Whether a ``traced_call``'s graph launches back what the replays
    claim: the host made a graph launch for every replay counted, and,
    where every replay is of one graph, the port's kernels of its fullest
    replay (the one with the most kernel records) times the replays equal
    the replays' claim, and no replay ran a port kernel more often than
    that one (a replay cannot run part of its graph: a shorter one lost
    records); else the replays' port kernels in all equal the claim."""
    per, totals = seen["graph_launch_port_calls"], seen["graph_launch_kernels"]
    if len(per) != seen["replays"]:
        return False
    if seen["graphs"] != 1:
        return seen["port_graph_calls"] == seen["claimed_graph"]
    fullest = per[max(range(len(per)), key=totals.__getitem__)]
    return ({k: v * len(per) for k, v in fullest.items()} == seen["claimed_graph"]
            and all(n <= fullest.get(k, 0) for calls in per for k, n in calls.items()))


def trace_matches(seen):
    """Whether a ``traced_call``'s trace backs its counters: the replays
    (``replays_back_the_claims``) and each of the port's kernels launched
    on its own as often as claimed."""
    return (replays_back_the_claims(seen) and eager_calls(seen["port_calls"], seen["port_graph_calls"])
            == eager_calls(seen["claimed"], seen["claimed_graph"]))


def lost_records(seen):
    """The kernel records a trace shows lost: its kernel launch calls with
    no kernel record, and the kernels each graph launch ran fewer than the
    fullest one (where every replay is of one graph, as in a frame's tiles
    and ``kernel_sequence``'s calls)."""
    counts = seen["graph_launch_kernels"]
    return seen["launches_without_kernel"] + sum(max(counts, default=0) - c for c in counts)


def trace_loss_explained(seen):
    """Whether a ``traced_call``'s trace differs from its counters only by
    kernel records the trace itself shows lost: it holds no kernel at all
    (the profiler lost the call's device side, see ``profiled``), or its
    replays back their claims and it lacks, never exceeds, launches of the
    port's kernels on their own, no more of them than its launch calls
    without a kernel record."""
    if not seen["kernels_launched"]:
        return True
    got = eager_calls(seen["port_calls"], seen["port_graph_calls"])
    want = eager_calls(seen["claimed"], seen["claimed_graph"])
    return (replays_back_the_claims(seen) and all(0 <= v <= want.get(k, 0) for k, v in got.items())
            and sum(want.values()) - sum(got.values()) <= seen["launches_without_kernel"])


def traced_until_matched(label, call, device):
    """``traced_call`` of ``call``, profiled again (up to three times) only
    while its trace differs from the counters by kernel records it shows
    lost (``trace_loss_explained``); any other difference fails at once.
    Every difference is printed with that call's time.  The caller requires
    ``trace_matches`` of what it returns."""
    for attempt in range(3):
        seen = traced_call(call, device)
        if trace_matches(seen):
            break
        print(f"  {label}: TRACE MISMATCH in the profiled call of {seen['profiled_ms']:.3f} ms "
              f"({seen['kernels_launched']} kernels): it ran the port's kernels {seen['port_calls']}, "
              f"{seen['port_graph_calls']} of them in replays; the counters claim {seen['claimed']}, "
              f"{seen['claimed_graph']} by {seen['replays']} replays of {seen['graphs']} graph(s); kernels a graph "
              f"launch {seen['graph_launch_kernels']}, launch calls without a kernel record "
              f"{seen['launches_without_kernel']} (try {attempt + 1} of 3)", flush=True)
        require(trace_loss_explained(seen), f"{label}: the trace differs from the counters by more than the kernel "
                "records it shows lost")
    counts = seen["graph_launch_kernels"]
    short = [i for i, n in enumerate(counts) if n < max(counts)]
    if short:  # printed for the record: a replay short of its siblings lost records
        print(f"  {label}: the profiled call's graph launches {short} hold fewer kernel records than the "
              f"others ({counts}); its replays' port kernels {seen['graph_launch_port_calls']}", flush=True)
    return seen


def check_frame_graph_mode(root, device, name, mode, bf16, depth=False, bake=None, checkpoint=None):
    """One mode's SIDE x SIDE frame of view 0 by tile replays and by the
    eager route from the same generator states, bit for bit (outputs, depth
    outputs, ``selected`` and ``dropped``), one capture a key and a replay
    a tile; then one more frame by replays under the profiler, whose trace
    must back the counters (``trace_matches``: each replay's port kernels
    as the replays claim them, and those launched on their own).  A trace
    that differs is profiled again (up to three times) only where it shows
    the kernel records it lost (``trace_loss_explained``); every difference
    is printed with that frame's time.  Returns the session's field (a
    baked mode's bake)."""
    from learn_nerf_tpu_torch.data.camera import CameraView

    rays = torch.from_numpy(CameraView.from_json(str(root / "0000.json")).bare_rays(SIDE, SIDE)).to(device)
    session = frame_graph_session(root, device, mode, bf16, depth, bake, checkpoint)
    got, want = graph_and_eager_frames(session, rays)
    graphs = session.graphs
    same = [same_frames(a, b) for a, b in zip(got, want)]

    def frame():
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            session._render(rays)
        torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) * 1e3

    seen = traced_until_matched(f"frame graphs, {name}", frame, device)
    pool = getattr(getattr(session, "frames", None), "last_pool", None)
    print(f"frame graphs, {name}: {FRAME_GRAPH_FRAMES} frames by replays bit-equal to eager {same}; "
          f"{graphs.captures} capture(s), {graphs.replays} replays, {graphs.drops} drops"
          f"{f', pool {pool}' if pool else ''}; a replayed frame under the profiler: {seen['host_launches']} host "
          f"launches, {seen['kernels_launched']} kernels, {seen['device_ms']:.3f} device ms of "
          f"{seen['profiled_ms']:.3f} ms; the port's kernels it ran {seen['port_calls']} "
          f"({seen['port_graph_calls']} in replays), the launches its counters claim {seen['claimed']} "
          f"({seen['claimed_graph']} by replays)", flush=True)
    require(all(same), f"frame graphs, {name}: the replayed frames differ from the eager route")
    require(graphs.captures >= 1 and graphs.replays >= FRAME_GRAPH_FRAMES and graphs.drops == 0,
            f"frame graphs, {name}: {graphs.captures} captures, {graphs.replays} replays, {graphs.drops} drops")
    require(seen["claimed_graph"] and trace_matches(seen),
            f"frame graphs, {name}: the replayed frame ran the port's kernels {seen['port_calls']} "
            f"({seen['port_graph_calls']} in replays), but its counters claim {seen['claimed']} "
            f"({seen['claimed_graph']} by replays)")
    field = getattr(session, "field", None)
    del session
    torch.cuda.empty_cache()
    return field


def check_frame_graphs(root, views, device, big_side=800):
    """Frames as tile replays on the card: each FRAME_GRAPH_MODES mode
    through ``check_frame_graph_mode``; the grid changed in place between
    frames, and the next frame's replays bit-equal to eager after the
    graphs were dropped; each deliberate fault (FRAME_GRAPH_FAULTS) caught;
    an 800x800 frame of frame_matrix's shell (its no-lever row) by replays
    and eagerly, and one of its tile replays timed by CUDA events beside
    the profiler's kernel sum and busy time.  The two Ref-NeRF models'
    frames go through ``check_frame_graph_mode`` once they are trained
    (``ref_nerf_phase``, ``hierarchy_phase``)."""
    from learn_nerf_tpu_torch.acceleration import OccupancyGrid
    from learn_nerf_tpu_torch.kernels import ngp_mlp as km
    from learn_nerf_tpu_torch.scripts import frame_matrix

    rays = torch.from_numpy(views[0].bare_rays(SIDE, SIDE)).to(device)
    bakes = {}
    for name, (mode, bf16, depth) in FRAME_GRAPH_MODES.items():
        bake_key = (mode[mode.index("--baked") + 1], mode[mode.index("--baked_pack") + 1]
                    if "--baked_pack" in mode else "1") if "--baked" in mode else None
        field = check_frame_graph_mode(root, device, name, mode, bf16, depth, bakes.get(bake_key))
        if bake_key is not None:
            bakes[bake_key] = field
    del bakes
    torch.cuda.empty_cache()

    # The grid changed in place between frames: the session's tables are
    # built again and the graphs dropped before the next replay.
    mode, bf16, depth = FRAME_GRAPH_MODES["ngp pooled"]
    session = frame_graph_session(root, device, mode, bf16, depth)
    graph_and_eager_frames(session, rays, 1)
    changed_grid(session)
    got, want = graph_and_eager_frames(session, rays, 1)
    graphs = session.graphs
    print(f"frame graphs after the grid changed in place: bit-equal to eager {same_frames(got[0], want[0])}; "
          f"{graphs.drops} graph(s) dropped, {graphs.captures} captures", flush=True)
    require(same_frames(got[0], want[0]) and graphs.drops >= 1,
            "frame graphs: a frame after the grid changed differs from the eager route")
    del session

    mode, bf16, depth = FRAME_GRAPH_MODES["ngp occupancy (fixed-K)"]
    for fault in FRAME_GRAPH_FAULTS:
        session = frame_graph_session(root, device, mode, bf16, depth)
        if fault == FRAME_GRAPH_FAULTS[1]:
            with frame_fault(fault):
                graph_and_eager_frames(session, rays, 1)
                changed_grid(session, in_place=False)
                got, want = graph_and_eager_frames(session, rays, 1)
        else:
            start = session.generator.get_state()
            with frame_fault(fault):
                got, _ = graph_and_eager_frames(session, rays)
            session.generator.set_state(start)
            _, want = graph_and_eager_frames(session, rays)  # fault-free eager frames from the same states
        differ = [i for i, (a, b) in enumerate(zip(got, want)) if not same_frames(a, b)]
        print(f"frame graphs fault, {fault}: the routes differ at frames {differ}", flush=True)
        require(differ, f"frame graphs: the fault '{fault}' went unseen")
        del session
    torch.cuda.empty_cache()

    # One big_side^2 frame of frame_matrix's shell, no levers (79 tiles at 800).
    model = frame_matrix.seeded_ngp(device)
    grid = OccupancyGrid(resolution=128, **frame_matrix.BBOX)
    cfg = dict(frame_matrix.BASE, **frame_matrix.CONFIGS["live_no_levers"])
    frames = frame_matrix.frame_session(cfg, model, grid, frame_matrix.shell_grid_state(grid, device), 8192, 1e-2, {})
    frames.generator = torch.Generator(device=device).manual_seed(SEED)
    big = torch.from_numpy(frame_matrix.frame_view().bare_rays(big_side, big_side)).to(device)
    got, want = graph_and_eager_frames(frames, big, render=lambda r: frames.render(r, frames.generator))
    same = [same_frames(a, b) for a, b in zip(got, want)]
    # The NGP MLP kernel once a pooled tile: one replay a tile moves its counter.
    launches = km.counter.launches
    with torch.inference_mode():
        frames.render(big, frames.generator)
    mlp_launches, tiles = km.counter.launches - launches, -(-big_side * big_side // 8192)
    print(f"frame graphs, {big_side}x{big_side} frame by replays: ngp_mlp launched {mlp_launches} times "
          f"({tiles} tiles)", flush=True)
    require(mlp_launches == tiles, f"the {big_side}x{big_side} pooled frame did not run ngp_mlp once a tile")
    graph = next(iter(frames.graphs._graphs.values()))[0]
    times = replay_device_ms(graph, device)
    print(f"frame graphs, {big_side}x{big_side} frame_matrix live_no_levers: {FRAME_GRAPH_FRAMES} frames by replays "
          f"bit-equal to eager {same}; {frames.graphs.captures} capture(s), {frames.graphs.replays} replays, pool "
          f"{frames.last_pool}; one tile's replay: {times['events_ms']:.4f} ms by CUDA events, "
          f"{times['kernel_sum_ms']:.4f} ms its {times['kernels']} kernels' sum and {times['busy_ms']:.4f} ms busy "
          f"under the profiler", flush=True)
    require(all(same) and int(got[-1]["dropped"]) == 0,
            f"frame graphs: the {big_side}x{big_side} frame's replays differ from the eager route or dropped samples")
    del frames, model
    torch.cuda.empty_cache()


def lever_renderer(grid, **levers):
    """An occupancy renderer of the main path's selection (192 candidates,
    32 samples) on ``grid``, with ``levers``; selection only (no model)."""
    from learn_nerf_tpu_torch.occ_render import OccupancyRenderer

    return OccupancyRenderer(model=None, grid=grid, bbox_min=grid.bbox_min, bbox_max=grid.bbox_max, candidates=192,
                             samples=32, **levers)


def span_misses(renderer, grid, state, rays, samples=LEVER_CHECK_SAMPLES, chunk=1024):
    """The brute-force check of a span: each ray's bbox range sampled at
    ``samples`` midpoints against the full-resolution grid; returns the
    number of rays in the bbox with an occupied sample that the ray's span
    (with ``hit``) does not contain, and the number with any occupied
    sample."""
    from learn_nerf_tpu_torch.ops.geometry import ray_bbox_range

    lo = torch.tensor(grid.bbox_min, device=rays.device)
    hi = torch.tensor(grid.bbox_max, device=rays.device)
    missed = crossing = 0
    frac = (torch.arange(samples, device=rays.device, dtype=torch.float32) + 0.5) / samples
    for part in rays.split(chunk):
        o, d = part[:, 0], part[:, 1]
        t_min, t_max, mask = ray_bbox_range(o, d, lo, hi, renderer.min_t_range)
        t_lo, t_hi, hit = renderer._occupied_span(o, d, t_min, t_max, state)
        ts = t_min[:, None] + (t_max - t_min)[:, None] * frac[None, :]
        occ = grid.occupied(state, o[:, None, :] + d[:, None, :] * ts[..., None]) & mask[:, None]
        # Slack of one f32 step at the bbox's scale around the span's ends.
        outside = (ts < t_lo[:, None] - 1e-5) | (ts > t_hi[:, None] + 1e-5) | ~hit[:, None]
        missed += int((occ & outside).any(dim=1).sum())
        crossing += int(occ.any(dim=1).sum())
    return missed, crossing


def check_lever_invariants(root, device, rng):
    """The selection levers' invariants on the card, on the scene's 128^3
    grid (the ball) and on frame_matrix's shell grid, over one tile of
    LEVER_TILE rays of a frame, with the transmittance prune off: block
    words at stride 1 select exactly what the per-cell gather selects, span
    block words at stride 1 give the per-cell span exactly, at stride 4
    both only add (occupancy a superset, spans that contain the per-cell
    spans), and no span skips an occupied cell on a ray through it (the
    brute-force check of ``span_misses``, which a span of
    UNDERSIZED_PROBES probes must fail on the shell).  Each failure is
    fatal."""
    from learn_nerf_tpu_torch import occ_render
    from learn_nerf_tpu_torch.acceleration import OccupancyGrid
    from learn_nerf_tpu_torch.checkpoint import load_params_pickle
    from learn_nerf_tpu_torch.data.camera import CameraView
    from learn_nerf_tpu_torch.ops.geometry import ray_bbox_range
    from learn_nerf_tpu_torch.scripts import frame_matrix

    def one_tile(view, side):
        rays = torch.from_numpy(view.bare_rays(side, side)).to(device)
        return rays[:: rays.shape[0] // LEVER_TILE][:LEVER_TILE].contiguous()

    ball = OccupancyGrid(bbox_min=(-0.7,) * 3, bbox_max=(0.7,) * 3, resolution=128)
    shell = OccupancyGrid(resolution=128, **frame_matrix.BBOX)
    # The ball is thick enough that a few probes still find it; the thin
    # shell is where an undersized probe count must show.
    cases = {
        "the scene's ball": (ball, ball.state_from_checkpoint(load_params_pickle(str(root / "ngp.pkl")), device),
                             one_tile(CameraView.from_json(str(root / "0000.json")), SIDE), False),
        "the shell grid": (shell, frame_matrix.shell_grid_state(shell, device), one_tile(frame_matrix.frame_view(), 800),
                           True),
    }
    with torch.inference_mode():
        for name, (grid, state, rays, catch) in cases.items():
            u = torch.from_numpy(rng.rand(rays.shape[0], 192).astype(np.float32)).to(device)
            select = {k: lever_renderer(grid, block_gather_stride=k)._select_candidates(rays, state, 0.0, u=u)
                      for k in (0, 1, 4)}
            same = all(torch.equal(a, b) for a, b in zip(select[0], select[1]))
            occ0, occ4 = select[0][1], select[4][1]
            lo, hi = torch.tensor(grid.bbox_min, device=device), torch.tensor(grid.bbox_max, device=device)
            t_min, t_max, _ = ray_bbox_range(rays[:, 0], rays[:, 1], lo, hi, 1e-3)
            spans = {k: lever_renderer(grid, span_candidates=64, span_block_gather=k)._occupied_span(
                rays[:, 0], rays[:, 1], t_min, t_max, state) for k in (0, 1, 4)}
            span_same = all(torch.equal(a, b) for a, b in zip(spans[0], spans[1]))
            (lo0, hi0, hit0), (lo4, hi4, hit4) = spans[0], spans[4]
            widens = bool((hit4 | ~hit0).all() and (lo4 <= lo0)[hit0].all() and (hi4 >= hi0)[hit0].all())
            misses = {label: span_misses(lever_renderer(grid, span_candidates=64, **levers), grid, state, rays)
                      for label, levers in (("per-cell", {}), ("block words 4", dict(span_block_gather=4)))}
            needed = occ_render.min_span_candidates(128, 8, grid.bbox_min, grid.bbox_max)
            original = occ_render.min_span_candidates
            occ_render.min_span_candidates = lambda *args: 0  # let an undersized count through
            try:
                undersized = span_misses(lever_renderer(grid, span_candidates=UNDERSIZED_PROBES), grid, state, rays)
            finally:
                occ_render.min_span_candidates = original
            extra = float((occ4 & ~occ0).float().sum() / occ0.sum().clamp(min=1))
            print(f"lever invariants on {name}, {rays.shape[0]} rays: block words 1 select as the cells "
                  f"{same}, span block words 1 span as the cells {span_same}; block words 4: occupancy a superset "
                  f"{bool((occ4 | ~occ0).all())} (+{extra:.4f} of the occupied candidates), spans contain the "
                  f"cells' {widens}; rays with an occupied sample outside the span (of rays crossing an occupied "
                  f"cell, {LEVER_CHECK_SAMPLES} samples a ray): span 64 {misses['per-cell']}, span block words 4 "
                  f"{misses['block words 4']}, {UNDERSIZED_PROBES} probes (under the {needed} needed) "
                  f"{undersized}", flush=True)
            require(same, f"{name}: block words at stride 1 do not select as the per-cell gather")
            require(span_same, f"{name}: span block words at stride 1 do not give the per-cell span")
            require(bool((occ4 | ~occ0).all()), f"{name}: block words at stride 4 dropped an occupied candidate")
            require(widens, f"{name}: span block words at stride 4 narrowed a span")
            require(all(m == 0 and c > 0 for m, c in misses.values()), f"{name}: a span skipped an occupied cell")
            require(undersized[0] > 0 or not catch,
                    f"{name}: the brute-force check did not catch {UNDERSIZED_PROBES} probes")


def png_size(body):
    require(body[:8] == b"\x89PNG\r\n\x1a\n", "response is not a PNG")
    width, height = struct.unpack(">II", body[16:24])
    return height, width


def checkpoint_name(mode):
    return "ngp.pkl" if "--instant_ngp" in mode else "nerf.pkl"


def mode_flags(root, mode, bf16, checkpoint=None):
    """Render flags of one mode: tiles of 4096 rays (hierarchy) or 8192
    (occupancy), ``SIDE`` x ``SIDE`` views."""
    batch = "8192" if "--occupancy" in mode else "4096"
    return ["--seed", str(SEED), *(["--bf16"] if bf16 else []), "--batch_size", batch,
            "--width", str(SIDE), "--height", str(SIDE),
            "--model_path", str(root / (checkpoint or checkpoint_name(mode))), *mode]


def profile_modes(root):
    """One profile_render line per render mode and numerics mode."""
    from learn_nerf_tpu_torch.data.camera import CameraView
    from learn_nerf_tpu_torch.scripts import profile_render, render_nerf

    view = CameraView.from_json(str(root / "0000.json"))
    runs = [(name, mode, bf16) for name, mode in VANILLA_MODES.items() for bf16 in (True, False)]
    runs += [(name, mode, False) for name, mode in {**NGP_MODES, **BAKED_MODES, **LEVER_SERVE_MODES}.items()]
    for name, mode, bf16 in runs:
        argv = mode_flags(root, mode, bf16) + [str(root / "metadata.json")]
        session = render_nerf.RenderSession(render_nerf.argparser().parse_args(argv))
        result = profile_render.profile_view(session, view)
        label = dict(mode=name, bf16=bf16, side=SIDE)
        print("profile:", json.dumps({**label, **result}), flush=True)
        del session
        torch.cuda.empty_cache()


@contextlib.contextmanager
def serving_bake(field):
    """Inside, with ``field`` given, ``render_nerf``'s sessions serve
    ``field`` as their bake in place of baking their own."""
    from learn_nerf_tpu_torch.scripts import render_nerf

    if field is None:
        yield
        return
    bake = render_nerf.apply_baking
    render_nerf.apply_baking = lambda args, fine: field
    try:
        yield
    finally:
        render_nerf.apply_baking = bake


def serve_mode(root, name, mode, bf16, checkpoint=None, requests=REQUESTS, bake=None, keep=None):
    """Serve, send the requests, return ``{kernel: (launches, plain
    calls)}`` of the serve phase and of the server's set-up (the bake in a
    baked mode).  With ``bake``, a baked mode serves that field and bakes
    nothing; with ``keep`` (a dict), ``keep["field"]`` is the field served."""
    from learn_nerf_tpu_torch.scripts import serve_nerf

    counters = kernel_counters()
    argv = mode_flags(root, mode, bf16, checkpoint) + ["--port", "0", str(root / "metadata.json")]
    for c in counters.values():
        c.reset()
    with serving_bake(bake):
        server = serve_nerf.make_server(serve_nerf.argparser().parse_args(argv))
    setup = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
    if keep is not None:
        keep["field"] = server.session.field
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    latencies, captured = [], None
    graphs = server.session.graphs
    try:
        for c in counters.values():
            c.reset()
        for i in range(requests):
            if i == 1:
                captured = (graphs.captures, graphs.replays)
            body = (root / f"{i:04}.json").read_bytes()
            req = urllib.request.Request(f"http://{host}:{port}/render", data=body, method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, ctype, png = resp.status, resp.headers.get("Content-Type"), resp.read()
            latencies.append((time.perf_counter() - t0) * 1e3)
            require(status == 200 and ctype == "image/png", f"request {i}: {status} {ctype}")
            require(png_size(png) == (SIDE, SIDE), f"request {i}: PNG is {png_size(png)}")
        counts = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
        frames = getattr(server.session, "frames", None)
        pool = frames.last_pool if frames is not None else None
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    require(not thread.is_alive(), "server thread did not stop")
    pool_note = f"; last frame's pool {pool}" if pool else ""
    setup_note = {k: v for k, v in setup.items() if v != (0, 0)}
    print(f"serve {name}{' --bf16' if bf16 else ''} {SIDE}x{SIDE}: latencies ms "
          f"{[round(v, 3) for v in latencies]}; (launches, plain calls) {counts}{pool_note}; "
          f"set-up {setup_note}; frame graphs: {graphs.captures} capture(s), {graphs.replays} replays "
          f"({captured} after the first request)", flush=True)
    require(not plain_called(counts) and not plain_called(setup),
            f"{name} serving or its set-up called a plain version: {counts}, {setup}")
    # Every request after the first is served by the tile replays of the
    # graphs the first one captured.
    require(graphs.replays > 0 and (requests == 1 or (captured[0] == graphs.captures
                                                          and graphs.replays > captured[1])),
            f"{name}: requests after the first captured again or replayed nothing: {captured}, "
            f"{graphs.captures} captures, {graphs.replays} replays")
    return counts, setup


def gate_seeds(seeds):
    """``--gate_seeds``: the quality gate alone at each seed, on the card;
    one JSON line of ``{seed: [mean PSNR, mean SSIM]}``."""
    from learn_nerf_tpu_torch.kernels import build
    from learn_nerf_tpu_torch.scripts.common import default_device

    default_device()
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build.BUILD_DIR) as tmp:
        results, _ = quality_gate(Path(tmp), seeds)
    print(json.dumps({"quality_gate": {seed: list(v) for seed, v in results.items()}}))
    return 0


def main():
    parser = argparse.ArgumentParser(description="Smoke test of the port on one card.")
    parser.add_argument("--profile", action="store_true",
                        help="also profile one render per mode (see the module doc)")
    parser.add_argument("--gate_seeds", type=int, nargs="+", default=None,
                        help="run only the Blender stand-in quality gate, at these seeds, and print each score")
    parser.add_argument("--dp_runs", type=int, default=None,
                        help="run only the data-parallel comparison (ranks against one process), this many times, "
                             "and print each run's loss gaps")
    parser.add_argument("--graph_runs", type=int, default=None,
                        help="run only the step graph's comparison (graph route against eager steps), this many "
                             "times, and print each run's loss and parameter gaps")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card", file=sys.stderr)
        return 2
    if args.gate_seeds is not None:
        return gate_seeds(args.gate_seeds)
    if args.dp_runs is not None:
        return dp_runs(args.dp_runs)
    if args.graph_runs is not None:
        return graph_runs(args.graph_runs)
    started = time.perf_counter()

    from learn_nerf_tpu_torch.kernels import build
    from learn_nerf_tpu_torch.scripts.common import default_device

    device = default_device()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s", flush=True)
    log = (build.library_dir() / "build.log").read_text()
    report = ptxas_report(log)
    for name, (registers, spills) in report.items():
        print(f"  ptxas: {name}: {registers} registers, {spills} bytes spilled", flush=True)
    print(f"  ptxas: {log.count('warpgroup.arrive is injected')} wgmma fences added by the "
          f"compiler", flush=True)
    for kernel in ("fused_mlp_kernel", "fused_render_kernel"):
        spills = [v[1] for k, v in report.items() if kernel in k]
        require(spills == [0], f"ptxas reports spills for {kernel}: {spills}")
    spills = [v[1] for k, v in report.items() if "ngp_mlp_kernel" in k]  # one for each encoding width
    require(spills == [0, 0], f"ptxas reports spills for ngp_mlp_kernel: {spills}")

    # Two measured variants of the hash-grid kernels, the baked lookup's
    # replaced kernel, the composite source before the pool layout's
    # kernels, the dx pair as first designed and the probes build (from
    # csrc/ablations) while the MLP kernels are checked.
    from learn_nerf_tpu_torch.scripts import composite_ablations
    from learn_nerf_tpu_torch.scripts.baked_ablations import build_libraries
    from learn_nerf_tpu_torch.scripts.hashgrid_ablations import (NEIGHBOUR_SLICE, VARIANTS, build_dx_libraries,
                                                                  build_gather_libraries, build_probes)
    from learn_nerf_tpu_torch.scripts.mlp_ablations import build_variants

    variant, baked_parts = {}, {}
    gathers = {name: VARIANTS[name] for name in (GATHER_PARENT, GATHER_CLUSTER)}
    gathers[GATHER_NEIGHBOUR] = NEIGHBOUR_SLICE
    threads = [
        threading.Thread(target=lambda: variant.update(build_variants([PARENT_LAYOUT, ENCODE_TILES], VARIANTS))),
        threading.Thread(target=lambda: baked_parts.update(parent=build_libraries(["parent"])["parent"],
                                                           probes=build_probes())),
        threading.Thread(target=lambda: baked_parts.update(composite_parent=composite_ablations.build_libraries(
            ["parent"], composite_ablations.POOLED_VARIANTS)["parent"])),
        threading.Thread(target=lambda: baked_parts.update(gather=build_gather_libraries(list(gathers), gathers))),
        threading.Thread(target=lambda: baked_parts.update(dx_parent=build_dx_libraries([DX_PARENT])[DX_PARENT])),
        threading.Thread(target=lambda: baked_parts.update(selection=build_selection_libraries())),
    ]
    for thread in threads:
        thread.start()
    rng = np.random.RandomState(SEED)
    kernels = check_kernels(device, rng)
    kernels += check_ngp_mlp_kernel(device, np.random.RandomState(SEED + 20))
    for thread in threads:
        thread.join()
    require(PARENT_LAYOUT in variant and ENCODE_TILES in variant,
            "the hash-grid kernels' measured variants did not build")
    require(len(baked_parts) == 6, "the replaced baked-lookup, composite, gather or dx kernels, the gather or "
            "selection faults or the probes did not build")
    kernels.append(check_table_gather(device, np.random.RandomState(SEED + 13), baked_parts["gather"],
                                      baked_parts["probes"]))
    torch.cuda.empty_cache()
    kernels += check_hashgrid_kernels(device, np.random.RandomState(SEED + 3), variant[ENCODE_TILES])
    torch.cuda.empty_cache()
    kernels += check_backward_kernel(device, np.random.RandomState(SEED + 5), variant[PARENT_LAYOUT])
    torch.cuda.empty_cache()
    kernels += check_dx_kernels(device, np.random.RandomState(SEED + 15), baked_parts["dx_parent"])
    torch.cuda.empty_cache()
    kernels += check_composite_kernels(device, np.random.RandomState(SEED + 6), baked_parts["composite_parent"])
    kernels += check_pooled_composite_kernels(device, np.random.RandomState(SEED + 9), baked_parts["composite_parent"],
                                              baked_parts["probes"])
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build.BUILD_DIR) as tmp:
        root = Path(tmp)
        views = write_scene(root, rng)
        kernels.append(check_baked_kernel(root, device, np.random.RandomState(SEED + 11), baked_parts["parent"],
                                          baked_parts["probes"]))
        torch.cuda.empty_cache()
        kernels += check_selection_kernels(device, views, baked_parts["probes"], baked_parts["selection"])
        torch.cuda.empty_cache()
        check_frames(root, views, device, rng, VANILLA_MODES, bf16=True)
        check_frames(root, views, device, np.random.RandomState(SEED + 2), NGP_MODES, bf16=False)
        check_frames(root, views, device, np.random.RandomState(SEED + 12), BAKED_MODES, bf16=False)
        torch.cuda.empty_cache()
        check_frames(root, views, device, np.random.RandomState(SEED + 16), LEVER_FRAME_MODES, bf16=False)
        check_frames(root, views, device, np.random.RandomState(SEED + 17), VANILLA_LEVER_MODES, bf16=True)
        torch.cuda.empty_cache()
        check_frame_graphs(root, views, device)
        torch.cuda.empty_cache()
        check_lever_invariants(root, device, np.random.RandomState(SEED + 18))
        torch.cuda.empty_cache()
        write_train_scene(root / "train", np.random.RandomState(SEED + 7))
        check_train_step(root, device, np.random.RandomState(SEED + 8))
        torch.cuda.empty_cache()
        check_graph_step(root, device)
        torch.cuda.empty_cache()
        hierarchy_step_check(root, device, np.random.RandomState(SEED + 14))
        check_hierarchy_graph_step(root, device)
        served, setups, bake = {}, {}, {}
        runs = [(name, mode, True) for name, mode in {**VANILLA_MODES, **VANILLA_LEVER_MODES}.items()]
        runs += [(name, mode, False) for name, mode in {**NGP_MODES, **BAKED_MODES, **LEVER_SERVE_MODES}.items()]
        for name, mode, bf16 in runs:
            # The north-star mode serves the bake of "ngp baked pooled" (384^3,
            # pack 4, the same checkpoint): no second bake.
            served[name], setups[name] = serve_mode(root, name, mode, bf16, bake=bake.get("field") if name == NORTH_STAR
                                                    else None, keep=bake if name == "ngp baked pooled" else None)
            torch.cuda.empty_cache()
        bake.clear()
        torch.cuda.empty_cache()
        if args.profile:
            profile_modes(root)
        counts, dense_psnr = train_phase(root, args.profile)
        served.update(counts)
        served.update(lever_phase(root, device, dense_psnr))
        served.update(ref_nerf_phase(root, device, args.profile))
        served.update(hierarchy_phase(root, args.profile))
        served.update(parallel_phase(root, device))
        served["hierarchy ref-nerf served"], _ = serve_mode(
            root, "hierarchy ref-nerf", ["--ref_nerf"], bf16=False, checkpoint="hierarchy_ref-nerf.pkl", requests=1)
        check_frame_graph_mode(root, device, "hierarchy ref-nerf", ["--ref_nerf"], False,
                               checkpoint="hierarchy_ref-nerf.pkl")
        gate, served["quality gate"] = quality_gate(root, [SEED])
        require(gate[SEED][0] >= GATE_FLOOR, f"the quality gate scored {gate[SEED][0]:.3f} dB, under its floor "
                f"{GATE_FLOOR:g} dB")

    # Each mode's kernels ran in its serve phase (serve_mode holds that no
    # plain version ran there).
    require(served["hierarchy"]["fused_mlp"][0] > 0, "hierarchy serving never launched fused_mlp")
    require(served["occupancy"]["fused_render"][0] > 0, "occupancy serving never launched fused_render")
    for name in (*NGP_MODES, "trained ngp occupancy", "trained ngp pooled"):
        require(served[name]["hashgrid_encode"][0] > 0, f"{name} serving never launched hashgrid_encode")
    for name in ("ngp occupancy", "trained ngp occupancy"):
        require(served[name]["composite"][0] > 0, f"{name} serving never launched composite")
    for name in ("ngp pooled", "trained ngp pooled"):
        require(served[name]["composite_pooled"][0] > 0 and served[name]["composite"][0] == 0,
                f"{name} serving did not composite in the pool layout: {served[name]}")
    # The hierarchy composites each pass of each tile of 4096 rays in one
    # launch (and no plain version ran: serve_mode holds that).
    tiles = -(-SIDE * SIDE // 4096)
    for name in ("hierarchy", "ngp hierarchy"):
        require(served[name]["composite"][0] == 2 * tiles * REQUESTS,
                f"{name} serving launched composite {served[name]['composite'][0]} times, not "
                f"{2 * tiles * REQUESTS} (2 a tile)")
    # A baked mode bakes once, in the server's set-up (the encode kernel), then
    # serves every tile of 8192 rays through one baked lookup and never
    # encodes.
    baked_tiles = -(-SIDE * SIDE // 8192)
    for name in BAKED_MODES:
        counts, setup = served[name], setups[name]
        require(setup["hashgrid_encode"][0] > 0 and setup["baked_lookup"][0] == 0,
                f"{name}: the server's set-up did not bake on the card: {setup}")
        require(counts["hashgrid_encode"][0] == 0, f"{name} serving ran the hash-grid encoding: {counts}")
        lookups = counts["baked_lookup"][0]
        require(lookups == baked_tiles * REQUESTS,
                f"{name} serving launched baked_lookup {lookups} times, not once a tile ({baked_tiles * REQUESTS})")
    for name in ("trained ref-nerf ngp occupancy", "train ref-nerf ngp"):
        require(served[name]["hashgrid_dx"][0] > 0 and served[name]["hashgrid_encode"][0] > 0,
                f"{name} never launched hashgrid_dx or hashgrid_encode: {served[name]}")
    require(served["hierarchy ref-nerf served"]["composite"][0] == 2 * tiles,
            "Ref-NeRF hierarchy serving did not composite twice a tile on the card")
    require(served["ngp baked pooled"]["composite_pooled"][0] > 0
            and served["ngp baked occupancy"]["composite"][0] > 0, "a baked mode did not composite on the card")
    # The lever modes: the north-star frame serves the bake "ngp baked
    # pooled" made (no encode in its set-up or while serving, the baked
    # lookup once a tile), the live levers encode; both composite in the
    # pool layout; vanilla block words run the fused render kernel.
    north, north_setup = served[NORTH_STAR], setups[NORTH_STAR]
    require(north_setup["hashgrid_encode"][0] == 0 and north["hashgrid_encode"][0] == 0
            and north["baked_lookup"][0] == baked_tiles * REQUESTS,
            f"{NORTH_STAR}: baked again or did not look up once a tile: {north_setup}, {north}")
    require(served["ngp live levers"]["hashgrid_encode"][0] > 0, "ngp live levers never launched hashgrid_encode")
    for name in LEVER_SERVE_MODES:
        require(served[name]["composite_pooled"][0] > 0 and served[name]["composite"][0] == 0,
                f"{name} serving did not composite in the pool layout: {served[name]}")
    for name in VANILLA_LEVER_MODES:
        require(served[name]["fused_render"][0] > 0, f"{name} serving never launched fused_render")
    # The selection: every occupancy tile launches select_strided (fixed-K
    # frames once a tile; an auto-pooled frame once more, for its demand),
    # and every pooled tile pool_pack, one launch from the selection's counts
    # (check_frames and check_train_step hold from a profile that the pack
    # comes right after the selection, with no clamp or scan between); the
    # block-word modes keep their plain candidate test (counted) and pack on
    # the card.
    block_modes = ("ngp live levers", *VANILLA_LEVER_MODES)
    for name in ("occupancy", "ngp occupancy", "ngp baked occupancy", "trained ngp occupancy"):
        tiles_served = baked_tiles * (1 if name.startswith("trained") else REQUESTS)
        require(served[name]["select_strided"][0] == tiles_served and served[name]["pool_pack"][0] == 0,
                f"{name} serving did not select once a tile on the card: {served[name]}")
    for name in ("ngp pooled", "ngp baked pooled", NORTH_STAR, "ngp live levers", "trained ngp pooled"):
        counts = served[name]
        frames = 1 if name.startswith("trained") else REQUESTS
        require(counts["pool_pack"][0] == counts["composite_pooled"][0] >= baked_tiles * frames,
                f"{name} serving did not pack each pooled tile on the card: {counts}")
        require(name in block_modes or counts["select_strided"][0] >= counts["pool_pack"][0] + frames,
                f"{name} serving did not select each tile and each frame's demand on the card: {counts}")
    for name in block_modes:
        require(served[name]["select_strided"][0] == 0 and served[name][BLOCK_WORD_SELECTION][1] > 0,
                f"{name} serving did not keep the block words' plain candidate test: {served[name]}")
    if args.profile:
        from learn_nerf_tpu_torch.scripts import frame_matrix

        torch.cuda.empty_cache()
        frame_matrix.main(["--size", "800"])  # its rows, then its JSON line
    for k in kernels:
        k["launches"] = sum(counts[k["name"]][0] for counts in served.values())
    ordered = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "ms_rays",
               "ms_step_rays", "hierarchy", "parent_ms", "floor_ms", "plain_ms", "route_ms", "bound_ms", "bound_step_ms", "bound_by",
               "library_ms", "card_rate_ms", "share_of_bound", "tflops", "shapes"]
    for k in kernels:
        k.setdefault("share_of_bound", k["bound_ms"] / k["ms"])
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all, the kernels' build included", flush=True)
    print(card)
    print(json.dumps({"kernels": [{key: k[key] for key in ordered if key in k} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
