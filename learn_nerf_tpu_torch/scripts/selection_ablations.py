"""What the selection pair's design buys, by ablation, on the card.

Builds ``csrc/selection.cu`` on its own with each measured variant, and the
pair as first written (``csrc/ablations/selection_parent.cu``), each into
its own library, and times them on the same data by CUDA-graph replay, in
turns whose order alternates (A B B A):

* ``as built``: the kernels on the path;
* ``parent``: the pair as first written: one f32 density read a candidate
  from the grid, a chunk's u and grid loads waited on before the next
  chunk's; the pack after a clamp and a ``torch.cumsum`` of the counts
  (three launches);
* ``IEEE division``: each cell coordinate's ``(x - lo) / (hi - lo)`` by
  ``__fdiv_rn`` (as built, ``x * inv`` and two residual steps from the
  wrapper's reciprocal, the same quotient: ``divide`` in the source);
* ``no rank walk`` (timed only, not the same function): every slot takes
  candidate 0, for the share of the slots' walk;
* ``density test``: the instance without the prune tests each candidate's
  f32 density, ``__ldg(densities + cell) > threshold``, in place of its
  cell's bit in the packed words;
* ``one chunk in flight``: the packed words, but each chunk of 32
  candidates loaded and tested before the next chunk's loads
  (``kChunksInFlight`` 1, as built 8);
* ``u by bulk copy``: each block's u rows staged in shared memory by one
  ``cp.async.bulk`` on an mbarrier, issued before the slab test and waited
  on after it (C a multiple of 4);
* ``sector bricks``: the words ordered 2 x 2 x 2 words to a 32-byte
  sector, so that a sector covers an 8 x 8 x 4-cell brick (as built, x
  fastest: a sector is 32 x 4 x 2 cells);
* ``16 blocks an SM``: the selection compiled for 16 resident blocks of
  4 warps an SM (32 registers a thread; as built, as many as it needs);
  ``4 chunks in flight and 16 blocks an SM``: the same with half the chunks
  held in registers;
* ``64 pack blocks``, ``256 pack blocks``: the pack's most blocks (as
  built 128), each of which reads the counts once.

The shapes: the train step's selection (4096 random rays x 192 candidates
-> 32, the points written, on the scene's ball grid), a served tile's (8192
view rays x 192 -> 32 at eps 1e-2 on the ball at density 50, and without
the prune), the pack at
the step's pool (budget 32 a ray) and at a tile's (8192 x 6).  Each
variant is first held to the build's outputs (bit for bit).  Prints one
JSON line per variant and shape with the turns' µs, then the card's name
and power limit.  The libraries build into
``learn_nerf_tpu_torch/_build/ablations/selection/``.

    python -m learn_nerf_tpu_torch.scripts.selection_ablations
"""

import argparse
import ctypes
import json
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from ..acceleration import OccupancyGrid, OccupancyGridState, pack_occupancy_words
from ..kernels import build
from ..kernels import selection as ksel
from .mlp_ablations import variant_sources
from .timing import graph_ms

PARENT = "parent"
SELECTION = "selection.cu"

_BULK_U = [
    ("selection.cu", "#include <math_constants.h>\n", "#include <math_constants.h>\n\n#include \"sm90.cuh\"\n"),
    ("selection.cu", """  extern __shared__ unsigned int ballots[];  // [warps][words]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (ray >= a.n) return;  // the whole warp
  const int words = (a.candidates + 31) >> 5;
  unsigned int* bits = ballots + warp * words;
""", """  extern __shared__ __align__(16) unsigned int ballots[];  // [warps][candidates] u, then [warps][words]
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long ray0 = static_cast<long long>(blockIdx.x) * warps;
  const long long ray = ray0 + warp;
  const unsigned int bytes = 4u * static_cast<unsigned int>(min(static_cast<long long>(warps), a.n - ray0)) *
                             a.candidates;
  float* staged = reinterpret_cast<float*>(ballots);
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(&bar, bytes);
    bulk_load(staged, a.u + ray0 * a.candidates, bytes, &bar);
  }
  __syncthreads();
  if (ray >= a.n) return;  // the whole warp
  const int words = (a.candidates + 31) >> 5;
  unsigned int* bits = ballots + warps * a.candidates + warp * words;
"""),
    ("selection.cu", "  const float* u = a.u + ray * a.candidates;\n",
     "  mbar_wait(&bar, 0);\n  const float* u = staged + warp * a.candidates;\n"),
    ("selection.cu", "uk[i] = k < a.candidates ? __ldg(u + k) : 0.0f;", "uk[i] = k < a.candidates ? u[k] : 0.0f;"),
    ("selection.cu", "ballot_words * 4 > kSelectSharedBytes ||", "(ballot_words + c) * 4 > kSelectSharedBytes || c % 4 ||"),
    ("selection.cu", "while (warps > 1 && warps * ballot_words * 4 > kSelectSharedBytes) warps /= 2;",
     "while (warps > 1 && warps * (ballot_words + c) * 4 > kSelectSharedBytes) warps /= 2;"),
    ("selection.cu", "warps * 32, warps * ballot_words * 4,", "warps * 32, warps * (ballot_words + c) * 4,"),
]

_SECTOR_BRICKS = [("selection.cu", """  const int across = (r + 3) >> 2;
  return (cell[0] >> 2) + across * ((cell[1] >> 2) + across * (cell[2] >> 1));""", """  const int across = ((r + 7) >> 3) << 1;  // words along x and y, even
  const int bx = cell[0] >> 2, by = cell[1] >> 2, bz = cell[2] >> 1;
  const int brick = (bx >> 1) + (across >> 1) * ((by >> 1) + (across >> 1) * (bz >> 1));
  return 8 * brick + (bx & 1) + 2 * (by & 1) + 4 * (bz & 1);""")]

VARIANTS = {
    "IEEE division": [("selection.cu", "divide(__fsub_rn(p[axis], a.lo[axis]), span, a.inv_span[axis])",
                       "__fdiv_rn(__fsub_rn(p[axis], a.lo[axis]), span)")],
    "no rank walk": [("selection.cu", "const int target = min(rank + 1, count);", "const int target = 0;")],
    "density test": [("selection.cu",
                      "word[i] = a.warm != 0 ? kFullMask : __ldg(a.words + word_index(cell, a.resolution));",
                      "word[i] = a.warm != 0 || __ldg(a.densities + flat[i]) > a.threshold ? kFullMask : 0u;")],
    "one chunk in flight": [("selection.cu", "constexpr int kChunksInFlight = 8;",
                             "constexpr int kChunksInFlight = 1;")],
    "u by bulk copy": _BULK_U,
    "sector bricks": _SECTOR_BRICKS,
    "16 blocks an SM": [("selection.cu", "__launch_bounds__(kSelectWarps * 32) select_strided_kernel",
                         "__launch_bounds__(kSelectWarps * 32, 16) select_strided_kernel")],
    "4 chunks in flight and 16 blocks an SM": [
        ("selection.cu", "__launch_bounds__(kSelectWarps * 32) select_strided_kernel",
         "__launch_bounds__(kSelectWarps * 32, 16) select_strided_kernel"),
        ("selection.cu", "constexpr int kChunksInFlight = 8;", "constexpr int kChunksInFlight = 4;")],
    "64 pack blocks": [("selection.cu", "constexpr int kPackBlocks = 128;", "constexpr int kPackBlocks = 64;")],
    "256 pack blocks": [("selection.cu", "constexpr int kPackBlocks = 128;", "constexpr int kPackBlocks = 256;")],
}


#: Variants that compute another function, timed for the share of a part.
TIMING_ONLY = ("no rank walk",)


def build_selection_libraries(names, variants=VARIANTS):
    """Compile each variant's ``selection.cu`` alone (``PARENT``:
    ``csrc/ablations/selection_parent.cu``) into its own library, all at
    once; ``{name: library}``, bound as the package's (the parent's entry
    points carry ``_parent`` in their names)."""
    root = build.BUILD_DIR / "ablations" / "selection"
    procs = {}
    for name in names:
        out = root / name.replace(" ", "_").replace(",", "")
        edits = [(SELECTION, None, "ablations/selection_parent.cu")] if name == PARENT else variants[name]
        variant_sources(out, name, edits)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out / "libselection.so"), str(out / SELECTION)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        (out / "build.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"the selection variant {name!r} does not build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / "libselection.so"))
        if name == PARENT:
            ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.nerf_select_strided_parent.argtypes = (
                [ptr, i64, ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32] + [f32] * 7 + [i32] + [f32] * 4 + [ptr] * 7)
            lib.nerf_select_strided_parent.restype = i32
            lib.nerf_pool_pack_parent.argtypes = [ptr, i64, ptr, ptr, i64, i32, i64] + [ptr] * 8
            lib.nerf_pool_pack_parent.restype = i32
        else:
            build.bind_selection(lib)
        libs[name] = lib
    return libs


def launch_parent_select(lib, rays, u, grid, state, samples, min_t_range, eps=0.0, span=None, with_points=False):
    """The parent's ``select_strided_kernel`` (the f32 densities in place
    of the words), into new outputs."""
    n, c = u.shape
    device = rays.device
    out = ksel.Selection(
        torch.empty((n, samples), dtype=torch.float32, device=device),
        torch.empty((n, samples), dtype=torch.bool, device=device),
        torch.empty((n, 1), dtype=torch.float32, device=device), torch.empty((n,), dtype=torch.bool, device=device),
        torch.empty((n,), dtype=torch.int32, device=device),
        torch.empty((n, samples, 3), dtype=torch.float32, device=device) if with_points else None)
    span_ptrs = [v.data_ptr() for v in span] if span is not None else [None] * 3
    err = lib.nerf_select_strided_parent(
        rays.data_ptr(), rays.stride(0), u.data_ptr(), state.densities.data_ptr(), *span_ptrs, n, c, samples,
        grid.resolution, *map(float, grid.bbox_min), *map(float, grid.bbox_max), float(grid.threshold),
        int(grid.in_warmup(state)), float(min_t_range), float(eps), ksel._reciprocal(c), ksel._reciprocal(samples),
        *(v.data_ptr() if v is not None else None for v in out), build.current_stream(device))
    if err != 0:
        raise RuntimeError(f"the parent's select_strided launch failed: cudaError {err}")
    return out


def launch_parent_pack(lib, rays, ts, count, budget):
    """The parent's pooled chain: the clamp and ``torch.cumsum`` of the
    counts, then its ``pool_pack_kernel``."""
    n, k = ts.shape
    cum = torch.cumsum(torch.clamp(count, max=k), dim=0, dtype=torch.int32)
    device = rays.device
    out = ksel.Pool(
        torch.empty((budget,), dtype=torch.float32, device=device),
        torch.empty((budget,), dtype=torch.int64, device=device),
        torch.empty((budget, 3), dtype=torch.float32, device=device),
        torch.empty((budget, 3), dtype=torch.float32, device=device),
        torch.empty((n + 1,), dtype=torch.int32, device=device),
        torch.empty((), dtype=torch.int64, device=device), torch.empty((), dtype=torch.int64, device=device))
    err = lib.nerf_pool_pack_parent(rays.data_ptr(), rays.stride(0), ts.data_ptr(), cum.data_ptr(), n, k, budget,
                                    *(v.data_ptr() for v in out), build.current_stream(device))
    if err != 0:
        raise RuntimeError(f"the parent's pool_pack launch failed: cudaError {err}")
    return out


class BrickGrid(OccupancyGrid):
    """The grid whose words the ``sector bricks`` variant reads: 2 x 2 x 2
    words to a 32-byte sector (even word counts along each axis)."""

    def occupancy_words(self, state: OccupancyGridState) -> torch.Tensor:
        cached = getattr(state, "_brick_words", None)
        if cached is not None and cached[0] is state.densities and cached[1] == state.densities._version:
            return cached[2]
        r = self.resolution
        p = 8 * -(-r // 8)  # whole bricks: p / 4 words along x and y, p / 2 along z, all even
        cube = torch.zeros((p, p, p), dtype=state.densities.dtype, device=state.densities.device)
        cube[:r, :r, :r] = state.densities.reshape(r, r, r)
        words = pack_occupancy_words(cube.reshape(-1), p, self.threshold)
        bricks = words.reshape(p // 4, 2, p // 8, 2, p // 8, 2).permute(0, 2, 4, 1, 3, 5).contiguous().reshape(-1)
        state._brick_words = (state.densities, state.densities._version, bricks)
        return bricks


def selection_rays(rng, n, half=0.7, device="cuda"):
    """``n`` rays from a sphere of radius 2 around the bbox [-half, half]^3,
    aimed at points inside it; one in 16 aimed away (it misses), one in 16
    axis-aligned (zero direction components, one of them -0.0)."""
    origins = rng.randn(n, 3)
    origins *= 2.0 / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = rng.uniform(-0.7 * half, 0.7 * half, (n, 3)) - origins
    dirs[::16] *= -1.0
    axis = np.arange(1, n, 16)
    dirs[axis] = 0.0
    origins[axis] = rng.uniform(-0.9 * half, 0.9 * half, (len(axis), 3))
    origins[axis, axis % 3] = -2.0
    dirs[axis, axis % 3] = 1.0
    if len(axis):
        dirs[axis[0], (axis[0] + 1) % 3] = -0.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return torch.from_numpy(np.stack([origins, dirs], axis=1).astype(np.float32)).to(device)


def ball_densities(resolution, centre=(0.0, 0.0, 0.0), radius=0.45, density=5.0):
    """``[r^3]`` densities of a ball in the bbox [-0.7, 0.7]^3, x fastest."""
    c = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution * 1.4 - 0.7
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    inside = (x - centre[0]) ** 2 + (y - centre[1]) ** 2 + (z - centre[2]) ** 2 < radius**2
    return np.where(inside, density, 0.0).astype(np.float32).reshape(-1)


def selection_grids(device, resolution=128):
    """The chip scene's grid over [-0.7, 0.7]^3 and its states: the ball
    (density 5 in radius 0.45), an off-centre ball, the ball in warmup
    (every candidate occupied), both balls at density 50 (opaque: the prune
    at eps 1e-2 cuts inside them)."""
    grid = OccupancyGrid(bbox_min=(-0.7,) * 3, bbox_max=(0.7,) * 3, resolution=resolution)
    ball = ball_densities(resolution)
    off = ball_densities(resolution, (0.25, -0.1, -0.3), 0.3)
    states = {name: OccupancyGridState(densities=torch.from_numpy(d).to(device), step=step)
              for name, d, step in (("ball", ball, 16), ("off-centre ball", off, 16), ("warmup", ball, 0),
                                    ("opaque ball", 10.0 * ball, 16), ("opaque off-centre ball", 10.0 * off, 16))}
    return grid, states


def shapes(device, rng):
    """``{name: (rays, u, grid, state, eps)}``: the step's selection and a
    served tile's (8192 rays, ten rows through the middle of the 800^2
    frame of ``frame_matrix``)."""
    from .frame_matrix import frame_view

    grid, states = selection_grids(device)
    step_rays = selection_rays(rng, 4096, device=device)
    tile_rays = torch.from_numpy(frame_view().bare_rays(800, 800)[320_000:328_192]).to(device)
    u = lambda n: torch.from_numpy(rng.rand(n, 192).astype(np.float32)).to(device)  # noqa: E731
    return {"step 4096 x 192 -> 32": (step_rays, u(4096), grid, states["ball"], 0.0),
            "tile 8192 x 192 -> 32, eps 1e-2": (tile_rays, u(8192), grid, states["opaque ball"], 1e-2),
            "tile 8192 x 192 -> 32, no prune": (tile_rays, u(8192), grid, states["opaque ball"], 0.0)}


def same(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                                        y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


def main(argv: Optional[list] = None) -> Dict[str, dict]:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--variants", default=",".join([PARENT, *VARIANTS]), help="comma-separated variants")
    parser.add_argument("--turns", type=int, default=4)
    args = parser.parse_args(argv)
    from .common import default_device
    from .frame_matrix import card_line

    device = default_device()
    names = args.variants.split(",")
    libs = build_selection_libraries(names)
    built = build.library()
    rng = np.random.RandomState(19)
    results = {}
    for shape, (rays, u, grid, state, eps) in shapes(device, rng).items():
        want = ksel.launch_select_strided(rays, u, grid, state, 32, 1e-3, eps, None, True)
        runs = {"as built": lambda: ksel.launch_select_strided(rays, u, grid, state, 32, 1e-3, eps, None, True)}
        for name in names:
            if name == PARENT:
                runs[name] = lambda: launch_parent_select(libs[PARENT], rays, u, grid, state, 32, 1e-3, eps, None, True)
            elif not name.endswith("pack blocks"):
                g = BrickGrid(grid.bbox_min, grid.bbox_max, grid.resolution) if name == "sector bricks" else grid
                runs[name] = (lambda g=g, lib=libs[name]:
                              ksel.launch_select_strided(rays, u, g, state, 32, 1e-3, eps, None, True, lib=lib))
        for name, run in runs.items():
            got = run()
            diff = not same(got, want)
            if eps == 0.0 and diff and name not in TIMING_ONLY:
                raise RuntimeError(f"{name} differs from the build at {shape}")
            results[(shape, name)] = dict(differs=diff, us=[])
        for turn in range(args.turns):
            for name in (runs if turn % 2 == 0 else reversed(list(runs))):
                results[(shape, name)]["us"].append(1e3 * graph_ms(runs[name], 50))
        pools = ({"step pool, budget 32 a ray": 32} if shape.startswith("step") else
                 {"tile 8192 x 6": 6} if eps > 0.0 else {})
        for pool_name, per_ray in pools.items():
            budget = rays.shape[0] * per_ray
            want_pool = ksel.launch_pool_pack(rays, want.ts, want.count, budget)
            packs = {"as built": lambda: ksel.launch_pool_pack(rays, want.ts, want.count, budget)}
            for name in names:
                if name == PARENT:
                    packs[name] = lambda: launch_parent_pack(libs[PARENT], rays, want.ts, want.count, budget)
                elif name.endswith("pack blocks"):
                    packs[name] = lambda lib=libs[name]: ksel.launch_pool_pack(rays, want.ts, want.count, budget,
                                                                               lib=lib)
            for name, run in packs.items():
                if not same(run(), want_pool):
                    raise RuntimeError(f"{name} packs other rows than the build at {pool_name}")
                results[(pool_name, name)] = dict(differs=False, us=[])
            for turn in range(args.turns):
                for name in (packs if turn % 2 == 0 else reversed(list(packs))):
                    results[(pool_name, name)]["us"].append(1e3 * graph_ms(packs[name], 50))
    del built
    out = {}
    for (shape, name), entry in results.items():
        entry["median_us"] = float(np.median(entry["us"]))
        out.setdefault(shape, {})[name] = entry
        print(json.dumps(dict(shape=shape, variant=name, **entry)), flush=True)
    print(card_line(), flush=True)
    return out


if __name__ == "__main__":
    main()
