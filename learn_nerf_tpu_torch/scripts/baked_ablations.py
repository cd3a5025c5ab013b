"""Where the baked lookup's time goes, by ablation and by probe, on the card.

Builds ``csrc/baked.cu`` on its own, its measured variants and the kernel
it replaced, each into its own library, and times them in turns (A B ... B
A) on one random 384^3 x 16 table (bf16 and f32, at packs 1, 2, 4 and 8),
by CUDA-graph replay, at four shapes:

* ``random``: 2^20 points uniform in the bbox +- 0.05;
* ``rays``: 2^20 points along 8,192 rays, 128 samples 0.01 apart;
* ``pooled tile``: the pool of one baked pooled frame tile (8,192 rays at
  budget 6): 37,736 points along rays, 5 a ray, then 11,416 copies of one
  point outside the bbox, as ``render_rays_pooled`` fills the unused rows;
* ``fixed-K tile``: 8,192 rays x 32 samples 0.01 apart (one fixed-K tile).

The variants (``as built``: csrc/baked.cu; bf16 rows of 128 bytes or more
loaded by lane groups, one row a group, into shared memory by cp.async,
each lane summing its own point; shorter rows and f32 tables by feature
lanes, each lane loading a 16-byte vector of every corner of its point and
summing those features itself):

* ``parent``: the kernel as it was before (``csrc/ablations/baked_parent.cu``:
  one thread a point, each row read by that thread);
* ``lane groups at every pack``, ``feature lanes at every pack``: one of
  the two layouts for every row size;
* ``64 points a warp``, ``128 points a warp``: lane groups at every pack, a
  lane owning 2 or 4 points, so a warp stages 64 or 128 points at once (as
  built: 32);
* ``register staging``: lane groups at every pack, the rows going to shared
  memory through registers (``__ldg``), 16 loads a lane in flight;
  ``register staging, rows past L1`` with
  ``ld.global.nc.L1::no_allocate`` loads;
* ``feature lanes, 2 points a lane`` / ``4 points a lane``: feature lanes
  at every pack with 2 or 4 points' loads in flight a lane;
* ``rows past L1``: the rows skip L1 (``cp.async.cg``,
  ``ld.global.nc.L1::no_allocate``; as built: ``cp.async.ca``, ``__ldg``);
* ``256 threads``: blocks of 8 warps (as built: 4);
* ``thread a point``: the parent's layout (one lane reads all of a point's
  rows) written as the feature lanes are, every load of the point before
  the sum; ``thread a point, 2 points a thread`` / ``4 points a thread``
  with 2 or 4 points' loads in flight a thread, the control for "more
  bytes in flight".

A variant that does not launch (more shared memory than a block may have)
prints its error in place of its times.
Every variant is held bit for bit to the kernel as built on every shape
and pack (first turn), and the kernel as built to its plain version.

Then the card's own rate for the lookup's access pattern
(``csrc/ablations/probes.cu``, ``nerf_probe_runs``): as many random runs
as a lookup of 2^20 points reads at pack P, loaded by lane groups as the
kernel loads them, over buffers of 32 MB and of the bf16 tables' sizes
(1.8, 3.6, 7.25 and 14.5 GB): its 8/P rows of 32 P bytes (64 P in f32) as
separate runs, and as the table holds them, the rows of corners c and c + 4
(x and x + 1) side by side in one run; G runs/s and G sectors/s for each.

Prints one JSON line per variant with ptxas's registers and spills, one
per table (its bound at each shape, the as-built kernel's largest
difference from the plain version), one per variant, table and turn (ms at
each shape), one per probe, buffer and turn, then the card's name and power
limit.  Everything builds into
``learn_nerf_tpu_torch/_build/ablations/baked/``.

    python -m learn_nerf_tpu_torch.scripts.baked_ablations [--turns N] [--no-probes] [variant ...]
"""

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from .. import baked
from ..kernels import baked as kbaked
from ..kernels import build
from ..kernels.hashgrid import bbox_floats
from ..ops.hashgrid import corner_weights_and_coords
from .hashgrid_ablations import build_probes, ray_points
from .mlp_ablations import variant_sources
from .timing import cuda_ms, graph_ms

BAKED, PARENT = "baked.cu", "ablations/baked_parent.cu"
LAYOUT = "  return sizeof(T) == 2 && P * kBakedFeatures * 2 >= 128;"
THREADS_256 = (BAKED, "constexpr int kBakedThreads = 128;", "constexpr int kBakedThreads = 256;")
REGISTERS = (BAKED, "constexpr bool kAsyncCopy = true;", "constexpr bool kAsyncCopy = false;")
PAST_L1 = (BAKED, "constexpr bool kRowsPastL1 = false;", "constexpr bool kRowsPastL1 = true;")
GROUPS_ALWAYS = (BAKED, LAYOUT, "  return true;")
LANES_ALWAYS = (BAKED, LAYOUT, "  return false;")
WHOLE_POINTS = (BAKED, "constexpr bool kSplitFeatures = true;", "constexpr bool kSplitFeatures = false;")


def staged_points(k):
    return (BAKED, "constexpr int kPointsPerLane = 1;", f"constexpr int kPointsPerLane = {k};")


def split_points(k):
    return (BAKED, "constexpr int kSplitPoints = 1;", f"constexpr int kSplitPoints = {k};")


VARIANTS = {
    "as built": [],
    "parent": [(BAKED, None, PARENT)],
    "lane groups at every pack": [GROUPS_ALWAYS],
    "feature lanes at every pack": [LANES_ALWAYS],
    "64 points a warp": [GROUPS_ALWAYS, staged_points(2)],
    "128 points a warp": [GROUPS_ALWAYS, staged_points(4)],
    "register staging": [GROUPS_ALWAYS, REGISTERS],
    "register staging, rows past L1": [GROUPS_ALWAYS, REGISTERS, PAST_L1],
    "feature lanes, 2 points a lane": [LANES_ALWAYS, split_points(2)],
    "feature lanes, 4 points a lane": [LANES_ALWAYS, split_points(4)],
    "rows past L1": [PAST_L1],
    "256 threads": [THREADS_256],
    "thread a point": [LANES_ALWAYS, WHOLE_POINTS],
    "thread a point, 2 points a thread": [LANES_ALWAYS, WHOLE_POINTS, split_points(2)],
    "thread a point, 4 points a thread": [LANES_ALWAYS, WHOLE_POINTS, split_points(4)],
}
RESOLUTION, FEATURES = 384, kbaked.KERNEL_FEATURES
BBOX = ((-0.7,) * 3, (0.7,) * 3)
POINTS_RANDOM, RAYS = 1 << 20, 8192
# One baked pooled frame tile: 8,192 rays at budget 6 used 37,736 of the
# pool's rows; render_rays_pooled points the rest at one point (the last
# ray's origin, outside the bbox).
POOL_BUDGET, POOLED_TILE_USED, POOL_PAD_POINT = 6, 37_736, (0.0, -4.0, 1.0)
TABLES = [(dtype, p) for dtype in (torch.bfloat16, torch.float32) for p in baked.PACKS]
HBM_BYTES_PER_S = 3.35e12
PROBE_BUFFER_MB = 32


def frame_tiles(rng):
    """``{tile: points [N, 3] f32}``: a baked pooled frame tile's pool
    (37,736 samples along rays, 5 a ray, then the pool's unused rows, all
    one point outside the bbox) and a fixed-K tile (8,192 rays x 32)."""
    used = ray_points(rng, RAYS, 5, 0.01, -0.7, 0.7)[:POOLED_TILE_USED]
    pad = np.tile(np.array([POOL_PAD_POINT], np.float32), (RAYS * POOL_BUDGET - POOLED_TILE_USED, 1))
    return {"pooled tile": np.concatenate([used, pad]), "fixed-K tile": ray_points(rng, RAYS, 32, 0.01, -0.7, 0.7)}


def shapes(rng, device):
    """``{shape: points [N, 3] f32 on device}``: the four shapes above."""
    cases = {
        "random": rng.uniform(-0.75, 0.75, (POINTS_RANDOM, 3)).astype(np.float32),
        "rays": ray_points(rng, RAYS, POINTS_RANDOM // RAYS, 0.01, -0.7, 0.7),
        **frame_tiles(rng),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in cases.items()}


def least_bytes(points, resolution, element_size, lo=BBOX[0], hi=BBOX[1]):
    """The bytes a lookup of ``points`` must move: one copy of each distinct
    lattice vertex they read (F features each), the points and the output.
    A pack-p table holds each vertex in up to p rows, of which a lookup needs
    one."""
    r = resolution
    coords, _ = corner_weights_and_coords(points, r, lo, hi, smooth=False)
    vertices = torch.unique(coords[..., 0] + r * (coords[..., 1] + r * coords[..., 2])).numel()
    n = points.shape[0]
    return vertices * FEATURES * element_size + n * 3 * 4 + n * FEATURES * 4


def variant_dir(name):
    """Where a variant's sources and library are built."""
    return build.BUILD_DIR / "ablations" / "baked" / name.replace(" ", "_").replace(",", "")


def build_libraries(names, variants=VARIANTS):
    """Compile each variant's ``baked.cu`` (with its edits; with ``None`` for
    the old text, the file ``new text`` names takes its place) into its own
    library, all at once; ``{name: the C entry point}`` (the parent's is
    ``nerf_baked_lookup_parent``)."""
    procs = {}
    for name in names:
        out = variant_dir(name)
        variant_sources(out, name, variants[name])
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out / "libbaked.so"), str(out / BAKED)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log[-4000:]}")
        (out / "build.log").write_text(log)
        lib = ctypes.CDLL(str(out / "libbaked.so"))
        fn = lib.nerf_baked_lookup_parent if hasattr(lib, "nerf_baked_lookup_parent") else lib.nerf_baked_lookup
        fn.argtypes = [ptr, i32, i32, i32, ptr, i64, i32] + [ctypes.c_float] * 6 + [ptr, ptr]
        fn.restype = i32
        entries[name] = fn
    return entries


def lookup_with(entry, grid, x, resolution, pack, lo=BBOX[0], hi=BBOX[1]):
    """The lookup by the kernel behind ``entry`` (from :func:`build_libraries`),
    on operands as ``kernels.baked.launch_lookup`` takes them; it adds nothing
    to that module's launch count."""
    out = torch.empty((x.shape[0], FEATURES), dtype=torch.float32, device=x.device)
    err = entry(grid.data_ptr(), int(grid.dtype == torch.bfloat16), pack, FEATURES, x.data_ptr(), x.shape[0],
                resolution, *bbox_floats(lo), *bbox_floats(hi), out.data_ptr(), build.current_stream(x.device))
    if err != 0:
        raise RuntimeError(f"a baked-lookup variant failed to launch (cudaError {err})")
    return out


def random_table(resolution, device, seed=0):
    """A pack-1 bf16 table of uniform features in [-1, 1), made on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((resolution**3, FEATURES), dtype=torch.bfloat16, device=device)
    for chunk in out.split(1 << 24):  # no f32 copy of the whole table
        chunk.copy_(torch.rand(chunk.shape, generator=gen, device=device) * 2 - 1)
    return out


def run_bytes(dtype, pack):
    """A row's bytes."""
    return pack * FEATURES * torch.tensor([], dtype=dtype).element_size()


def probe_shapes(dtype, pack):
    """``{pattern: (run bytes, runs a point)}``: the 8 / pack rows of a point
    as separate random runs, and as the lookup finds them in the table: the
    rows of corners c and c + 4 (x and x + 1) side by side, one run of two
    rows, below pack 8."""
    row = run_bytes(dtype, pack)
    pairs = (2 * row, 4 // pack) if pack < 8 else (row, 1)
    return {"rows": (row, 8 // pack), "row pairs": pairs}


def probe_ms(probes, buf, nbytes, run, runs, reps=20):
    """Device ms of ``runs`` random runs of ``run`` bytes from the first
    ``nbytes`` bytes of ``buf`` (``nerf_probe_runs``)."""
    out = torch.empty(probes.nerf_probe_runs_threads(runs, run), dtype=torch.int32, device=buf.device)

    def call():
        err = probes.nerf_probe_runs(buf.data_ptr(), nbytes, run, runs, out.data_ptr(),
                                     build.current_stream(buf.device))
        if err != 0:
            raise RuntimeError(f"probe launch failed: cudaError {err}")

    return cuda_ms(call, reps)


def run_probes(probes, device, turns):
    """One JSON line per (table, pattern, buffer, turn): the runs a lookup of
    2^20 points reads (``probe_shapes``), at random, by lane groups, over
    buffers of 32 MB and of the bf16 tables' sizes (the f32 tables' are
    twice those; past 14.5 GB none is probed)."""
    table_bytes = RESOLUTION**3 * FEATURES * 2  # a pack-1 bf16 table's
    sizes = {f"{PROBE_BUFFER_MB} MB": PROBE_BUFFER_MB << 20, **{
        f"{m * table_bytes / 1e9:.2f} GB": m * table_bytes for m in (1, 2, 4, 8)}}
    buf = torch.empty(max(sizes.values()), dtype=torch.uint8, device=device)
    for turn in range(turns):
        for dtype, pack in TABLES:
            for pattern, (run, per_point) in probe_shapes(dtype, pack).items():
                runs = POINTS_RANDOM * per_point
                for label, nbytes in sizes.items():
                    ms = probe_ms(probes, buf, nbytes, run, runs)
                    print(json.dumps(dict(table=f"{str(dtype)[6:]} pack {pack}", probe=f"{pattern}: {run}-byte runs",
                                          buffer=label, turn=turn, ms=ms, runs=runs,
                                          giga_runs_per_s=runs / ms / 1e6,
                                          giga_sectors_per_s=runs * run / 32 / ms / 1e6)), flush=True)
    del buf
    torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", help=f"any of {list(VARIANTS)} (default: all)")
    parser.add_argument("--turns", type=int, default=3, help="turns over the variants")
    parser.add_argument("--no-probes", action="store_true", help="skip the random-row probes")
    args = parser.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("baked_ablations: no CUDA device; the ablations run on the card")
    device = torch.device("cuda")
    names = ["as built", *[v for v in args.variants or VARIANTS if v != "as built"]]
    entries = build_libraries(names)
    for name in names:  # ptxas's report of each variant's 8 kernels (4 packs, 2 types)
        log = (variant_dir(name) / "build.log").read_text()
        print(json.dumps(dict(variant=name, registers=[int(m) for m in re.findall(r"Used (\d+) registers", log)],
                              spill_store_bytes=[int(m) for m in re.findall(r"(\d+) bytes spill stores", log)])))
    probes = None if args.no_probes else build_probes()

    r = RESOLUTION
    points = shapes(np.random.RandomState(0), device)
    table = random_table(r, device)
    bounds = {dtype: {k: least_bytes(x, r, 2 if dtype == torch.bfloat16 else 4) / HBM_BYTES_PER_S * 1e3
                      for k, x in points.items()} for dtype in (torch.bfloat16, torch.float32)}
    for dtype, pack in TABLES:
        grid = baked.pack_baked_grid(table if dtype == torch.bfloat16 else table.float(), r, pack)
        want = {k: lookup_with(entries["as built"], grid, x, r, pack) for k, x in points.items()}
        plain_err = max((want[k] - kbaked.baked_lookup_reference(grid, x, r, pack, *BBOX)).abs().max().item()
                        for k, x in points.items())
        table_name = f"{str(dtype)[6:]} pack {pack}"
        print(json.dumps(dict(table=table_name, gb=grid.numel() * grid.element_size() / 1e9,
                              as_built_max_abs_err=plain_err, bound_ms=bounds[dtype])), flush=True)
        for turn in range(args.turns):
            for name in names if turn % 2 == 0 else names[::-1]:
                entry = entries[name]
                result = dict(variant=name, table=table_name, turn=turn)
                try:
                    lookup_with(entry, grid, points["pooled tile"], r, pack)
                except RuntimeError as err:  # e.g. more shared memory than a block may have
                    print(json.dumps(dict(result, error=str(err))), flush=True)
                    continue
                for k, x in points.items():
                    result[f"{k} ms"] = graph_ms(lambda: lookup_with(entry, grid, x, r, pack),
                                                 20 if len(x) >= POINTS_RANDOM else 50)
                if turn == 0:
                    result["equals_as_built"] = all(
                        torch.equal(lookup_with(entry, grid, x, r, pack), want[k]) for k, x in points.items())
                print(json.dumps(result), flush=True)
        del grid, want
        torch.cuda.empty_cache()
    del table
    torch.cuda.empty_cache()
    if probes is not None:
        run_probes(probes, device, args.turns)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
