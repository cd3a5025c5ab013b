"""Where the fused MLP kernels spend their time, by ablation, on the card.

Builds variants of ``csrc/`` with one part of the kernels' work taken out,
and times each beside the kernels as built: fused_mlp on 2^20 points and
fused_render on 8192 rays x 32 samples (``chip_smoke.py``'s shapes), in
turns, twice.  A variant's results are wrong by design; its time says what
the part it drops costs, or what the rest costs without it:

* ``no products``: the wgmma products are not issued; the weight stream
  still lands stage by stage, the encodings and the epilogues still run;
* ``no sincos``: the encoder warps skip the sines and cosines;
* ``3 stages``: a weight ring of 3 stages of 32 KB instead of 4;
* ``no bias or relu``: the epilogues between layers only round and pack;
* ``no head products``: the two 16-wide head products are replaced by an
  add that reads their operands (ptxas deletes products whose results
  nothing reads, and with them every product before).

Prints one JSON line per variant and turn, then the card's name and power
limit.  The variants build into ``learn_nerf_tpu_torch/_build/ablations/``.

    python -m learn_nerf_tpu_torch.scripts.mlp_ablations [variant ...]
"""

import argparse
import ctypes
import json
import shutil
import subprocess

import torch

from ..kernels import build
from ..kernels import fused_mlp as fm
from ..kernels import fused_render as fr
from ..models import NeRFModel
from .timing import cuda_ms

# Accumulators that a dropped product would have written start at zero, so
# that no variant computes on undefined values (which the compiler may
# treat as unreachable code).
ZEROED = [
    ("nerf_mlp.cuh", "  float acc[kHidden / 2];", "  float acc[kHidden / 2] = {};"),
    ("nerf_mlp.cuh", "  float head[8];", "  float head[8] = {};"),
    ("nerf_mlp.cuh", "  float cacc[kColor / 2];", "  float cacc[kColor / 2] = {};"),
]
KEEP = "0.f * __uint_as_float({0}[k][0] ^ {0}[k][1] ^ {0}[k][2] ^ {0}[k][3])"
VARIANTS = {
    "as built": [],
    "no products": [
        ("nerf_mlp.cuh", "      issue(k, sw128_desc(", "      if (false) issue(k, sw128_desc("),
        *ZEROED,
    ],
    "no sincos": [(
        "nerf_mlp.cuh",
        "if (p != nullptr) sincosf(ldexpf(x, f), &sine, &cosine);",
        "if (p != nullptr) sine = cosine = x;",
    )],
    "3 stages": [("nerf_mlp.cuh", "constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "no bias or relu": [
        ("nerf_mlp.cuh", "    float lo = acc[2 * i] + b.x;", "    float lo = acc[2 * i];"),
        ("nerf_mlp.cuh", "    float hi = acc[2 * i + 1] + b.y;", "    float hi = acc[2 * i + 1];"),
        ("nerf_mlp.cuh", "    if (relu) {", "    if (false) {"),
    ],
    # Each head product becomes one f32 add that still reads its A operand:
    # ptxas deletes products whose results nothing reads.
    "no head products": [
        ("nerf_mlp.cuh", "{ wgmma_n16_rs(head, a[k], b, sd); }", f"{{ head[0] += {KEEP.format('a')}; }}"),
        ("nerf_mlp.cuh", "{ wgmma_n16_rs(head, c[k], b, sd); }", f"{{ head[0] += {KEEP.format('c')}; }}"),
        ZEROED[1],
    ],
}


def variant_sources(out, name, edits):
    """A copy of ``csrc/`` in ``out`` with a variant's edits: (file, old
    text, new text), or (file, None, the file that takes its place,
    relative to ``csrc/``)."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, out)
    for file, old, new in edits:
        if old is None:
            shutil.copyfile(out / new, out / file)
            continue
        text = (out / file).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in {file}")
        (out / file).write_text(text.replace(old, new))


def build_variants(names, variants=VARIANTS):
    """Compile each variant's sources into its own library, in parallel
    (``variants``: name -> [(file, old text, new text)]; with ``None`` for
    the old text, the file is replaced by the file ``new text`` names,
    relative to ``csrc/``)."""
    root = build.BUILD_DIR / "ablations"
    procs = {}
    for name in names:
        out = root / name.replace(" ", "_")
        variant_sources(out, name, variants[name])
        sources = [str(p) for p in sorted(out.glob("*.cu"))]
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out / build.LIB_NAME), *sources]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} does not build:\n{log[-4000:]}")
        libs[name] = build._bind(ctypes.CDLL(str(out / build.LIB_NAME)))
    return libs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("variants", nargs="*", help=f"any of {list(VARIANTS)} (default: all)")
    args = parser.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        parser.error(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("mlp_ablations: no CUDA device; the ablations run on the card")
    device = torch.device("cuda")
    names = ["as built", *[v for v in args.variants or VARIANTS if v != "as built"]]
    libs = build_variants(names)

    gen = torch.Generator(device="cpu").manual_seed(0)
    torch.manual_seed(0)
    packed = NeRFModel(compute_dtype="bfloat16").to(device).packed()
    x = ((torch.rand(1 << 20, 3, generator=gen) - 0.5) * 1.4).to(device)
    d = torch.nn.functional.normalize(torch.randn(1 << 20, 3, generator=gen), dim=-1).to(device)
    n, k = 8192, 32
    points = ((torch.rand(n, k, 3, generator=gen) - 0.5) * 1.4).to(device)
    dirs = d[:n].contiguous()
    deltas = (torch.rand(n, k, generator=gen) * 0.25).to(device)
    built = build._library
    try:
        for turn in range(2):
            for name in names:
                build._library = libs[name]  # the wrappers launch from this library
                result = dict(
                    variant=name, turn=turn,
                    fused_mlp_ms=cuda_ms(lambda: fm.fused_mlp_cuda(packed, x, d)),
                    fused_render_ms=cuda_ms(
                        lambda: fr.fused_render_cuda(packed, points, dirs, deltas)),
                )
                print(json.dumps(result), flush=True)
    finally:
        build._library = built
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
