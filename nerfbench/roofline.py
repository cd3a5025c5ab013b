"""The yardstick of the per-layer shares: the H100's published peaks and
the operations and bytes of the work each cell's shapes need.

Peaks (NVIDIA's H100 SXM5 data sheet, dense, at the card's 700 W limit;
fixed here, never read from the environment): 67 TFLOP/s for f32 outside
the tensor cores (the program turns TF32 off), 989 TFLOP/s for bf16, 3.35
TB/s of HBM3.

Counting (the arithmetic that set each kernel's bound in ``PERF.md``):

* the models' matrix products: 2 FLOPs a multiply-add, at the widths of the
  configuration (``macs`` of ``fields/<field>.py``: :func:`ngp_macs`,
  :func:`nerf_macs`); a training step
  counts its forward and the backward's two products, three times the
  forward;
* the hash-grid encode: its points and outputs, and one read of each
  distinct table row its points touch; its table gradient: the points, the
  incoming cotangent and one write of each distinct row's gradient.  The
  share is the least time these bytes take over the kernels' time.
"""

from . import fields

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
F32 = 4


def ngp_macs(cfg: dict) -> int:
    """Multiply-adds a sample of the Instant-NGP MLPs."""
    h, enc = cfg["hidden_dim"], len(cfg["grid_sizes"]) * cfg["n_features_per_level"]
    dens = cfg["density_dim"]
    macs, width = 0, enc
    for _ in range(cfg["density_hidden_layers"]):
        macs, width = macs + width * h, h
    macs += width * dens
    width = 6 * cfg["dir_frequencies"] + dens
    for _ in range(cfg["color_hidden_layers"]):
        macs, width = macs + width * h, h
    return macs + width * 3


def nerf_macs(cfg: dict) -> int:
    """Multiply-adds a sample of the NeRF MLP (0.59 M at the paper's
    widths)."""
    h, c = cfg["netwidth"], cfg["view_width"]
    x, d = 6 * cfg["multires"], 6 * cfg["multires_views"]
    return (x * h + (cfg["input_layers"] - 1) * h * h + (h + x) * h + (cfg["mid_layers"] - 1) * h * h
            + h + (h + d) * c + c * 3)


def model_flops(cfg: dict, samples: float, train: bool) -> float:
    """Matrix-product FLOPs of ``samples`` field evaluations."""
    return 2.0 * fields.load(cfg["field"]).macs(cfg) * samples * (3 if train else 1)


def encode_bytes(points: int, levels: int, features: int, distinct_rows: int) -> int:
    return points * 3 * F32 + points * levels * features * F32 + distinct_rows * features * F32


def encode_backward_bytes(points: int, levels: int, features: int, distinct_rows: int) -> int:
    return points * 3 * F32 + points * levels * features * F32 + distinct_rows * features * F32


def least_seconds(nbytes: float = 0.0, flops: float = 0.0, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at the peak of their type."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
