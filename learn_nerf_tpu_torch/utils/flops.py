"""Roofline accounting of a step: matmul FLOPs and MFU against the H100's
peaks (port of ``learn_nerf_tpu.utils.flops``).

:func:`traced_flops` runs a function once under
``torch.utils.flop_counter.FlopCounterMode`` and counts the FLOPs of its
matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``: what ``matmul``,
``linear`` and ``einsum`` become), forward and backward: the JAX package's
``jaxpr_matmul_flops`` convention (2*M*N*K per ``dot_general``;
elementwise work, gathers and scatters are not matrix-unit FLOPs).  The
port's hand-written kernels launch through ctypes, not as aten ops, so the
counter cannot see them: the two that multiply matrices, fused_mlp and
fused_render (the vanilla ``--bf16`` serving route), add their layers'
FLOPs analytically while the function runs.  The others (the hash-grid,
composite and baked kernels) do no matrix products.

The JAX module's ``lowered_cost`` reads XLA's HLO cost analysis of a
compiled program (FLOPs and bytes accessed); PyTorch has no counterpart,
so there is none here and every count has no byte side.

Peaks of one NVIDIA H100 SXM5 (NVIDIA's data sheet, dense, at the card's
700 W power limit), overridable by the JAX module's variables
``NERF_TPU_PEAK_FLOPS`` and ``NERF_TPU_PEAK_BYTES``:

* f32 GEMMs: 66.9 TFLOP/s outside the tensor cores (``default_device()``
  turns TF32 off, so f32 products run there);
* bf16 GEMMs: 989.4 TFLOP/s on the tensor cores;
* HBM3: 3.35 TB/s.
"""

import contextlib
import os
from typing import Dict, Optional

H100_PEAK_FLOPS = {"float32": 66.9e12, "bfloat16": 989.4e12}
H100_PEAK_BYTES_PER_SEC = 3.35e12
MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm")


def layer_macs(packed) -> int:
    """Multiply-adds a point of a vanilla MLP's kernel operands
    (:class:`~..kernels.fused_mlp.PackedMLP`), at the model's own widths
    (the operands' zero padding excluded)."""
    h, c = packed.hidden, packed.color
    x, d = 6 * packed.x_freqs, 6 * packed.d_freqs
    return (x * h + (packed.input_layers - 1) * h * h + (h + x) * h + (packed.mid_layers - 1) * h * h
            + h * 1 + (h + d) * c + c * 3)


@contextlib.contextmanager
def _counting_fused_kernels(totals: Dict[str, float]):
    """Inside, each launch of fused_mlp or fused_render adds its layers'
    FLOPs (2 * MACs a point) to ``totals["analytic"]``."""
    from ..kernels import fused_mlp as fm
    from ..kernels import fused_render as fr

    saved = fm.fused_mlp_cuda, fr.fused_render_cuda

    def mlp(packed, x, d):
        totals["analytic"] += 2.0 * layer_macs(packed) * x.shape[0]
        return saved[0](packed, x, d)

    def render(packed, points, dirs, deltas):
        totals["analytic"] += 2.0 * layer_macs(packed) * points.shape[0] * points.shape[1]
        return saved[1](packed, points, dirs, deltas)

    fm.fused_mlp_cuda, fr.fused_render_cuda = mlp, render
    try:
        yield
    finally:
        fm.fused_mlp_cuda, fr.fused_render_cuda = saved


def traced_flops(fn, *args, **kwargs) -> Optional[Dict[str, float]]:
    """Run ``fn(*args, **kwargs)`` once, counting its matrix products'
    FLOPs; a ``roofline`` cost dict (``flops``, ``bytes`` None, ``source``,
    ``by_op``), or None when it counted none (callers then omit MFU, never
    report it as 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    totals = {"analytic": 0.0}
    with FlopCounterMode(display=False) as counter, _counting_fused_kernels(totals):
        fn(*args, **kwargs)
    counts = counter.get_flop_counts().get("Global", {})
    by_op = {str(op).split(".")[-1]: float(n) for op, n in counts.items()}
    by_op = {op: n for op, n in by_op.items() if op in MATMUL_OPS}
    if totals["analytic"]:
        by_op["fused kernels"] = totals["analytic"]
    flops = sum(by_op.values())
    if flops <= 0.0:
        return None
    source = "aten-matmul" + ("+fused-kernels" if totals["analytic"] else "")
    return dict(flops=flops, bytes=None, source=source, by_op=by_op)


def roofline(cost: Optional[Dict[str, float]], seconds: float, dtype: str = "float32") -> Dict[str, float]:
    """Achieved rates against the card's peaks for one execution of
    ``seconds`` (unrounded): the JAX module's keys (``tflops``, ``mfu``,
    ``flops_source``; with a byte count ``gbps``, ``bw_util``, ``bound``,
    ``speed_of_light_frac``).  ``dtype`` picks the matmul peak
    (:data:`H100_PEAK_FLOPS`)."""
    if cost is None or seconds <= 0:
        return {}
    peak_flops = float(os.environ.get("NERF_TPU_PEAK_FLOPS", H100_PEAK_FLOPS[dtype]))
    peak_bytes = float(os.environ.get("NERF_TPU_PEAK_BYTES", H100_PEAK_BYTES_PER_SEC))
    achieved_flops = cost["flops"] / seconds
    if cost.get("bytes") is None:
        return dict(tflops=achieved_flops / 1e12, mfu=achieved_flops / peak_flops,
                    flops_source=cost.get("source", "aten-matmul"))
    achieved_bytes = cost["bytes"] / seconds
    compute_time = cost["flops"] / peak_flops
    memory_time = cost["bytes"] / peak_bytes
    return dict(
        tflops=achieved_flops / 1e12,
        mfu=achieved_flops / peak_flops,
        gbps=achieved_bytes / 1e9,
        bw_util=achieved_bytes / peak_bytes,
        bound="compute" if compute_time >= memory_time else "memory",
        speed_of_light_frac=max(compute_time, memory_time) / seconds,
    )
