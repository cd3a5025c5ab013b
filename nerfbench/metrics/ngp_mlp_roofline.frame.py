"""The Instant-NGP MLP kernel (``kernels/ngp_mlp``, the MLP forward of f32
frames) as a share of its roofline in the traced stretch of pooled frames:
the least time of its f32 matrix products (2 FLOPs a multiply-add of the
configuration's widths, on each tile's pool rows, averaged over a frame's
tiles) over the time of every ``ngp_mlp`` kernel."""

from nerfbench import roofline, trace


def read(run):
    summary, work, cfg = run["trace"], run["work"], run["cell"].config
    if not summary or "pool_rows" not in work:
        return None
    seconds, calls = trace.kernel_totals(summary, "ngp_mlp")
    if not calls:
        return None
    per_call = roofline.least_seconds(flops=2.0 * roofline.ngp_macs(cfg) * work["pool_rows"] / work["tiles"])
    return 100.0 * calls * per_call / seconds
