"""The fused MLP kernel (``kernels/fused_mlp``, the port of the Pallas MLP)
as a share of its roofline in the traced stretch of hierarchy frames: the
least time of its bf16 matrix products (2 FLOPs a multiply-add of the
configuration's widths, every sample of both passes of every tile) over
the time of every ``fused_mlp`` kernel."""

from nerfbench import roofline


def read(run):
    summary, work, cfg = run["trace"], run["work"], run["cell"].config
    if not summary or "fused_mlp" not in summary["port"]:
        return None
    seconds, calls = summary["port"]["fused_mlp"]
    per_frame = roofline.least_seconds(flops=roofline.model_flops(cfg, work["samples"], train=False),
                                       dtype="bfloat16")
    frames = calls / (2 * work["tiles"])  # a coarse and a fine pass a tile
    return 100.0 * frames * per_frame / seconds
