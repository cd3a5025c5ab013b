"""The whole frame's share of the card's peak: the model's matrix-product
FLOPs (forward, at the configuration's widths, on the samples a frame
evaluates: :mod:`nerfbench.work`) of the window's frames outside the
traced stretch over their time, against the peak of the configuration's
product precision (:mod:`nerfbench.roofline`)."""

from nerfbench import roofline


def read(run):
    window, work, cell = run["window"], run["work"], run["cell"]
    if not window.get("frames"):
        return None
    cfg = dict(cell.config, **cell.traffic)
    flops = roofline.model_flops(cfg, work["samples"] * window["frames"], train=False)
    return 100.0 * flops / window["seconds"] / roofline.PEAK_FLOPS[cfg["compute_dtype"]]
