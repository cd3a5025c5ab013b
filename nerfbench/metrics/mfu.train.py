"""The whole training step's share of the card's peak: the model's
matrix-product FLOPs (forward and backward, at the configuration's widths,
on the samples a step evaluates: :mod:`nerfbench.work`) of the window's
steps outside the traced stretch over their time, against the peak of the
configuration's product precision (:mod:`nerfbench.roofline`)."""

from nerfbench import roofline


def read(run):
    spans, work, cell = run["window"].get("spans"), run["work"], run["cell"]
    if not spans or not spans["steps"]:
        return None
    cfg = dict(cell.config, **cell.traffic)
    flops = roofline.model_flops(cfg, work["samples_per_step"] * spans["steps"], train=True)
    return 100.0 * flops / spans["seconds"] / roofline.PEAK_FLOPS[cfg["compute_dtype"]]
