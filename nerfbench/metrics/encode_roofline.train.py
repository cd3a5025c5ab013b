"""The hash-grid encode and its table gradient (``kernels/hashgrid_encode``,
``kernels/hashgrid_backward``) as a share of their roofline in the traced
stretch of occupancy train steps: the least time their bytes take
(:mod:`nerfbench.roofline`, on the points a step encodes and the distinct
table rows they touch: :mod:`nerfbench.work`) over the time of every
``hashgrid_encode`` and ``hashgrid_backward`` kernel."""

from nerfbench import roofline


def read(run):
    summary, work, cfg = run["trace"], run["work"], run["cell"].config
    if not summary or "distinct_rows" not in work:
        return None
    port = summary["port"]
    if "hashgrid_encode" not in port or "hashgrid_backward" not in port:
        return None
    levels, features = len(cfg["grid_sizes"]), cfg["n_features_per_level"]
    rows, distinct = work["pool_rows"], work["distinct_rows"]
    least = (port["hashgrid_encode"][1] * roofline.least_seconds(
        roofline.encode_bytes(rows, levels, features, distinct))
        + port["hashgrid_backward"][1] * roofline.least_seconds(
            roofline.encode_backward_bytes(rows, levels, features, distinct)))
    return 100.0 * least / (port["hashgrid_encode"][0] + port["hashgrid_backward"][0])
