"""The hash-grid encode (``kernels/hashgrid_encode``) as a share of its
roofline in the traced stretch of pooled frames: the least time its bytes
take (:mod:`nerfbench.roofline`, on each tile's pool rows and the distinct
table rows its points touch, averaged over a frame's tiles) over the time
of every ``hashgrid_encode`` kernel."""

from nerfbench import roofline


def read(run):
    summary, work, cfg = run["trace"], run["work"], run["cell"].config
    if not summary or "distinct_rows" not in work or "hashgrid_encode" not in summary["port"]:
        return None
    seconds, calls = summary["port"]["hashgrid_encode"]
    levels, features = len(cfg["grid_sizes"]), cfg["n_features_per_level"]
    per_call = roofline.least_seconds(roofline.encode_bytes(
        work["pool_rows"], levels, features, work["distinct_rows"])) / work["tiles"]
    return 100.0 * calls * per_call / seconds
