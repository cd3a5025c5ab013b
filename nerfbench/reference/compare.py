"""The numbers that decide ``correct``, each the gap between two readings
of one quantity.

Train cells (from the first three steps): ``loss_gap``, the widest
relative gap of a step's loss; ``grad_gap``, the worst leaf's gap between
the first gradient's norms; ``change_gap``, the worst leaf's gap between
the norms of the parameters' change after the steps.  A leaf's gap is
measured against the reference's norm of that leaf or of the median leaf,
whichever is larger (some gradients are all but zero); the change leaves
out the leaves whose reference gradient is under a thousandth of the
median leaf's (Adam moves those by round-off alone).

Frame cells: ``frame_gap``, the widest absolute gap of a pixel's colour
channel over the frames compared.
"""

import statistics
from typing import Dict, List

import numpy as np

QUIET_LEAF = 1e-3


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float], leaves) -> Dict[str, float]:
    floor = statistics.median(reference[k] for k in reference)
    return {k: abs(program.get(k, 0.0) - reference[k]) / max(reference[k], floor, 1e-30) for k in leaves}


def _leaf_gap(program: Dict[str, float], reference: Dict[str, float], leaves) -> float:
    return max(leaf_gaps(program, reference, leaves).values())


def train_gaps(program: dict, reference: dict) -> Dict[str, float]:
    """``program`` and ``reference`` each hold ``losses`` (a list),
    ``grad_norms`` and ``change_norms`` (leaf -> norm)."""
    losses: List[float] = program["losses"]
    loss_gap = max((abs(p - r) / abs(r) if np.isfinite(p) else float("inf"))
                   for p, r in zip(losses, reference["losses"]))
    grads = reference["grad_norms"]
    floor = statistics.median(grads.values())
    moving = [k for k, g in grads.items() if g >= QUIET_LEAF * floor]
    return dict(loss_gap=loss_gap, grad_gap=_leaf_gap(program["grad_norms"], grads, grads),
                change_gap=_leaf_gap(program["change_norms"], reference["change_norms"], moving))


def frame_gap(program: np.ndarray, reference: np.ndarray) -> float:
    if not np.all(np.isfinite(program)):
        return float("inf")
    return float(np.abs(program - reference).max())
