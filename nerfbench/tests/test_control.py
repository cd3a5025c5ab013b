"""The control comes out not correct: the reference put in the program's
place and computed one precision step below the configuration's (TF32 for
the f32 models, float8 e4m3 for the bf16 MLP) fails one of the cell's
limits, while the program passes every one.  On the CPU at a small size;
on the card (``-m cuda``) at the cell's own size, as
``nerfbench/control.py`` reads it for the limits."""

import pytest
import torch

from nerfbench import control, harness
from nerfbench.tests.conftest import CELLS, SEED, TINY


def limits(cell):
    return harness.load_json(harness.BENCH_DIR / "workloads" / f"{cell}.json")["limits"]


def fails(numbers, cell):
    return any(v > limits(cell)[k] for k, v in numbers.items())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell):
    r = control.readings(cell, SEED + 5, 0.2, torch.device("cpu"), TINY[cell])
    assert not fails(r["program"], cell), r
    assert fails(r["control"], cell), r
    assert fails(r["half_batch" if "half_batch" in r else "altered"], cell), r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(cell, card):
    r = control.readings(cell, SEED + 7, 2.0, card)
    assert not fails(r["program"], cell), r
    assert fails(r["control"], cell), r
