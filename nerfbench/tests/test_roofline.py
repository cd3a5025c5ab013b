"""The yardstick's arithmetic against values worked by hand."""

import json
from pathlib import Path

import pytest

from nerfbench import roofline, work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
NGP = json.loads((CONFIGS / "instant_ngp.json").read_text())
NERF = json.loads((CONFIGS / "vanilla_nerf.json").read_text())


def test_ngp_macs():
    # 32 -> 64, 64 -> 16, (24 + 16) -> 64, 64 -> 64, 64 -> 3
    assert roofline.ngp_macs(NGP) == 32 * 64 + 64 * 16 + 40 * 64 + 64 * 64 + 64 * 3 == 9920


def test_nerf_macs():
    # 60 -> 256, 4 x 256 -> 256, (256 + 60) -> 256, 3 x 256 -> 256, 256 -> 1, (256 + 24) -> 128, 128 -> 3
    expected = 60 * 256 + 4 * 256 * 256 + 316 * 256 + 3 * 256 * 256 + 256 + 280 * 128 + 128 * 3
    assert roofline.nerf_macs(NERF) == expected == 591488


def test_model_flops():
    assert roofline.model_flops(NERF, 10, train=False) == 2 * 591488 * 10
    assert roofline.model_flops(NGP, 10, train=True) == 3 * 2 * 9920 * 10
    # A hierarchy train step of 4096 rays (64 coarse + 192 fine samples): 3.72 TFLOP.
    assert roofline.model_flops(NERF, 4096 * 256, train=True) == pytest.approx(3.7213e12, rel=1e-4)


def test_encode_bytes():
    # 1000 points, 16 levels x 2 features, 5000 distinct rows: points, outputs, rows.
    assert roofline.encode_bytes(1000, 16, 2, 5000) == 1000 * 12 + 1000 * 128 + 5000 * 8 == 180000
    assert roofline.encode_backward_bytes(1000, 16, 2, 5000) == 180000


def test_least_seconds():
    assert roofline.least_seconds(nbytes=3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(flops=989e12, dtype="bfloat16") == pytest.approx(1.0)
    assert roofline.least_seconds(nbytes=3.35e9, flops=67e12) == pytest.approx(1.0)


def test_ngp_tables():
    # Six levels fit 2^19 rows densely (16^3, 32^3, 64^3 twice each), ten hash.
    dense = [g**3 for g in NGP["grid_sizes"] if g**3 <= 2**19]
    assert len(dense) == 6
    rows = sum(dense) + 10 * 2**19
    assert rows * 2 * 4 == pytest.approx(46.7e6, rel=1e-3)


@pytest.mark.parametrize("demand,budget", [(0.7, 1), (1.5, 2), (1.6, 3), (1.9, 3), (2.4, 4), (30.0, 32)])
def test_auto_budget(demand, budget):
    assert work.auto_budget(demand, 32) == budget


@pytest.mark.parametrize("demand", [0.1 * i for i in range(1, 300)])
def test_auto_budget_is_the_programs(demand):
    from learn_nerf_tpu_torch.acceleration import auto_budget_from_demand

    assert work.auto_budget(demand, 32) == auto_budget_from_demand(demand, 32)
