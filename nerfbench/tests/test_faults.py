"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the run is on the CPU at a small
size) and everything else runs, once for each fault a cell can have.  The
cells run on one card, so none has an exchange between cards to leave
out."""

import pytest
import torch

import learn_nerf_tpu_torch.render as render
import learn_nerf_tpu_torch.train as train
from learn_nerf_tpu_torch.occ_render import OccupancyFrameSession
from nerfbench import harness
from nerfbench.tests.conftest import CELLS, SEED, TINY


def driver_of(cell: str) -> str:
    """The driver (``train`` or ``frame``) of ``cell``'s traffic."""
    return harness.resolve_cell(cell, SEED, torch.device("cpu"), 0.0).traffic["driver"]


TRAIN_CELLS = [cell for cell in CELLS if driver_of(cell) == "train"]
FRAME_CELLS = [cell for cell in CELLS if driver_of(cell) == "frame"]


def run(cell):
    return harness.run_cell(cell, SEED + 3, 0.2, False, 0.0, torch.device("cpu"), TINY[cell])


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_sound_run_is_correct(cell):
    assert run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_state_left_unchanged(cell, monkeypatch):
    """Every step computes its loss and gradients and then leaves the
    parameters and the optimizer's state as they were."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result = run(cell)
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_batch_left_out(cell, monkeypatch):
    """Each step's loss is the mean over the first half of the batch."""
    for loop in (train.OccupancyTrainLoop, train.TrainLoop):
        original = loop._loss

        def half(self, renderer, background, batch, *args, _original=original, **draws):
            n = batch.shape[0] // 2
            draws = {k: (v[:n] if k in ("u", "u_coarse", "u_fine") and v is not None else v) for k, v in draws.items()}
            return _original(self, renderer, background, batch[:n], *args, **draws)

        monkeypatch.setattr(loop, "_loss", half)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", FRAME_CELLS)
def test_answer_altered(cell, monkeypatch):
    """One pixel of every frame is off by 0.05 where the frame is made."""

    def altered(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            out["outputs"][out["outputs"].shape[0] // 2] += 0.05
            return out
        return call

    monkeypatch.setattr(OccupancyFrameSession, "render", altered(OccupancyFrameSession.render))
    monkeypatch.setattr(render, "render_frame", altered(render.render_frame))
    assert not run(cell)["correct"]
