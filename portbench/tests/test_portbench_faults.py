"""A run with the timed path broken underneath comes out not correct:
the step that leaves the state unchanged, and half of every batch left
out (the mean over the rest).  The run skips the look for a card and
runs on the CPU at a small width, under the fp32 cell's limits; the
sound run beside them is correct.  Where the model takes labels, the
program's first steps fail those limits against a reference given the
wrong labels (``control.faults``): the comparison sees them."""

from __future__ import annotations

import pytest
import torch

from portbench import check, control, harness

CELLS = ["small.small_fp32", "small.small_fused_fp32",
         "small.small_cond_fp32", "small.small_cond_fused_fp32"]
COND = [c for c in CELLS if "cond" in c]


def run(cell):
    return harness.run_cell(cell, 2 ** 31 + 17, 0.3, False, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(small_bench, cell):
    out = run(cell)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "check" and out["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(small_bench, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = run(cell)
    assert not out["correct"]
    assert out["check"]["delta_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_left_out(small_bench, cell, monkeypatch):
    from tpugan_torch.models.dcgan import Discriminator

    forward = Discriminator.forward
    monkeypatch.setattr(Discriminator, "forward",
                        lambda self, x: forward(self, x[:x.shape[0] // 2]))
    out = run(cell)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("fault", ["fault_labels_flipped",
                                   "fault_fake_labels_wrong_key"])
@pytest.mark.parametrize("cell", COND)
def test_wrong_labels_fail_the_limits(small_bench, cell, fault):
    c = harness.Cell(cell, 2 ** 31 + 17, "cpu")
    prog = c.first_steps()
    c.free()
    fused = c.cfg["train"]["fused_prop"]
    sound = check.judge(check.readings(prog, c.reference(), fused),
                        c.work["limits"])
    assert sound[0], sound[1]
    wrong = c.reference(**control.faults(c)[fault])
    ok, compared = check.judge(check.readings(prog, wrong, fused),
                               c.work["limits"])
    assert not ok, compared
