"""The plain reference against ``tpugan_torch``'s CPU path at a small
width: the same draws, and the same first steps, FusedProp and
alternating, at fp32."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import threefry as ref_threefry


def test_draws_are_the_programs():
    from tpugan_torch.sample import threefry

    for seed in (0, 7, 2 ** 31 + 11):
        key = ref_threefry.split(ref_threefry.prng_key(seed), 3)[2]
        assert np.array_equal(
            key, threefry.split(threefry.prng_key(seed), 3)[2])
        for k in ref_threefry.split(key, 8):
            assert np.array_equal(ref_threefry.randint(k, 0, 202599, (64,)),
                                  threefry.randint(k, 0, 202599, (64,)))
            assert np.array_equal(ref_threefry.uniform(k, (64,)),
                                  threefry.uniform(k, (64, 1, 1, 1))
                                  .reshape(-1))
            assert np.array_equal(ref_threefry.normal(k, (8, 100)),
                                  threefry.normal(k, (8, 100)))


@pytest.mark.parametrize("cell", ["small.small_fp32",
                                  "small.small_fused_fp32"])
def test_first_steps_match_the_program_at_fp32(small_bench, cell):
    torch.manual_seed(0)
    c = harness.Cell(cell, 2 ** 31 + 3, "cpu")
    prog = c.first_steps()
    c.free()
    ref = c.reference()
    got = check.readings(prog, ref, c.cfg["train"]["fused_prop"])
    # fp32 on both sides: the sums in another order, through three steps
    # of Adam (its first update is lr * sign(g), so a gradient within
    # round-off of zero may flip a sign)
    assert got["loss1_gap"] < 1e-5 and got["grad1_med_gap"] < 1e-5, got
    assert got["delta_gap"] < 1e-2, got
    assert len(prog["loss"]) == check.STEPS
    assert set(prog["grad1"]) == set(ref["grad1"])


def test_bf16_program_reads_within_bf16(small_bench):
    c = harness.Cell("small.small_fast", 5, "cpu")
    prog = c.first_steps()
    c.free()
    got = check.readings(prog, c.reference(), True)
    assert 0 < got["loss1_gap"] < 2e-2, got
