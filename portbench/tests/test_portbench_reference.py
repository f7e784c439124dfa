"""The plain reference against ``tpugan_torch``'s CPU path at a small
width: the same draws, and the same first steps, FusedProp and
alternating, unconditional and conditional, at fp32; and the
unconditional reference's weights, data and steps as they were before it
took the conditional DCGAN."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from portbench import check, dataset, harness
from portbench.reference import threefry as ref_threefry
from portbench.reference import train as ref_train


def test_draws_are_the_programs():
    from tpugan_torch.sample import threefry

    for seed in (0, 7, 2 ** 31 + 11):
        key = ref_threefry.split(ref_threefry.prng_key(seed), 3)[2]
        assert np.array_equal(
            key, threefry.split(threefry.prng_key(seed), 3)[2])
        for k in ref_threefry.split(key, 8):
            assert np.array_equal(ref_threefry.randint(k, 0, 202599, (64,)),
                                  threefry.randint(k, 0, 202599, (64,)))
            # the fake labels of two classes
            assert np.array_equal(ref_threefry.randint(k, 0, 2, (64,)),
                                  threefry.randint(k, 0, 2, (64,)))
            assert np.array_equal(ref_threefry.uniform(k, (64,)),
                                  threefry.uniform(k, (64, 1, 1, 1))
                                  .reshape(-1))
            assert np.array_equal(ref_threefry.normal(k, (8, 100)),
                                  threefry.normal(k, (8, 100)))


@pytest.mark.parametrize("cell", ["small.small_fp32",
                                  "small.small_fused_fp32",
                                  "small.small_cond_fp32",
                                  "small.small_cond_fused_fp32"])
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


@pytest.mark.parametrize("cell", ["small.small_fast", "small.small_cond"])
def test_bf16_program_reads_within_bf16(small_bench, cell):
    c = harness.Cell(cell, 5, "cpu")
    prog = c.first_steps()
    c.free()
    got = check.readings(prog, c.reference(), c.cfg["train"]["fused_prop"])
    assert 0 < got["loss1_gap"] < 2e-2, got


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# SHA-256 of the unconditional reference's weights, data and three steps
# at seed 2**31 + 29 (CPU, one thread), recorded before the reference took
# the conditional DCGAN: the fused cells' reference steps are one.
IMAGES = "8eb79a684b908dd17752817364c59d6fe3277bea15a7eb62365b1908386e7a20"
WEIGHTS = "1d49bb90e2686a3dc89d484280098c18d7e502d4789d0c599e5d379bf910e1d9"
FUSED = "2be9b0210cfffbfdebaeac2c8f2f28543bac5eef7ea7cb42343797edad88f20c"
FOLLOW = {"small.small_fast": FUSED, "small.small_fused_fp32": FUSED,
          "small.small_fp32":
          "ad7a781710851b30d75ba197f5515c7eebce13e30784a78f4c6cde4d3364520a"}


@pytest.mark.parametrize("cell", sorted(FOLLOW))
def test_unconditional_reference_does_not_drift(small_bench, cell):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        seed = 2 ** 31 + 29
        work = harness.load("workloads", cell)
        cfg = harness.config_as_run(harness.load("configs", work["config"]),
                                    work, seed)
        images = dataset.make_images(64, 64, 3, seed, "cpu")
        weights = ref_train.of(cfg["model"]).make_weights(cfg["model"], seed,
                                                          "cpu")
        m = hashlib.sha256()
        for part in ("g", "d"):
            for k in sorted(weights[part]):
                m.update(k.encode())
                m.update(weights[part][k].numpy().tobytes())
        out = ref_train.follow(cfg, weights, images, seed,
                               feed=harness.feed_of(cfg), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert cfg["model"]["n_classes"] == 0
    assert _sha(images.tobytes()) == IMAGES
    assert m.hexdigest() == WEIGHTS
    assert _sha(json.dumps(out, sort_keys=True).encode()) == FOLLOW[cell]
