"""The control comes out not correct: the plain reference computed in the
nearest precision below the configuration's (``check.CONTROL``: fp8 for
the bf16 cells, TF32 for the fp32 one), put in the program's place at
the cell's own size, fails the cell's limits; so does each planted fault
(``control.faults``).  On a card only:

    python -m pytest portbench/tests -m cuda -q
"""

from __future__ import annotations

import pytest
import torch

from portbench import check, control, harness
from portbench.tests.conftest import HERE

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", sorted(p.stem for p in
                                        (HERE / "workloads").glob("*.json")))
def test_control_fails_the_limits(cuda, cell):
    c = harness.Cell(cell, 3_000_000_007, cuda, program=False)
    ref = c.reference()
    lowp = check.CONTROL[c.cfg["train"]["precision"]]
    fused = c.cfg["train"]["fused_prop"]
    planted = [{"precision": lowp}, *control.faults(c).values()]
    for got in (c.reference(**kw) for kw in planted):
        ok, compared = check.judge(check.readings(got, ref, fused),
                                   c.work["limits"])
        assert not ok, compared
