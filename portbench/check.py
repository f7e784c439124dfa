"""What decides ``correct``: the program's first steps, observed on the
timed object (``FirstSteps``), against the plain reference's
(``reference/train.py``) from the same weights, data and draws.

The numbers:

- ``loss1_gap``: step 1's losses taken before any update, the largest
  |program - reference| / |reference|; ``loss_gap`` every loss of the
  first three steps;
- ``grad1_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient (Adam's first moment after one update, over
  1 - beta1) and the reference's, over the larger of the reference's norm
  of that leaf and of the median leaf; ``grad1_med_gap`` the median of
  those gaps over the leaves whose first gradient precedes any update;
- ``delta_gap``: the same as ``grad1_gap`` of each leaf's change over the
  three steps (the parameters step 4 starts from), over the leaves whose
  reference first gradient is at least a thousandth of the median leaf's
  (a leaf with none moves under Adam by round-off alone).

A cell compares those its workload file gives a limit (``judge``); the
others are printed beside them.  The worst cases swing with one leaf
(G's last bias, a sum of terms that cancel) and with Adam's first update
(lr x sign(g) flips elements whose gradient is round-off, and the
alternating step's G update follows D's), so the cells compare the
steady ``loss1_gap`` and ``grad1_med_gap`` in their place.
A number the program did not give (no update, a missing leaf) reads as a
norm of 0: a leaf the reference moves reads 1.
"""

from __future__ import annotations

import math
import statistics

import torch

from portbench.reference.dcgan import bce_losses

NAMES = ("loss1_gap", "loss_gap", "grad1_gap", "grad1_med_gap",
         "delta_gap")
# the control: the reference in the nearest precision below the
# configuration's (TF32 for fp32 with TF32 off; fp8 for bf16)
CONTROL = {"fp32": "tf32", "bf16": "fp8"}
STEPS = 3
UNMOVED = 1e-3  # share of the median leaf's gradient a counted leaf has


class FirstSteps:
    """Hooks on the timed object that read its first ``STEPS`` steps: D's
    logits (the losses follow from them), each optimizer's first moment
    after its first update, and each parameter's change after the third,
    against the weights the benchmark loaded (``start``)."""

    def __init__(self, state, start: dict, fused: bool, beta1: float):
        self.start, self.beta1 = start, beta1
        self.per_step = 2 if fused else 3  # D forwards a step
        self.logits: list = []
        self.grad1: dict = {}
        self.delta: dict = {}
        self.updates = {"g": 0, "d": 0}
        self.handles = [state.d.register_forward_hook(self._on_d)]
        for part, module, opt in (("g", state.g, state.opt_g),
                                  ("d", state.d, state.opt_d)):
            self.handles.append(opt.register_step_post_hook(
                self._on_update(part, module, opt)))

    def _on_d(self, module, inputs, output):
        if len(self.logits) < STEPS * self.per_step:
            self.logits.append(output.detach().float().clone())

    def _on_update(self, part, module, opt):
        @torch.no_grad()
        def hook(optimizer, args, kwargs):
            self.updates[part] += 1
            n = self.updates[part]
            for name, p in module.named_parameters():
                key = f"{part}.{name}"
                if n == 1:
                    m = opt.state.get(p, {}).get("exp_avg")
                    self.grad1[key] = (torch.zeros(()) if m is None else
                                       m.float().norm() / (1 - self.beta1))
                if n == STEPS:
                    self.delta[key] = (p.detach().float()
                                       - self.start[part][name]).norm()
        return hook

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def result(self) -> dict:
        """{"loss": [[loss_d, loss_g] a step], "grad1", "delta"} as
        floats, in ``reference.train.follow``'s form."""
        loss = []
        for s in range(len(self.logits) // self.per_step):
            c = self.logits[s * self.per_step:(s + 1) * self.per_step]
            loss.append([float(v) for v in bce_losses(c[0], c[1], c[-1])])
        return {"loss": loss,
                "grad1": {k: float(v) for k, v in self.grad1.items()},
                "delta": {k: float(v) for k, v in self.delta.items()}}


def _gaps(prog: dict, ref: dict, keys) -> list:
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med) for k in keys]


def _loss_gap(prog: list, ref: list) -> float:
    if len(prog) < len(ref):
        return math.inf
    return max(abs(p - r) / abs(r) for ps, rs in zip(prog, ref)
               for p, r in zip(ps, rs))


def readings(prog: dict, ref: dict, fused: bool) -> dict:
    """The numbers of the program's first steps against the reference's.
    ``loss1_gap`` and ``grad1_med_gap`` take only what step 1 computes
    before any update: both losses and every leaf under FusedProp; D's
    loss and D's leaves in the alternating step, whose G update follows
    D's first one."""
    g_med = statistics.median(ref["grad1"].values())
    moved = [k for k, v in ref["grad1"].items() if v >= UNMOVED * g_med]
    before = [k for k in ref["grad1"] if fused or k.startswith("d.")]
    n = 2 if fused else 1
    return {"loss1_gap": _loss_gap([p[:n] for p in prog["loss"][:1]],
                                   [r[:n] for r in ref["loss"][:1]]),
            "loss_gap": _loss_gap(prog["loss"], ref["loss"]),
            "grad1_gap": max(_gaps(prog["grad1"], ref["grad1"],
                                   list(ref["grad1"]))),
            "grad1_med_gap": statistics.median(
                _gaps(prog["grad1"], ref["grad1"], before)),
            "delta_gap": max(_gaps(prog["delta"], ref["delta"], moved))}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that has a limit finite and within it, {name:
    {"value", "limit"}} of those).  A cell with no limit is not correct."""
    out = {}
    for name in NAMES:
        if limits.get(name) is not None:
            v = values[name]
            out[name] = {"value": v if math.isfinite(v) else 1e300,
                         "limit": limits[name]}
    ok = bool(out) and all(c["value"] <= c["limit"] for c in out.values())
    return ok, out
