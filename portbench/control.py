"""The readings the limits of ``correct`` are set from, at a cell's own
size: the program's first steps against the reference on many seeds, the
control (the reference in the nearest precision below the
configuration's, ``check.CONTROL``) and the planted faults (``faults``)
in the program's place on a few.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 101,102,103 [--out FILE]

One JSON line a reading, to standard output and to FILE; the benchmark's
own runs never run this.  A step that returns its state unchanged reads 1
by the measure (``check.readings``) and needs no run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The leaves that read the widest gaps, for the look at a reading."""
    out = {}
    for key in ("grad1", "delta"):
        med = statistics.median(ref[key].values())
        gaps = {k: abs(prog[key].get(k, 0.0) - v) / max(v, med)
                for k, v in ref[key].items()}
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


def fused(cell) -> bool:
    return bool(cell.cfg["train"]["fused_prop"])


def faults(cell) -> dict:
    """{name: ``Cell.reference`` keywords} of the faults planted in the
    reference: half of every batch left out (the mean over the rest), and
    where the model takes labels each real label flipped and the fake
    labels drawn from each other's keys."""
    out = {"fault_half_batch": {"rows_kept": 0.5}}
    if cell.labels is not None:
        out["fault_labels_flipped"] = {"label_fault": "flip"}
        out["fault_fake_labels_wrong_key"] = {"label_fault": "wrong_key"}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.check import CONTROL, readings

    sink = open(args.out, "a") if args.out else None

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        t = time.time()
        cell = harness.Cell(args.workload, seed, args.device)
        prog = cell.first_steps()
        cell.free()
        ref = cell.reference()
        emit({"cell": args.workload, "kind": "program", "seed": seed,
              "readings": readings(prog, ref, fused(cell)),
              "worst": worst_leaves(prog, ref), "program": prog,
              "reference": ref, "s": time.time() - t})
        del cell
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        cell = harness.Cell(args.workload, seed, args.device,
                            program=False)
        ref = cell.reference()
        lowp = CONTROL[cell.cfg["train"]["precision"]]
        planted = {f"control_{lowp}": {"precision": lowp}, **faults(cell)}
        for kind, kw in planted.items():
            got = cell.reference(**kw)
            emit({"cell": args.workload, "kind": kind, "seed": seed,
                  "readings": readings(got, ref, fused(cell)),
                  "worst": worst_leaves(got, ref), "program": got,
                  "reference": ref})
        del cell
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
