"""Run one cell of the benchmark of ``tpugan_torch`` and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The last line of standard output is one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (a profiled slice in the window), and in both the check
of the program's first steps against the plain reference, whose numbers
and limits are also the last lines of standard error.  Without a card,
with fewer cards than the cell asks for, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits with 1.

The program's build and kernel caches are kept at fixed directories inside
the checkout, so that only a checkout's first run builds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + start


T_START = _process_start()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpugan")


def _fixed_caches() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    chips = int(harness.load("workloads", args.workload).get("chips", 1))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s), {found} "
              f"found", file=sys.stderr)
        return 1
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_start=T_START)
    loaded = sorted({m.split(".")[0] for m in sys.modules
                     if m.split(".")[0] in FORBIDDEN})
    if loaded:
        print(f"portbench: {loaded} loaded in the measuring process",
              file=sys.stderr)
        return 1
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
