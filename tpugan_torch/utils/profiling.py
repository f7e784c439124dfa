"""Tracing and profiling (port of ``tpugan/utils/profiling.py``).

- ``trace(out_dir)``: a ``torch.profiler`` window (CPU, and CUDA where a
  card is present) written as a Chrome trace, ``out_dir/trace.json``.
- ``cost_analysis(fn, *args)``: the operations and bytes of one call of
  ``fn``, counted as it runs.  ``flops`` is
  ``torch.utils.flop_counter.FlopCounterMode``'s count (matmuls and
  convolutions, forward and backward); ``bytes accessed`` is the sum over
  every aten op the call dispatches of its tensor operands' and results'
  bytes (views count nothing, a mutated operand once), read by a
  ``TorchDispatchMode``: the traffic of an unfused program, where the JAX package reads XLA's estimate of a compiled one.
  The hand-written kernels are opaque to both counters (a ctypes launch
  dispatches no aten op), so callers count a call of the same config under
  ``kernels="xla"`` with ``fuse_stats="off"``.
- ``sync``, ``timeit``: wall clock around work that ends in
  ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(out_dir: str):
    """Trace the block with ``torch.profiler`` into
    ``out_dir/trace.json``: ``with trace('runs/prof'): step(...)``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        sync()
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor operands and results.  A
    view (a result that aliases an operand without writing it: ``view``,
    ``t``, ``expand``, ``detach``) moves no memory and adds nothing; an
    in-place or ``out=`` op's result is its mutated operand, counted once
    among the operands."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aliases = [r.alias_info for r in func._schema.returns
                   if r.alias_info is not None]
        if any(not a.is_write for a in aliases):
            return out
        counted = (args, kwargs) if aliases else (args, kwargs, out)
        for t in tree_leaves(counted):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def cost_analysis(fn, *args, **kwargs) -> Dict[str, float]:
    """{'flops', 'bytes accessed'} of one call ``fn(*args, **kwargs)``,
    counted while it runs (see the module docstring)."""
    flops = FlopCounterMode(display=False)
    nbytes = _BytesMode()
    with flops, nbytes:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(nbytes.bytes)}


def sync() -> None:
    """Wait for every queued kernel of the current card (none without
    one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timeit(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds per call, each call ended by ``sync()``."""
    for _ in range(warmup):
        fn(*args)
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
