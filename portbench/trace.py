"""The profiled slice, reduced: the device's operations and the host's
spans from ``torch.profiler``'s events (CPU and CUDA activities), the
union of the device's busy intervals, and the breakdown that the result
line carries.

Times are the profiler's, in seconds.  A device operation is every event
on the CUDA device: kernels, copies and fills; a launch is a kernel (a
copy or a fill is not).  The slice is the benchmark's span ``SLICE``.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from dataclasses import dataclass, field

SLICE = "portbench.slice"
SPAN_PREFIX = "portbench."
TOP = 10


@dataclass
class Trace:
    """The slice's device operations and host events."""

    t0: float
    t1: float
    device: list = field(default_factory=list)  # (name, start, end)
    host: list = field(default_factory=list)  # (name, start, end, thread)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self) -> list:
        return [e for e in self.device if not is_copy_or_fill(e[0])]

    def busy_intervals(self) -> list:
        """The device's busy intervals, merged, clipped to the slice."""
        spans = sorted((max(s, self.t0), min(e, self.t1))
                       for _, s, e in self.device if e > self.t0
                       and s < self.t1)
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the slice with no device
        operation running."""
        gaps, at = [], self.t0
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def host_labels(self):
        """A function of time t: what the host's main thread (the one that
        ran the slice) was doing at t, the innermost benchmark span and,
        inside it, the outermost PyTorch operator."""
        spans = _outermost(sorted((s, e, n[len(SPAN_PREFIX):])
                                  for n, s, e, _ in self.host
                                  if n.startswith(SPAN_PREFIX)
                                  and n != SLICE))
        main = next(t for n, _, _, t in self.host if n == SLICE)
        ops = _outermost(sorted((s, e, n) for n, s, e, t in self.host
                                if t == main and n.startswith("aten::")))

        def label(t: float) -> str:
            span = _at(spans, t) or "window"
            op = _at(ops, t)
            return span if op is None else f"{span}: {op}"
        return label

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time
        by what the host was doing, TOP of each, in seconds."""
        by_op: dict = defaultdict(float)
        for name, s, e in self.device:
            by_op[name[:160]] += e - s
        by_label: dict = defaultdict(float)
        label = self.host_labels()
        for s, e in self.idle_gaps():
            by_label[label(s)] += e - s
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_label)}


def _outermost(items: list) -> list:
    """The intervals of (start, end, name), sorted by start, that no
    earlier one contains."""
    out: list = []
    for s, e, n in items:
        if not out or s >= out[-1][1]:
            out.append((s, e, n))
    return out


def _at(items: list, t: float):
    """The name of the interval of ``items`` (disjoint, sorted) holding t."""
    i = bisect.bisect_right(items, (t, math.inf)) - 1
    return items[i][2] if i >= 0 and items[i][0] <= t < items[i][1] else None


def is_copy_or_fill(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def from_profiler(prof) -> Trace:
    """The slice of a stopped ``torch.profiler.profile``: its events read
    from the profiler's own results, without building the operator tree."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type().name != "CUDA":
            host.append((name, start, end, e.start_thread_id()))
        elif not (e.is_user_annotation() or name.startswith(SPAN_PREFIX)):
            # (a span's copy on the device's timeline is no operation)
            device.append((name, start, end))
    spans = [(s, e) for name, s, e, _ in host if name == SLICE]
    if not spans:
        raise RuntimeError(f"the profiled slice has no {SLICE} span")
    t0, t1 = spans[0]
    return Trace(t0, t1, device, host)
