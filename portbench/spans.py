"""The program's own spans in the profiled slice: ``tpugan_torch``'s
``utils/tracing.py`` names each ``tpugan_torch.<name>`` through
``torch.profiler.record_function``, which the profiler stamps on the same
timeline as the device's operations and the CUDA runtime's calls.

All is read from ``Trace.host``: the spans of the main thread (the one that
ran the slice's span), clipped to the slice.  A program without a span
gives nothing to read (None), which is what a program from before its spans
gives.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Optional

from portbench.trace import SLICE, SPAN_PREFIX

PROGRAM = "tpugan_torch."
DISPATCH = SPAN_PREFIX + "dispatch"
# the runtime's calls after which the host has waited for the device
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"))


def _main(trace) -> list:
    """(start, end, name) of the main thread's spans, the benchmark's and
    the program's, the slice's own among them."""
    main = next(t for n, _, _, t in trace.host if n == SLICE)
    return [(s, e, n) for n, s, e, t in trace.host
            if t == main and n.startswith((PROGRAM, SPAN_PREFIX))]


def span_seconds(trace, name: str) -> Optional[float]:
    """The seconds of the program's span ``tpugan_torch.<name>`` on the
    main thread in the slice, summed over its occurrences; None where it
    never occurs."""
    full = PROGRAM + name
    found = [(max(s, trace.t0), min(e, trace.t1))
             for s, e, n in _main(trace) if n == full]
    if not found:
        return None
    return sum(max(e - s, 0.0) for s, e in found)


def innermost(spans: list) -> list:
    """Disjoint (start, end, name) segments, sorted, each named by the
    innermost of the nested ``spans`` (start, end, name) that holds it; a
    span that ends after its parent is cut at the parent's end."""
    segs: list = []
    stack: list = []  # (end, name), innermost last
    at = None

    def close_until(t):
        nonlocal at
        while stack and stack[-1][0] <= t:
            end, name = stack.pop()
            segs.append((at, end, name))
            at = end

    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        if stack:
            segs.append((at, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        stack.append((e, n))
        at = s
    close_until(float("inf"))
    return [x for x in segs if x[1] > x[0]]


def _label_at(segs: list, starts: list, t: float) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else None


def idle_by_span(trace) -> dict:
    """The slice's device-idle seconds by the innermost span the main
    thread was in: a program span (``tpugan_torch.<name>``) or, outside
    every one, the benchmark's (``portbench.dispatch`` and its siblings,
    ``portbench.slice`` outside them all).  A gap that crosses a span's
    edge is split at it.  None where the slice has no program span."""
    spans = _main(trace)
    if not any(n.startswith(PROGRAM) for _, _, n in spans):
        return None
    segs = innermost(spans)
    out: dict = defaultdict(float)
    i = 0
    for gs, ge in trace.idle_gaps():  # both sorted and disjoint
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < ge:
            s, e, n = segs[j]
            out[n] += max(0.0, min(e, ge) - max(s, gs))
            j += 1
    return dict(out)


def syncs_in_dispatch(trace) -> list:
    """The runtime's synchronising calls (``SYNCS``) that start inside the
    benchmark's ``portbench.dispatch`` spans: the name of each call's
    innermost span, in order."""
    spans = _main(trace)
    segs = innermost(spans)
    starts = [s for s, _, _ in segs]
    dispatch = sorted((s, e) for s, e, n in spans if n == DISPATCH)
    d_starts = [s for s, _ in dispatch]
    out = []
    for n, s, _, _ in sorted(trace.host, key=lambda x: x[1]):
        if n.split("_v")[0] not in SYNCS:
            continue
        i = bisect.bisect_right(d_starts, s) - 1
        if i >= 0 and s < dispatch[i][1]:
            out.append(_label_at(segs, starts, s))
    return out
