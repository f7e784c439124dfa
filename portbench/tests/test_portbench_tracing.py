"""The readers of the program's own spans and counters, on a synthetic
slice: the spans' seconds, the device's idle time split by the innermost
span the main thread was in, the runtime's synchronising calls inside the
benchmark's dispatch spans, and nothing to read where the program has no
span or its counter of blocking copies outnumbers the calls found."""

from __future__ import annotations

import pytest

from portbench import harness, spans, trace
from portbench.metrics import (draw_ms, host_syncs_per_step,
                               input_produce_ms, update_ms)
from tpugan_torch.utils import tracing

P = "tpugan_torch."


def _trace(program: bool = True) -> trace.Trace:
    """A 12 s slice of two calls of one step each (1-5 and 7-11 s); the
    device busy 0-1.5, 3-4.25, 6-7.5 and 9-9.5 s."""
    host = [(trace.SLICE, 0.0, 12.0, 1),
            ("portbench.dispatch", 0.5, 5.5, 1),
            ("portbench.dispatch", 5.5, 11.5, 1),
            ("portbench.fetch", 11.5, 12.0, 1),
            ("aten::add", 2.5, 2.6, 1)]
    if program:
        for t in (0.0, 6.0):
            host += [(P + "step", t + 1.0, t + 5.0, 1),
                     (P + "step.draws", t + 1.0, t + 2.0, 1),
                     (P + "step.grads", t + 2.5, t + 4.0, 1),
                     (P + "step.d_update", t + 4.0, t + 4.5, 1),
                     (P + "step.g_update", t + 4.5, t + 5.0, 1),
                     (P + "step.ema", t + 4.75, t + 5.0, 1)]
    # the runtime's calls, under the runtime's own thread numbers
    host += [("cudaEventSynchronize", 0.2, 0.3, 7),  # outside dispatch
             ("cudaStreamSynchronize", 1.2, 1.3, 7),
             ("cudaMemcpy", 7.3, 7.35, 7),
             ("cudaMemcpyAsync", 7.4, 7.45, 7),  # not a sync
             ("cudaStreamSynchronize", 10.2, 10.3, 7),
             ("cudaDeviceSynchronize", 11.7, 11.8, 7)]  # in the fetch
    device = [("k1", 0.0, 1.5), ("k2", 3.0, 4.25), ("k3", 6.0, 7.5),
              ("Memcpy HtoD", 9.0, 9.5)]
    return trace.Trace(0.0, 12.0, device, host)


def _run(t, monkeypatch, counters=None, feed="resident"):
    monkeypatch.setattr(tracing, "counters", lambda: dict(counters or {}))
    run = harness.Run({}, "bf16", 8, feed)
    run.trace, run.slice_steps = t, 2
    return run


def test_span_seconds_and_innermost_segments():
    t = _trace()
    assert spans.span_seconds(t, "step.draws") == pytest.approx(2.0)
    assert spans.span_seconds(t, "step.g_update") == pytest.approx(1.0)
    assert spans.span_seconds(t, "step.nothing") is None
    # a child that outlasts its parent is cut at the parent's end
    assert spans.innermost([(0, 10, "a"), (2, 4, "b"), (3, 5, "c"),
                            (6, 7, "d")]) == [
        (0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"), (6, 7, "d"),
        (7, 10, "a")]


def test_idle_by_span_splits_each_gap_at_the_spans_edges():
    t = _trace()
    got = spans.idle_by_span(t)
    # idle 1.5-3, 4.25-6, 7.5-9, 9.5-12
    assert got == pytest.approx({
        P + "step.draws": 0.5 + 0.5, P + "step": 0.5 + 0.5,
        P + "step.grads": 0.5 + 1.0, P + "step.d_update": 0.25 + 0.5,
        P + "step.g_update": 0.25 + 0.25, P + "step.ema": 0.25 + 0.25,
        "portbench.dispatch": 1.0 + 0.5, "portbench.fetch": 0.5})
    assert sum(got.values()) == pytest.approx(t.window_s - t.busy_s())
    assert spans.idle_by_span(_trace(program=False)) is None


def test_syncs_in_dispatch_are_named_by_their_span():
    assert spans.syncs_in_dispatch(_trace()) == [
        P + "step.draws", P + "step.draws", P + "step.d_update"]
    assert spans.syncs_in_dispatch(_trace(program=False)) == [
        "portbench.dispatch"] * 3


def test_readers_of_the_spans(monkeypatch):
    run = _run(_trace(), monkeypatch)
    assert draw_ms.read(run) == pytest.approx(1e3 * 2.0 / 2)
    assert update_ms.read(run) == pytest.approx(1e3 * 2.0 / 2)
    bare = _run(_trace(program=False), monkeypatch)
    assert draw_ms.read(bare) is None and update_ms.read(bare) is None


@pytest.mark.parametrize("copies,expected", [(None, 1.5), (3, 1.5),
                                             (4, None)])
def test_host_syncs_per_step_and_its_cross_check(monkeypatch, copies,
                                                 expected):
    counters = None if copies is None else {"h2d_blocking": copies}
    got = host_syncs_per_step.read(_run(_trace(), monkeypatch, counters))
    assert got == (None if expected is None else pytest.approx(expected))


def test_input_produce_ms(monkeypatch):
    counters = {"input.batches": 4, "input.produce_s": 0.02}
    run = _run(_trace(), monkeypatch, counters, feed="pipeline")
    assert input_produce_ms.read(run) == pytest.approx(5.0)
    assert input_produce_ms.read(_run(_trace(), monkeypatch)) is None
