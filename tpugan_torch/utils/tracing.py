"""The port's spans and counters, on exactly while a ``torch.profiler``
records on the calling thread (the Trainer's ``profile_steps`` window, a
benchmark's traced slice); off, each costs one flag check.

- ``span(name)``: ``torch.profiler.record_function("tpugan_torch." +
  name)``, which the profiler stamps on its own timeline beside the
  device's operations; off, one shared null context.
- ``count(name, n=1)``: adds ``n`` to a process-wide counter; ``counters()``
  returns a copy of them, ``reset()`` clears them.
- ``h2d(a, device)``: ``torch.as_tensor(a, device=device)``, the blocking
  copy of a host array from pageable memory on the current stream; where
  ``device`` is a card, the span ``h2d`` (the host waits there for every
  operation queued before the copy) and the counters ``h2d_blocking`` and
  ``h2d_blocking_bytes``.  The train step copies this way only what the
  host draws: the parity hooks, ``"epoch"`` sampling's indices and the
  penalty's weights.
- The step's hflip bits, latents, fake labels and resident indices are
  drawn on the card (``ops/cuda_threefry.py``), one launch each, no copy:
  the counters ``device_draws`` and ``device_draws_bytes`` (the tensors
  written).

The profiler records nothing on a thread it was not started from, so work
done on another thread is timed there and counted where its result is
taken (``data/pipeline.py``).
"""

from __future__ import annotations

import contextlib
import threading

import torch

PREFIX = "tpugan_torch."

_NULL = contextlib.nullcontext()
_counts: dict = {}
_lock = threading.Lock()


def span(name: str):
    """A context naming the block ``tpugan_torch.<name>`` in the profiler's
    trace while one records on this thread."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _NULL


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records on this
    thread."""
    if torch.autograd._profiler_enabled():
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()


def h2d(a, device) -> torch.Tensor:
    """``torch.as_tensor(a, device=device)``; where it copies a host array
    to a card, the span ``h2d`` and the counters (module doc)."""
    if (not torch.autograd._profiler_enabled()
            or torch.device(device).type == "cpu"
            or (isinstance(a, torch.Tensor) and a.device.type != "cpu")):
        return torch.as_tensor(a, device=device)
    with span("h2d"):
        t = torch.as_tensor(a, device=device)
    count("h2d_blocking")
    count("h2d_blocking_bytes", t.numel() * t.element_size())
    return t
