"""Host -> device input pipeline (port of ``tpugan/data/pipeline.py``).

- Batches travel as uint8 (4x fewer bytes than float32); the train step
  normalizes them to [-1, 1] on the device.
- A producer thread assembles the next batches and copies them from
  pinned host memory to the device while the device runs the current
  step: an in-RAM dataset through the C++ gather (``data/native.py``), a
  streaming folder (``StreamingImageFolder``) by decoding the batch's
  files in its thread pool.
- The order is the JAX package's: epoch e is the permutation of
  ``default_rng(SeedSequence([seed, e]))``, so both packages see the same
  batches, and ``start_step`` resumes the stream where a run left off.
- ``stack`` K > 1 yields K batches stacked on a leading axis, for a train
  step that runs K steps a call (``train.steps_per_call``).
- ``rows`` (under a data mesh, ``parallel/multihost.local_rows``): every
  rank draws the global batch's indices and gathers and decodes only its
  own rows of them.
- Tracing (``utils/tracing.py``): the producer times each batch (gather
  or decode, stack, pin, the copy's enqueue) and hands the seconds over
  beside it; each take is the span ``input.take`` and adds to the counters
  ``input.batches``, ``input.produce_s`` and, where the queue was empty,
  ``input.starved``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator

import numpy as np
import torch

from tpugan_torch.data import native
from tpugan_torch.utils import tracing
from tpugan_torch.utils.device import resolve_device

PREFETCH = 2  # batches the producer keeps ready


class make_input_pipeline:
    """Iterator of {'image': uint8 NHWC, 'label': int32} tensors on
    ``device`` (with a leading axis of ``stack`` batches when > 1)."""

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int, *,
                 seed: int = 0, with_labels: bool = True, device="cuda",
                 start_step: int = 0, stack: int = 1, rows=None):
        self.images = data["images"]
        self.labels = data.get("labels") if with_labels else None
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)
        n = len(self.images)
        if n < batch_size:
            raise ValueError(f"dataset size {n} < batch size {batch_size}")
        self.steps_per_epoch = n // batch_size  # the last partial batch drops
        self.start_step = int(start_step)
        self.stack = max(stack, 1)
        self.rows = rows

    def _host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch, s0 = divmod(self.start_step, self.steps_per_epoch)
        n = len(self.images)
        while True:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).permutation(n)
            for s in range(s0, self.steps_per_epoch):
                idx = order[s * self.batch_size:(s + 1) * self.batch_size]
                if self.rows is not None:
                    idx = idx[self.rows]
                if hasattr(self.images, "gather"):  # streaming folder
                    batch = {"image": self.images.gather(idx)}
                else:
                    batch = {"image": native.batch_gather(self.images, idx)}
                if self.labels is not None:
                    batch["label"] = self.labels[idx]
                yield batch
            epoch += 1
            s0 = 0

    def _stacked_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        it = self._host_batches()
        if self.stack == 1:
            yield from it
            return
        while True:
            group = [next(it) for _ in range(self.stack)]
            yield {k: np.stack([b[k] for b in group]) for k in group[0]}

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                t = time.perf_counter()
                for batch in self._stacked_batches():
                    if stop.is_set():
                        return
                    batch = {k: self._to_device(v) for k, v in batch.items()}
                    put((batch, time.perf_counter() - t))
                    t = time.perf_counter()
            except BaseException as e:  # propagate, don't hang the consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                with tracing.span("input.take"):
                    try:
                        item, starved = q.get_nowait(), 0
                    except queue.Empty:
                        item, starved = q.get(), 1
                if isinstance(item, BaseException):
                    raise RuntimeError(
                        "input pipeline producer failed") from item
                batch, produce_s = item
                tracing.count("input.batches")
                tracing.count("input.produce_s", produce_s)
                tracing.count("input.starved", starved)
                yield batch
        finally:
            stop.set()
