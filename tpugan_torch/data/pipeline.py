"""Host -> device input pipeline (port of ``tpugan/data/pipeline.py``).

- Batches travel as uint8 (4x fewer bytes than float32); the train step
  normalizes them to [-1, 1] on the device.
- A producer thread gathers the next batches with numpy and copies them
  from pinned host memory to the device while the device runs the current
  step.
- The order is the JAX package's: epoch e is the permutation of
  ``default_rng(SeedSequence([seed, e]))``, so both packages see the same
  batches, and ``start_step`` resumes the stream where a run left off.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from tpugan_torch.utils.device import resolve_device

PREFETCH = 2  # batches the producer keeps ready


class make_input_pipeline:
    """Iterator of {'image': uint8 NHWC, 'label': int32} tensors on
    ``device``."""

    def __init__(self, data: Dict[str, np.ndarray], batch_size: int, *,
                 seed: int = 0, with_labels: bool = True, device="cuda",
                 start_step: int = 0):
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

    def _host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch, s0 = divmod(self.start_step, self.steps_per_epoch)
        n = len(self.images)
        while True:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).permutation(n)
            for s in range(s0, self.steps_per_epoch):
                idx = order[s * self.batch_size:(s + 1) * self.batch_size]
                batch = {"image": self.images[idx]}
                if self.labels is not None:
                    batch["label"] = self.labels[idx]
                yield batch
            epoch += 1
            s0 = 0

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
                for batch in self._host_batches():
                    if stop.is_set():
                        return
                    put({k: self._to_device(v) for k, v in batch.items()})
            except BaseException as e:  # propagate, don't hang the consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise RuntimeError(
                        "input pipeline producer failed") from item
                yield item
        finally:
            stop.set()
