"""Checkpoint save / resume of the whole training state (port of
``tpugan/ckpt/checkpoint.py``, in the port's own format).

One checkpoint carries everything an exact resume needs: G's and D's
``state_dict`` (parameters, BatchNorm running statistics, spectral norm's
``u``), both optimizers' ``state_dict`` (moments and update counts, so a
linear LR schedule resumes at its count), the EMA of G, ADA's p and r_t,
the threefry key (as two ints) and the step (``TrainState.state_dict``).  Restoring it
continues training bit for bit, the noise stream and the data order
included.

A checkpoint is one ``torch.save`` file, ``<step>.pt`` in the directory,
written under a temporary name and moved into place with ``os.replace``:
a reader or a crash never sees a torn file, and saving a step that already
exists replaces it (``torch.save``'s semantics).  The newest
``max_to_keep`` steps are kept.  ``restore`` reads with
``weights_only=True`` onto ``map_location``, so a checkpoint saved on the
card restores into a CPU state and the reverse.  The run's config is saved
beside them as ``config.json``, also atomically.

Saves are synchronous (the JAX package's orbax saves overlap training);
``wait`` and ``close`` are kept for the same surface.

Under ``torch.distributed`` every rank calls ``save`` with the same state
(an FSDP state's ``state_dict()`` has already gathered its shards): the
first rank writes, then all meet at a barrier, so no rank reads or resumes
from a file still being written.  ``restore`` reads on every rank.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch
import torch.distributed as dist

_NAME = re.compile(r"^(\d+)\.pt$")


def atomic_write(path: str, write) -> None:
    """``write(tmp)`` to a temporary name beside ``path``, then move it into
    place: a reader or a crash never sees a torn file."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, config_json: str = "") -> None:
        """Write ``state`` (a ``TrainState.state_dict()``) as ``step``,
        then drop all but the newest ``max_to_keep`` steps (the first rank
        writes; every rank waits for it)."""
        if not dist.is_initialized() or dist.get_rank() == 0:
            atomic_write(self.path(step), lambda p: torch.save(state, p))
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
            if config_json:
                def write(p):
                    with open(p, "w") as f:
                        f.write(config_json)

                atomic_write(os.path.join(self.directory, "config.json"),
                             write)
        if dist.is_initialized():
            dist.barrier()

    def restore(self, step: Optional[int] = None, map_location=None) -> dict:
        """The saved state of ``step`` (default: the latest), its tensors
        on ``map_location``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        return load(self.path(step), map_location)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release: every save has completed."""


def load(path: str, map_location=None) -> dict:
    """One checkpoint file, read with ``weights_only=True``."""
    return torch.load(path, map_location=map_location, weights_only=True)
