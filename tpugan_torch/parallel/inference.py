"""Batch-parallel inference: one endpoint over a mesh of ranks (port of
``tpugan/parallel/inference.py``).

Generation has no cross-request state (image i depends only on (seed, i)),
so scaling it is data parallelism: the generator replicated, the latents
split over the ranks.  ``ShardedSampler`` has the duck-typed surface of
``export.ExportedGenerator`` (``generate`` / ``sample`` / ``nz`` /
``conditional`` / ...), so ``serve.BatchingEngine`` serves a whole mesh as
one HTTP endpoint from the mesh's first rank.

``generate`` is collective: the first rank broadcasts the latents (and
labels), padded to a multiple of the mesh; every rank runs the eval-mode
generator on its slice (under ``train.kernels="pallas"`` the module path:
kernel 1, ``ops/cuda_convt.convt_affine_act``, once per GBlock); the
images are all-gathered and the first rank returns them.  The other ranks
call ``serve()``, which answers the first rank's ``generate`` calls until
it calls ``close()``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpugan_torch.configs import Config
from tpugan_torch.ops import convs
from tpugan_torch.parallel import collectives
from tpugan_torch.parallel.mesh import replicate

_STOP = -1


class ShardedSampler:
    def __init__(self, cfg: Config, g: torch.nn.Module, mesh):
        self.mesh = mesh
        self.group = mesh.get_group()
        self.n_shards = mesh.size()
        self.rank = mesh.get_local_rank()
        self.src = dist.get_global_rank(self.group, 0)
        self.conditional = cfg.model.arch == "cdcgan"
        self.nz = cfg.model.nz
        self.n_classes = cfg.model.n_classes
        self.image_size = cfg.model.image_size
        self.channels = cfg.model.channels
        self.fixed_batch = None  # duck-type parity with ExportedGenerator
        self.kernels = cfg.train.kernels
        self.g = replicate(g, mesh).eval()
        self.device = next(g.parameters()).device

    @property
    def is_source(self) -> bool:
        return self.rank == 0

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=self.src, group=self.group)
        return t

    @torch.no_grad()
    def _round(self, z=None, y=None) -> Optional[np.ndarray]:
        """One collective generation; returns the images on the first rank,
        None on the others, and the string "stop" once ``close`` ran."""
        head = torch.zeros(2, dtype=torch.int64, device=self.device)
        if self.is_source:
            head[0] = _STOP if z is None else z.shape[0]
            head[1] = int(y is not None)
        n, has_y = (int(v) for v in self._bcast(head).tolist())
        if n == _STOP:
            return "stop"
        m = -(-n // self.n_shards) * self.n_shards
        zt = torch.zeros((m, self.nz), dtype=torch.float32,
                         device=self.device)
        yt = torch.zeros((m,), dtype=torch.int64, device=self.device)
        if self.is_source:
            zt[:n] = torch.as_tensor(z, device=self.device)
            if has_y:
                yt[:n] = torch.as_tensor(np.asarray(y, np.int64),
                                         device=self.device)
        self._bcast(zt)
        if has_y:
            self._bcast(yt)
        per = m // self.n_shards
        sl = slice(self.rank * per, (self.rank + 1) * per)
        impl = "pallas" if self.kernels == "pallas" else "xla"
        with convs.using_impl(impl):
            img = (self.g(zt[sl], yt[sl]) if self.conditional
                   else self.g(zt[sl])).float().contiguous()
        parts = collectives.all_gather(img, self.group)
        if not self.is_source:
            return None
        return torch.cat(parts)[:n].cpu().numpy()

    def generate(self, z, y=None) -> np.ndarray:
        """Images (n, S, S, C) float32 from explicit latents, any batch
        size; called on the first rank while the others ``serve()``."""
        if not self.is_source:
            raise RuntimeError("generate is called on the mesh's first "
                               "rank; the others call serve()")
        z = np.asarray(z, np.float32)
        if self.conditional and y is None:
            raise ValueError("conditional model needs labels y")
        if not self.conditional and y is not None:
            raise ValueError("unconditional model: labels not accepted")
        return self._round(z, y)

    def serve(self) -> None:
        """On the other ranks: answer ``generate`` rounds until
        ``close``."""
        while self._round() != "stop":
            pass

    def close(self) -> None:
        """On the first rank: release the ranks in ``serve()``."""
        if self.is_source:
            self._round()

    def sample(self, n: int, seed: int = 0, labels=None) -> np.ndarray:
        # (imported here: the sampler imports this package)
        from tpugan_torch.sample.sampler import seeded_labels, seeded_noise

        z = seeded_noise(self.nz, n, seed)
        if self.conditional:
            y = (np.asarray(labels, np.int32) if labels is not None
                 else seeded_labels(self.n_classes, n, seed))
            return self.generate(z, y)
        return self.generate(z)
