"""The public sampler API: seeded, batched generation + sample grids (port
of ``tpugan/sample/sampler.py``).

Determinism contract, shared with the JAX package: image i is a pure
function of (weights, seed, i), invariant to batching.  Its noise and labels
are the JAX package's threefry draws (``seeded_noise`` / ``seeded_labels``),
computed in numpy (``sample/threefry.py``), so the two packages feed a
generator the same latents for the same seed.

Generation runs in eval mode (BatchNorm running stats).  With
``train.kernels == "pallas"`` it is one launch of the phase-separated
megakernel (``ops/cuda_gen2.py``); with "xla" it is the module's own forward
on PyTorch ops.  There is no fallback from one to the other.

``sample(..., unroll=u)`` runs u consecutive batches a call.  Under "xla" on
the card that call is one replay of a CUDA graph of the u forwards (the
port of the JAX package's unrolled jitted program: it divides the host's
launch work by u), captured once per (batch size, u) after an eager warm-up
so that cuDNN picks the algorithms it picks eagerly; on the CPU it is the
plain loop.  The pixels are those of ``unroll=1``.  A graph replays the
addresses of the weights it captured: the Sampler keeps its graphs while
the generator's parameters and buffers stay in the same storage (an
in-place ``load_state_dict`` keeps it), drops them all when any moves
(``g.to``, ``load_state_dict(..., assign=True)``, a reassigned
parameter), and ``clear_graphs()`` frees their memory pools.

Under ``train.spatial_shards`` > 0 (a model whose maps are sharded to
fit), generation runs the module's eval forward inside the spatial
context (``parallel/spatial.py``), ahead of the megakernels: on the
Trainer's mesh when its context is set, else on a ``("space",)`` mesh of
the first ``spatial_shards`` ranks, which every rank builds and then
generates with (a collective; too few ranks raise).  The image comes back
whole on every rank.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpugan_torch.configs import Config
from tpugan_torch.ops import cuda_gen2
from tpugan_torch.parallel import multihost, spatial
from tpugan_torch.sample import threefry
from tpugan_torch.utils.images import make_grid, save_png, to_uint8


def seeded_noise(nz: int, n: int, seed: int, offset: int = 0) -> np.ndarray:
    """(n, nz) float32 latents; row i is ``normal(fold_in(PRNGKey(seed),
    offset + i), (nz,))``."""
    keys = threefry.fold_in(threefry.prng_key(seed),
                            np.arange(offset, offset + n))
    return threefry.normal(keys, (nz,))


def seeded_labels(n_classes: int, n: int, seed: int,
                  offset: int = 0) -> np.ndarray:
    """(n,) int32 labels; label i is ``randint(fold_in(root, offset + i), 0,
    n_classes)`` with root = ``fold_in(PRNGKey(seed), 0x1ABE1)``."""
    root = threefry.fold_in(threefry.prng_key(seed), 0x1ABE1)
    keys = threefry.fold_in(root, np.arange(offset, offset + n))
    return threefry.randint(keys, 0, n_classes)


def _spatial_mesh(cfg: Config, device: torch.device):
    """(mesh, axis, dim) a spatial config generates on, or None."""
    n = cfg.train.spatial_shards
    if n <= 0:
        return None
    mesh, axis, dim = spatial.current()
    if mesh is not None:  # the Trainer's
        return mesh, axis, dim
    if multihost.world_size() < n:
        raise ValueError(
            f"train.spatial_shards={n} but only {multihost.world_size()} "
            f"rank(s) are running: a silently smaller mesh would change the "
            f"sharding (and can run out of memory on a model that needs "
            f"the full split)")
    if n == 1 and multihost.world_size() == 1:
        return None  # one shard is the dense forward
    from tpugan_torch.parallel.mesh import build_mesh

    return build_mesh((n,), ("space",), device.type), "space", 1


class Sampler:
    """Seeded generation from a live generator module.

    Also the single-device engine the HTTP server takes (``nz``,
    ``n_classes``, ``image_size``, ``channels``, ``conditional``,
    ``generate``), the counterpart of the JAX package's ``ShardedSampler``.
    """

    def __init__(self, cfg: Config, g: torch.nn.Module):
        self.cfg = cfg
        self.kernels = cfg.train.kernels
        if self.kernels not in ("xla", "pallas"):
            raise ValueError(f"unknown kernels {self.kernels!r}")
        self.conditional = cfg.model.arch == "cdcgan"
        self.nz = cfg.model.nz
        self.n_classes = cfg.model.n_classes
        self.image_size = cfg.model.image_size
        self.channels = cfg.model.channels
        self.g = g
        self.device = next(g.parameters()).device
        self._spatial = _spatial_mesh(cfg, self.device)
        # (batch size, unroll) -> the captured unrolled forward ("xla", card),
        # valid for the weight storage in _graphs_weights
        self._graphs: Dict[Tuple[int, int], _UnrolledGraph] = {}
        self._graphs_weights: Tuple[int, ...] = ()

    def clear_graphs(self) -> None:
        """Drop the captured ``unroll`` graphs and their memory pools."""
        self._graphs.clear()
        self._graphs_weights = ()

    def _inputs(self, z, y):
        """(z, y) as tensors on the generator's device; checks the labels
        against the model."""
        z = torch.as_tensor(np.array(z, np.float32), device=self.device)
        if self.conditional:
            if y is None:
                raise ValueError("conditional model needs labels y")
            y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        elif y is not None:
            raise ValueError("unconditional model: labels not accepted")
        return z, y

    def _forward(self, z, y):
        """The eval-mode image, float32, on the device."""
        if self._spatial is not None:
            mesh, axis, dim = self._spatial
            with spatial.spatial_ctx(mesh, axis=axis, dim=dim):
                return (self.g(z, y) if self.conditional
                        else self.g(z)).float()
        if self.kernels == "pallas":
            return cuda_gen2.generator_forward(self.g, z, y)
        return (self.g(z, y) if self.conditional else self.g(z)).float()

    @torch.no_grad()
    def generate(self, z, y=None) -> np.ndarray:
        """Images (n, S, S, C) float32 in [-1, 1] from explicit latents
        (and labels for a conditional model)."""
        z, y = self._inputs(z, y)
        self.g.eval()
        return self._forward(z, y).cpu().numpy()

    @torch.no_grad()
    def _generate_unrolled(self, z, y, bs: int, u: int) -> np.ndarray:
        """u consecutive batches of ``bs`` (z holds u * bs latents): one
        CUDA graph replay on the card, the plain loop on the CPU."""
        if self.device.type != "cuda":
            return np.concatenate([
                self.generate(z[i * bs:(i + 1) * bs],
                              None if y is None else y[i * bs:(i + 1) * bs])
                for i in range(u)], axis=0)
        z, y = self._inputs(z, y)
        self.g.eval()
        weights = tuple(t.data_ptr() for t in itertools.chain(
            self.g.parameters(), self.g.buffers()))
        if weights != self._graphs_weights:
            self.clear_graphs()
            self._graphs_weights = weights
        graph = self._graphs.get((bs, u))
        if graph is None:
            graph = self._graphs[(bs, u)] = _UnrolledGraph(self, bs, u)
        return graph.run(z, y)

    def noise(self, n: int, seed: int, offset: int = 0) -> np.ndarray:
        return seeded_noise(self.nz, n, seed, offset)

    def labels(self, n: int, seed: int, offset: int = 0
               ) -> Optional[np.ndarray]:
        if not self.conditional:
            return None
        return seeded_labels(self.n_classes, n, seed, offset)

    def sample(self, n: int, seed: int = 0, labels=None,
               batch_size: int = 0, unroll: int = 1) -> np.ndarray:
        """Generate n images in [-1, 1], float32 NHWC, deterministically.

        Under "pallas" the pixels do not depend on ``batch_size`` (the kernel
        computes each image alone); under "xla" PyTorch's convolutions may
        pick batch-dependent algorithms, which moves fp32 pixels by ulps.

        ``unroll > 1`` generates that many consecutive batches a call (see
        the module docstring); what does not fill u batches runs batch by
        batch.  The pixels equal ``unroll=1``'s bit for bit.  Under "pallas"
        each batch is one launch already: it warns and generates
        sequentially, as the JAX package does.
        """
        bs = batch_size or n
        # a graph replay holds no collective: spatial generates batch by
        # batch
        u = 1 if self._spatial is not None else max(1, int(unroll))
        if u > 1 and self.kernels == "pallas":
            warnings.warn("sample(unroll>1) applies to the xla sample path "
                          "only; generating sequentially")
            u = 1
        outs = []
        start = 0
        while start < n:
            m = bs * u if n - start >= bs * u else min(bs, n - start)
            y = None
            if self.conditional:
                y = (np.asarray(labels[start:start + m]) if labels is not None
                     else self.labels(m, seed, offset=start))
            z = self.noise(m, seed, offset=start)
            outs.append(self._generate_unrolled(z, y, bs, u) if m > bs
                        else self.generate(z, y))
            start += m
        return np.concatenate(outs, axis=0)

    def sample_fixed(self, z, labels=None) -> np.ndarray:
        """Generate from caller-provided noise (the fixed-noise grid path)."""
        return self.generate(z, labels if self.conditional else None)

    def save_grid(self, path: str, n: int = 64, seed: int = 0,
                  nrow: int = 8) -> np.ndarray:
        grid = make_grid(to_uint8(self.sample(n, seed)), nrow=nrow)
        save_png(path, grid)
        return grid

    def interpolate(self, seed_a: int, seed_b: int, steps: int = 8,
                    label=None, spherical: bool = False) -> np.ndarray:
        """Latent interpolation between the first noise vectors of two
        seeds; ``spherical=True`` uses slerp."""
        za = self.noise(1, seed_a)[0]
        zb = self.noise(1, seed_b)[0]
        t = np.linspace(0.0, 1.0, steps, dtype=np.float32)[:, None]
        if spherical:
            na = za / np.linalg.norm(za)
            nb = zb / np.linalg.norm(zb)
            omega = np.arccos(np.clip(np.dot(na, nb), -1 + 1e-7, 1 - 1e-7))
            so = np.sin(omega)
            z = (np.sin((1 - t) * omega) / so * za[None]
                 + np.sin(t * omega) / so * zb[None])
        else:
            z = za[None] * (1 - t) + zb[None] * t
        y = (np.full((steps,), int(label or 0), np.int32)
             if self.conditional else None)
        return self.generate(z.astype(np.float32), y)

    def sample_truncated(self, n: int, seed: int = 0, threshold: float = 1.0,
                         labels=None) -> np.ndarray:
        """Truncation-trick sampling: latents from a normal truncated to
        |z_i| <= threshold."""
        key = threefry.fold_in(threefry.prng_key(seed), 0x72C)
        z = threefry.truncated_normal(key, -threshold, threshold, (n, self.nz))
        y = None
        if self.conditional:
            y = (np.asarray(labels) if labels is not None
                 else self.labels(n, seed))
        return self.generate(z, y)


class _UnrolledGraph:
    """u eval forwards of one batch each, captured as one CUDA graph over
    static input buffers (one per batch, each its own allocation, as an
    eager call's input is)."""

    def __init__(self, sampler: Sampler, bs: int, u: int):
        dev = sampler.device
        self.bs = bs
        self.z = [torch.zeros((bs, sampler.nz), dtype=torch.float32,
                              device=dev) for _ in range(u)]
        self.y = ([torch.zeros((bs,), dtype=torch.int64, device=dev)
                   for _ in range(u)] if sampler.conditional else None)

        def forward():
            return torch.cat([sampler._forward(
                z, None if self.y is None else self.y[i])
                for i, z in enumerate(self.z)])

        # warm up eagerly (cuDNN chooses its algorithms on first use; the
        # capture must find them chosen), on a side stream as capture runs
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            forward()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = forward()

    def run(self, z: torch.Tensor, y: Optional[torch.Tensor]) -> np.ndarray:
        bs = self.bs
        for i, buf in enumerate(self.z):
            buf.copy_(z[i * bs:(i + 1) * bs])
            if y is not None:
                self.y[i].copy_(y[i * bs:(i + 1) * bs])
        self.graph.replay()
        return self.out.cpu().numpy()
