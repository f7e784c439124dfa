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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpugan_torch.configs import Config
from tpugan_torch.ops import cuda_gen2
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

    @torch.no_grad()
    def generate(self, z, y=None) -> np.ndarray:
        """Images (n, S, S, C) float32 in [-1, 1] from explicit latents
        (and labels for a conditional model)."""
        z = torch.as_tensor(np.array(z, np.float32), device=self.device)
        if self.conditional:
            if y is None:
                raise ValueError("conditional model needs labels y")
            y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        elif y is not None:
            raise ValueError("unconditional model: labels not accepted")
        self.g.eval()
        if self.kernels == "pallas":
            img = cuda_gen2.generator_forward(self.g, z, y)
        else:
            img = (self.g(z, y) if self.conditional else self.g(z)).float()
        return img.cpu().numpy()

    def noise(self, n: int, seed: int, offset: int = 0) -> np.ndarray:
        return seeded_noise(self.nz, n, seed, offset)

    def labels(self, n: int, seed: int, offset: int = 0
               ) -> Optional[np.ndarray]:
        if not self.conditional:
            return None
        return seeded_labels(self.n_classes, n, seed, offset)

    def sample(self, n: int, seed: int = 0, labels=None,
               batch_size: int = 0) -> np.ndarray:
        """Generate n images in [-1, 1], float32 NHWC, deterministically.

        Under "pallas" the pixels do not depend on ``batch_size`` (the kernel
        computes each image alone); under "xla" PyTorch's convolutions may
        pick batch-dependent algorithms, which moves fp32 pixels by ulps.
        """
        bs = batch_size or n
        outs = []
        for start in range(0, n, bs):
            m = min(bs, n - start)
            y = None
            if self.conditional:
                y = (np.asarray(labels[start:start + m]) if labels is not None
                     else self.labels(m, seed, offset=start))
            outs.append(self.generate(self.noise(m, seed, offset=start), y))
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
