"""Dataset loading (port of ``tpugan/data/datasets.py``): the deterministic
``synthetic`` dataset.

A loader returns ``dict(images=uint8 NHWC array, labels=int32 array)``;
per-batch normalization to [-1, 1] and augmentation happen in the train
step.  The file readers for MNIST, CIFAR-10 and CelebA are not ported yet
(ROADMAP.md, Queue A: "Data"): ``load_dataset`` raises for them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

DATASETS = ("mnist", "cifar10", "celeba", "synthetic")


def load_dataset(name: str, *, image_size: int, channels: int,
                 synthetic_size: int = 10_000, seed: int = 0,
                 n_classes: int = 0) -> Dict[str, np.ndarray]:
    if name == "synthetic":
        return make_synthetic(image_size, channels, synthetic_size,
                              seed=seed, n_classes=n_classes)
    if name in DATASETS:
        raise NotImplementedError(
            f"the {name!r} reader is not ported yet (ROADMAP.md, Queue A: "
            f"'Data'); use data.dataset='synthetic'")
    raise ValueError(f"unknown dataset {name!r}; available: {DATASETS}")


def make_synthetic(image_size: int, channels: int, n: int, *, seed: int = 0,
                   n_classes: int = 0) -> Dict[str, np.ndarray]:
    """Procedural images: per-class colored gaussian blobs on gradients,
    deterministic in the arguments (the JAX package's own generator, so
    both packages train on the same pixels)."""
    rng = np.random.default_rng(seed)
    k = max(n_classes, 1)
    labels = rng.integers(0, k, size=n).astype(np.int32)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    yy, xx = yy / image_size, xx / image_size
    imgs = np.empty((n, image_size, image_size, channels), np.uint8)
    centers = rng.uniform(0.25, 0.75, size=(n, 2)).astype(np.float32)
    widths = rng.uniform(0.05, 0.2, size=n).astype(np.float32)
    for i in range(n):
        cy, cx = centers[i]
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                      / (2 * widths[i] ** 2))
        base = 0.3 * xx + 0.2 * yy + 0.25
        phase = 2 * np.pi * labels[i] / k
        img = np.empty((image_size, image_size, channels), np.float32)
        for c in range(channels):
            gain = 0.5 + 0.5 * np.cos(phase + 2 * np.pi * c / max(channels, 1))
            img[..., c] = base + gain * blob
        imgs[i] = np.clip(img * 255, 0, 255).astype(np.uint8)
    return {"images": imgs, "labels": labels}
