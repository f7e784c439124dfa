"""The cells' dataset: CelebA's count and size of images (202,599 at
64x64x3 uint8, 2.49 GB), made from the seed on the device in a few large
draws and kept in host memory, where the program takes a dataset; and,
for a model that takes labels, one int32 label an image, from a stream of
the seed's own.

Each image is a smooth field (an 8x8 normal draw per channel, bilinearly
upsampled) with fine noise on it, so that the images are not constant
and not white noise.  The content moves no kernel's time: the kernels do
the same work on any pixels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CHUNK = 16384  # images a draw: two normal draws and one copy each
# CelebA's share of the attribute ``Male`` (84,434 of 202,599 images),
# the two classes' split
MALE_SHARE = 84_434 / 202_599
LABEL_STREAM = 0x6C61626C  # the labels' seed stream, apart from the rest


def data_seed(seed: int) -> int:
    """The dataset's generator seed, apart from the weights' stream."""
    return (2 * int(seed) + 1) % 2 ** 63


def make_images(n: int, size: int, channels: int, seed: int,
                device) -> np.ndarray:
    """(n, size, size, channels) uint8 images, NHWC, from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(data_seed(seed))
    host = torch.empty((n, size, size, channels), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    for start in range(0, n, CHUNK):
        m = min(CHUNK, n - start)
        low = torch.randn((m, channels, 8, 8), generator=gen, device=device)
        img = F.interpolate(low, size=(size, size), mode="bilinear",
                            align_corners=False) * 0.5
        img += 0.1 * torch.randn((m, channels, size, size), generator=gen,
                                 device=device)
        u8 = ((img.clamp_(-1.0, 1.0) + 1.0) * 127.5).round_().to(torch.uint8)
        host[start:start + m].copy_(u8.permute(0, 2, 3, 1))
    return host.numpy()


def make_labels(n: int, n_classes: int, seed: int) -> np.ndarray:
    """(n,) int32 labels from ``seed``: of two classes a Bernoulli at
    CelebA's share of ``Male`` (1 = male), of more uniform; on the host
    (numpy), so that every device makes the same labels."""
    entropy = [int(seed) % 2 ** 64, LABEL_STREAM]
    rng = np.random.default_rng(np.random.SeedSequence(entropy))
    if n_classes == 2:
        return (rng.random(n) < MALE_SHARE).astype(np.int32)
    return rng.integers(0, n_classes, n, dtype=np.int32)
