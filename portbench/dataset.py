"""The cells' dataset: CelebA's count and size of images (202,599 at
64x64x3 uint8, 2.49 GB), made from the seed on the device in a few large
draws and kept in host memory, where the program takes a dataset.

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
