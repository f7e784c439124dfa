"""Conditional DCGAN (port of ``tpugan/models/cdcgan.py``).

The label is embedded.  The generator concatenates the embedding with z
before the dense head; the discriminator projects it to one image-sized
plane and concatenates that with the image as an extra input channel.
"""

from __future__ import annotations

import torch
from torch import nn

from tpugan_torch.models.dcgan import Discriminator, Generator
from tpugan_torch.nn.layers import Dense, Embedding


class CondGenerator(nn.Module):
    """(z (N, nz), y (N,) int) -> image (N, S, S, C)."""

    def __init__(self, image_size: int, channels: int, nz: int, ngf: int,
                 n_classes: int, embed_dim: int = 50, *,
                 batchnorm: bool = True, dtype=torch.bfloat16, device="cuda",
                 generator=None):
        super().__init__()
        self.embed = Embedding(n_classes, embed_dim, dtype=dtype,
                               device=device, generator=generator)
        self.g = Generator(image_size, channels, nz, ngf, batchnorm=batchnorm,
                           dtype=dtype, head_in=nz + embed_dim, device=device,
                           generator=generator)
        self.nz = nz
        self.n_classes = n_classes
        self.image_size = image_size
        self.channels = channels

    def forward(self, z, y):
        e = self.embed(y)
        return self.g(torch.cat([z.to(e.dtype), e], dim=-1))


class CondDiscriminator(nn.Module):
    """(image (N, S, S, C), y (N,) int) -> logit (N,).

    Under the "pallas" impl the first eval-mode DBlock takes C + 1 input
    channels (4 for RGB): kernel 4's narrow path."""

    def __init__(self, image_size: int, channels: int, ndf: int,
                 n_classes: int, embed_dim: int = 50, *,
                 batchnorm: bool = True, spectral_norm: bool = False,
                 leak: float = 0.2, fuse_stats: str = "off",
                 dtype=torch.bfloat16, device="cuda", generator=None):
        super().__init__()
        self.image_size = image_size
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.embed = Embedding(n_classes, embed_dim, **kw)
        self.proj = Dense(embed_dim, image_size * image_size, **kw)
        self.d = Discriminator(image_size, channels, ndf, batchnorm=batchnorm,
                               spectral_norm=spectral_norm, leak=leak,
                               fuse_stats=fuse_stats,
                               in_channels=channels + 1, **kw)

    def forward(self, x, y):
        s = self.image_size
        plane = self.proj(self.embed(y)).reshape(-1, s, s, 1)
        return self.d(torch.cat([x.to(plane.dtype), plane], dim=-1))
