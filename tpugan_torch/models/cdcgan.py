"""Conditional DCGAN generator (port of the generator half of
``tpugan/models/cdcgan.py``): the label embedding is concatenated with z
before the dense head."""

from __future__ import annotations

import torch
from torch import nn

from tpugan_torch.models.dcgan import Generator
from tpugan_torch.nn.layers import Embedding


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
