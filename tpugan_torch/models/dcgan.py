"""DCGAN generator and discriminator, sizes 28/32/64/128/256 (port of
``tpugan/models/dcgan.py``).

The generator: a Dense z -> s0 x s0 head with BN and ReLU, then
ConvTranspose(4, 2, 1) + BN + ReLU blocks, then ConvT + Tanh.  Channels halve
per doubling of the resolution; the 28 px family has a 7 x 7 base, the
others 4 x 4.  The discriminator mirrors it: Conv(4, 2, 1) + [BN] + LeakyReLU
blocks (no BN in the first), then a Dense tail on the flattened map.
Submodules are named as the JAX parameter tree (``head``, ``block{i}``,
``final``, ``tail``), so ``state_dict`` keys are the JAX keys joined by dots.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from tpugan_torch.models.blocks import DBlock, DTail, GBlock, GHead


def _g_schedule(image_size: int, ngf: int) -> Tuple[int, List[int]]:
    """Return (s0, [channels per resolution, coarsest -> finest])."""
    if image_size == 28:
        return 7, [ngf * 2, ngf]
    if image_size == 32:
        return 4, [ngf * 4, ngf * 2, ngf]
    if image_size == 64:
        return 4, [ngf * 8, ngf * 4, ngf * 2, ngf]
    if image_size == 128:
        return 4, [ngf * 16, ngf * 8, ngf * 4, ngf * 2, ngf]
    if image_size == 256:
        return 4, [ngf * 16, ngf * 16, ngf * 8, ngf * 4, ngf * 2, ngf]
    raise ValueError(f"unsupported image_size {image_size}")


class Generator(nn.Module):
    """z (N, nz) -> image (N, S, S, C) in [-1, 1], in the compute dtype."""

    def __init__(self, image_size: int, channels: int, nz: int, ngf: int,
                 *, batchnorm: bool = True, dtype=torch.bfloat16,
                 head_in: int | None = None, device="cuda", generator=None):
        super().__init__()
        self.image_size, self.channels, self.nz = image_size, channels, nz
        s0, chans = _g_schedule(image_size, ngf)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.head = GHead(head_in or nz, s0, chans[0], batchnorm=batchnorm,
                          **kw)
        self.n_blocks = len(chans) - 1
        for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
            self.add_module(f"block{i}",
                            GBlock(cin, cout, batchnorm=batchnorm, **kw))
        self.final = GBlock(chans[-1], channels, final=True, **kw)

    @property
    def blocks(self) -> List[GBlock]:
        return [getattr(self, f"block{i}") for i in range(self.n_blocks)]

    def forward(self, z):
        x = self.head(z)
        for blk in self.blocks:
            x = blk(x)
        return self.final(x)


def _d_schedule(image_size: int, ndf: int) -> Tuple[int, List[int]]:
    """Return (s0, [channels per block, finest -> coarsest])."""
    if image_size == 28:
        return 7, [ndf, ndf * 2]
    if image_size == 32:
        return 4, [ndf, ndf * 2, ndf * 4]
    if image_size == 64:
        return 4, [ndf, ndf * 2, ndf * 4, ndf * 8]
    if image_size == 128:
        return 4, [ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 16]
    if image_size == 256:
        return 4, [ndf, ndf * 2, ndf * 4, ndf * 8, ndf * 16, ndf * 16]
    raise ValueError(f"unsupported image_size {image_size}")


class Discriminator(nn.Module):
    """image (N, S, S, C) -> logit (N,), in the compute dtype."""

    def __init__(self, image_size: int, channels: int, ndf: int,
                 *, batchnorm: bool = True, spectral_norm: bool = False,
                 leak: float = 0.2, fuse_stats: str = "off",
                 dtype=torch.bfloat16, device="cuda", generator=None):
        super().__init__()
        self.image_size = image_size
        s0, chans = _d_schedule(image_size, ndf)
        kw = dict(spectral_norm=spectral_norm, leak=leak,
                  fuse_stats=fuse_stats, dtype=dtype, device=device,
                  generator=generator)
        cin = channels
        self.n_blocks = len(chans)
        for i, cout in enumerate(chans):
            # the first block has no BN (the DCGAN idiom)
            self.add_module(f"block{i}",
                            DBlock(cin, cout, batchnorm=batchnorm and i > 0,
                                   **kw))
            cin = cout
        self.tail = DTail(s0, chans[-1], dtype=dtype, device=device,
                          generator=generator)

    @property
    def blocks(self) -> List[DBlock]:
        return [getattr(self, f"block{i}") for i in range(self.n_blocks)]

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.tail(x)
