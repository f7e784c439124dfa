"""Model construction from config (port of ``tpugan/models/registry.py``).

The conditional discriminator is not ported yet (ROADMAP.md, Queue A:
"Discriminator models"): ``build_discriminator`` raises for ``cdcgan``.
"""

from __future__ import annotations

import torch

from tpugan_torch.configs import ModelConfig
from tpugan_torch.models.cdcgan import CondGenerator
from tpugan_torch.models.dcgan import Discriminator, Generator


def compute_dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bf16" else torch.float32


def resolve_embed_dim(cfg: ModelConfig) -> int:
    """embed_dim=0 means 'use the default' (50), as in the JAX package."""
    return cfg.embed_dim or 50


def build_generator(cfg: ModelConfig, precision: str = "bf16", *,
                    device="cuda", generator: torch.Generator | None = None):
    """The generator for a ModelConfig, weights drawn from ``generator``."""
    kw = dict(batchnorm=cfg.g_batchnorm, dtype=compute_dtype(precision),
              device=device, generator=generator)
    if cfg.arch == "dcgan":
        return Generator(cfg.image_size, cfg.channels, cfg.nz, cfg.ngf, **kw)
    if cfg.arch == "cdcgan":
        if cfg.n_classes <= 0:
            raise ValueError("cdcgan requires model.n_classes > 0")
        return CondGenerator(cfg.image_size, cfg.channels, cfg.nz, cfg.ngf,
                             cfg.n_classes, resolve_embed_dim(cfg), **kw)
    raise ValueError(f"unknown arch {cfg.arch!r}")


def build_discriminator(cfg: ModelConfig, precision: str = "bf16", *,
                        fuse_stats: str = "off", device="cuda",
                        generator: torch.Generator | None = None):
    """The discriminator for a ModelConfig, weights drawn from
    ``generator``; ``fuse_stats`` (a ``train.fuse_stats`` mode) goes to each
    DBlock."""
    if cfg.arch == "dcgan":
        return Discriminator(cfg.image_size, cfg.channels, cfg.ndf,
                             batchnorm=cfg.d_batchnorm,
                             spectral_norm=cfg.d_spectral_norm, leak=cfg.leak,
                             fuse_stats=fuse_stats,
                             dtype=compute_dtype(precision), device=device,
                             generator=generator)
    if cfg.arch == "cdcgan":
        raise NotImplementedError(
            "the conditional discriminator is not ported yet (ROADMAP.md, "
            "Queue A: 'Discriminator models', CondDiscriminator)")
    raise ValueError(f"unknown arch {cfg.arch!r}")


def build_models(cfg: ModelConfig, precision: str = "bf16", *,
                 fuse_stats: str = "off", device="cuda",
                 generator: torch.Generator | None = None):
    """(generator, discriminator) for a ModelConfig, G's weights drawn from
    ``generator`` first, then D's; ``fuse_stats`` as in
    ``build_discriminator``."""
    kw = dict(device=device, generator=generator)
    return (build_generator(cfg, precision, **kw),
            build_discriminator(cfg, precision, fuse_stats=fuse_stats, **kw))
