"""Adversarial objectives over raw discriminator logits (port of
``tpugan/losses/adversarial.py``).

D's output stays a raw logit and BCE takes the softplus form:

    BCE(sigmoid(l), 1) = softplus(-l)        BCE(sigmoid(l), 0) = softplus(l)

All reductions are means over the batch, in fp32.

Kinds: ``bce`` (non-saturating DCGAN), ``lsgan`` (least squares, the 1/2
factors), ``wgan`` (critic difference; the trainer clips the weights),
``wgan_gp`` (the same critic loss; the penalty term is not ported yet) and
``hinge``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

def _bce_with_target(logits, target: float):
    """BCE-with-logits against a soft target t:
    t * softplus(-l) + (1 - t) * softplus(l)."""
    if target == 1.0:
        return F.softplus(-logits).mean()
    if target == 0.0:
        return F.softplus(logits).mean()
    return (target * F.softplus(-logits)
            + (1.0 - target) * F.softplus(logits)).mean()


def d_loss_real_fn(kind: str, real_logits, *, real_label: float = 1.0):
    """The real-batch term of the D/critic loss."""
    r = real_logits.float()
    if kind == "bce":
        return _bce_with_target(r, real_label)
    if kind == "lsgan":
        return 0.5 * torch.square(r - real_label).mean()
    if kind in ("wgan", "wgan_gp"):
        return -r.mean()
    if kind == "hinge":
        return torch.relu(1.0 - r).mean()
    raise ValueError(f"unknown loss kind {kind!r}")


def d_loss_fake_fn(kind: str, fake_logits, *, fake_label: float = 0.0):
    """The fake-batch term of the D/critic loss."""
    f = fake_logits.float()
    if kind == "bce":
        return _bce_with_target(f, fake_label)
    if kind == "lsgan":
        return 0.5 * torch.square(f - fake_label).mean()
    if kind in ("wgan", "wgan_gp"):
        return f.mean()
    if kind == "hinge":
        return torch.relu(1.0 + f).mean()
    raise ValueError(f"unknown loss kind {kind!r}")


def d_loss_fn(kind: str, real_logits, fake_logits, *,
              real_label: float = 1.0, fake_label: float = 0.0):
    """Discriminator/critic loss (to minimize)."""
    return (d_loss_real_fn(kind, real_logits, real_label=real_label)
            + d_loss_fake_fn(kind, fake_logits, fake_label=fake_label))


def g_loss_fn(kind: str, fake_logits, *, real_label: float = 1.0):
    """Generator loss (to minimize)."""
    f = fake_logits.float()
    if kind == "bce":
        return _bce_with_target(f, real_label)  # non-saturating
    if kind == "lsgan":
        return 0.5 * torch.square(f - real_label).mean()
    if kind in ("wgan", "wgan_gp", "hinge"):
        return -f.mean()
    raise ValueError(f"unknown loss kind {kind!r}")
