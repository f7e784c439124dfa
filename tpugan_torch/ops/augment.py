"""Differentiable GAN augmentation, DiffAugment and ADA (port of
``tpugan/ops/augment.py``).

Every image the discriminator sees, real and generated, in both updates,
goes through the policy's ops, which are differentiable in ``x``, so G's
gradient flows through them and G never learns to produce augmented
images (DiffAugment, arXiv:2006.10738; ADA, arXiv:2006.06676).

Layout and range: NHWC images in [-1, 1].  The ops, in DiffAugment's
semantics:

- ``color``        brightness (+U[-.5, .5)), saturation (x U[0, 2)),
                   contrast (x U[.5, 1.5)), in that order
- ``translation``  an integer shift in [-round(H/8), +round(H/8)] per axis
                   and sample, the exposed border zero (mid-gray)
- ``cutout``       zero an (H/2, W/2) window at a random position

The randomness is the JAX package's: each op draws from its key with the
numpy threefry of ``sample/threefry.py`` on the host (bit for bit JAX's
draws), and the draws, a few values a sample, are copied to ``x``'s
device.  The arithmetic runs in ``x``'s dtype (a bf16 fake stays bf16).

``apply_policy(x, key, policy, p)`` gates each op per sample with
probability ``p`` (ADA's execution model): a Python ``p >= 1`` skips the
gates (plain DiffAugment); a tensor ``p`` (ADA's, on the device) draws
them even at 1.0 and compares on the device, with no sync.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpugan_torch.sample import threefry

__all__ = [
    "POLICY_NAMES",
    "apply_policy",
    "parse_policy",
    "rand_brightness",
    "rand_contrast",
    "rand_cutout",
    "rand_saturation",
    "rand_translation",
]


def _to(x: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """A host draw on ``x``'s device (a pageable copy is staged at once, so
    the host does not wait for the device)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(x.device,
                                                        non_blocking=True)


def _batch_draw(x: torch.Tensor, rows, draw) -> np.ndarray:
    """``draw(n)`` for a batch of n samples.  Under a data mesh ``rows`` is
    (the global batch's size, this rank's rows of it): the draw is the
    global batch's, kept at those rows, as the JAX step draws it."""
    if rows is None:
        return draw(x.shape[0])
    n, idx = rows
    return draw(n)[idx]


def _per_sample(x: torch.Tensor, key, rows=None) -> np.ndarray:
    """U[0, 1) float32, one per sample: (N, 1, 1, 1)."""
    return _batch_draw(x, rows,
                       lambda n: threefry.uniform(key, (n, 1, 1, 1)))


def rand_brightness(x: torch.Tensor, key, rows=None) -> torch.Tensor:
    """x + U[-0.5, 0.5) per sample."""
    u = _per_sample(x, key, rows) - np.float32(0.5)
    return x + _to(x, u).to(x.dtype)


def rand_saturation(x: torch.Tensor, key, rows=None) -> torch.Tensor:
    """(x - mean_c) * U[0, 2) + mean_c: channel-mean-preserving."""
    u = _to(x, _per_sample(x, key, rows) * np.float32(2.0)).to(x.dtype)
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) * u + mean


def rand_contrast(x: torch.Tensor, key, rows=None) -> torch.Tensor:
    """(x - mean_hwc) * U[0.5, 1.5) + mean_hwc: image-mean-preserving."""
    u = _to(x, _per_sample(x, key, rows) + np.float32(0.5)).to(x.dtype)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * u + mean


def rand_translation(x: torch.Tensor, key, rows=None,
                     ratio: float = 0.125) -> torch.Tensor:
    """Shift each sample by integer offsets in [-round(H*ratio),
    +round(H*ratio)] (per axis, per sample), zero-filling the exposed
    border.

    The JAX package writes the shift as two one-hot matmuls at HIGHEST
    precision, each output the single product 1.0 * x; here it is the
    gather they equal: the image zero-padded by the largest shift, then
    indexed at (i + t_h, j + t_w).  Bitwise the same values in any dtype;
    the backward scatters the cotangent back (each padded pixel is read at
    most once)."""
    n, h, w, _ = x.shape
    sh, sw = int(h * ratio + 0.5), int(w * ratio + 0.5)
    kh, kw = threefry.split(key, 2)
    th = _to(x, _batch_draw(x, rows, lambda m: threefry.randint(
        kh, -sh, sh + 1, (m, 1, 1))).reshape(n, 1))
    tw = _to(x, _batch_draw(x, rows, lambda m: threefry.randint(
        kw, -sw, sw + 1, (m, 1, 1))).reshape(n, 1))
    dev = x.device
    rows = torch.arange(h, device=dev)[None, :] + th.long() + sh  # (N, H)
    cols = torch.arange(w, device=dev)[None, :] + tw.long() + sw  # (N, W)
    xp = F.pad(x, (0, 0, sw, sw, sh, sh))
    batch = torch.arange(n, device=dev)[:, None, None]
    return xp[batch, rows[:, :, None], cols[:, None, :]]


def rand_cutout(x: torch.Tensor, key, rows=None,
                ratio: float = 0.5) -> torch.Tensor:
    """Zero an (H*ratio, W*ratio) window centered at a uniform position,
    clipped at the borders (the DiffAugment reference's clamped scatter),
    as a mask multiply."""
    n, h, w, _ = x.shape
    ch, cw = int(h * ratio + 0.5), int(w * ratio + 0.5)
    kh, kw = threefry.split(key, 2)
    oy = _batch_draw(x, rows, lambda m: threefry.randint(
        kh, 0, h + (1 - ch % 2), (m, 1, 1)))
    ox = _batch_draw(x, rows, lambda m: threefry.randint(
        kw, 0, w + (1 - cw % 2), (m, 1, 1)))
    y0 = _to(x, oy - ch // 2)
    x0 = _to(x, ox - cw // 2)
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    inside = (yy >= y0) & (yy < y0 + ch) & (xx >= x0) & (xx < x0 + cw)
    return x * (1 - inside.to(x.dtype))[..., None]


# A policy name maps to the ordered ops it runs (DiffAugment groups the
# three color ops under one name; each still draws its own randomness and,
# under ADA, its own per-sample gate).
_POLICY_OPS = {
    "color": (rand_brightness, rand_saturation, rand_contrast),
    "translation": (rand_translation,),
    "cutout": (rand_cutout,),
}
POLICY_NAMES = tuple(_POLICY_OPS)


def parse_policy(spec: str) -> tuple[str, ...]:
    """'color,translation,cutout' -> validated tuple of policy names."""
    names = tuple(s.strip() for s in spec.split(",") if s.strip())
    for name in names:
        if name not in _POLICY_OPS:
            raise ValueError(
                f"unknown augment op {name!r}; available: "
                f"{', '.join(POLICY_NAMES)}")
    return names


def apply_policy(x: torch.Tensor, key, policy: Sequence[str],
                 p=1.0, rows=None) -> torch.Tensor:
    """Run the policy's ops on a batch, each gated per sample at
    probability ``p``: a Python float, or a float32 tensor (ADA's ``p``).
    Each op takes ``key, k_op, k_gate = split(key, 3)`` in the policy's
    order; a Python ``p >= 1`` skips the gates.  ``rows`` (global size,
    this rank's rows) draws for the global batch under a data mesh."""
    always_on = isinstance(p, (int, float)) and p >= 1.0
    for name in policy:
        for op in _POLICY_OPS[name]:
            key, k_op, k_gate = threefry.split(key, 3)
            ax = op(x, k_op, rows)
            if always_on:
                x = ax
                continue
            if torch.is_tensor(p):  # compared on p's device
                gate = _to(x, _batch_draw(x, rows, lambda n, k=k_gate:
                                          threefry.uniform(k, (n, 1, 1, 1))
                                          )) < p
            else:
                gate = _to(x, _batch_draw(x, rows, lambda n, k=k_gate:
                                          threefry.bernoulli(k, p,
                                                             (n, 1, 1, 1))))
            x = torch.where(gate, ax, x)
    return x
