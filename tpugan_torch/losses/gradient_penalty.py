"""WGAN-GP gradient penalty (port of ``tpugan/losses/gradient_penalty.py``).

Interpolate real and fake batches per sample, take D's gradient at the
interpolates with ``create_graph=True``, and penalize its per-sample L2
norm's distance from 1: differentiating the D loss then runs a double
backward through every layer of D.  The norm is fp32 with an eps inside the
square root; D may run in bf16, its scores and the penalty stay fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from tpugan_torch.sample import threefry
from tpugan_torch.utils import tracing


def gradient_penalty(d_score_fn, real, fake, key=None, *,
                     center: float = 1.0, eps: float = 1e-12, alpha=None,
                     rows=None):
    """E[(|grad_x D(x_hat)|_2 - center)^2] over per-sample interpolates
    x_hat = alpha * real + (1 - alpha) * fake, in fp32.

    ``d_score_fn`` maps x (N, H, W, C) to scores (N,); ``real``/``fake`` are
    values (nothing flows back into them); ``key`` is the threefry key of
    alpha ~ U[0, 1) of shape (N, 1, 1, 1), the JAX draw; ``alpha`` (N values)
    replaces that draw (the JAX step's parity hook).  Under a data mesh
    ``rows`` is (the global batch's size, this rank's rows): alpha is drawn
    (or given) for the global batch and kept at those rows, and the mean
    is this rank's.  Returns the penalty without the lambda factor.
    """
    n = real.shape[0]
    with tracing.span("step.draws"):
        if alpha is None:
            alpha = threefry.uniform(key, ((rows[0] if rows else n), 1, 1, 1))
        if rows is not None:
            alpha = np.asarray(alpha).reshape(rows[0], 1, 1, 1)[rows[1]]
        alpha = tracing.h2d(alpha, real.device).float().reshape(n, 1, 1, 1)
    x_hat = (alpha * real.detach().float()
             + (1.0 - alpha) * fake.detach().float()).requires_grad_()
    score = d_score_fn(x_hat).float().sum()
    grads, = torch.autograd.grad(score, x_hat, create_graph=True)
    norms = torch.sqrt(torch.sum(torch.square(grads.reshape(n, -1).float()),
                                 dim=1) + eps)
    return torch.mean(torch.square(norms - center))
