"""Spectral normalization of a Conv or Dense weight (SNGAN; port of
``tpugan/nn/spectral_norm.py``).

The layer runs on W / sigma(W), sigma the largest singular value of W
reshaped to a (d, Cout) matrix, estimated by power iteration from a
persistent vector ``u`` (Cout,):

- a training forward runs one iteration, v = norm(W u), u = norm(W^T v),
  and keeps the new ``u``; an eval forward runs none and keeps ``u``;
- then, with u and v held constant, v = norm(W u) and sigma = v . (W u), so
  the gradient flows through W alone (d sigma / dW = v u^T).  Plain autograd
  ops, so the layer differentiates at every order: WGAN-GP's double
  backward composes with it.

``norm(x) = x * rsqrt(sum(x^2) + 1e-12)``, in fp32, as the JAX package
computes it (``torch.nn.utils.spectral_norm`` divides by max(|x|, eps) and
lays W out as (Cout, d), so it is not used).  The division is fp32; the
layer then casts W / sigma to its compute dtype as it casts W.

``SNConv`` and ``SNDense`` are ``Conv`` and ``Dense`` with a buffer ``u``
beside their ``w`` and ``b``: their ``state_dict`` keys are the JAX
package's params (``w``, ``b``) and state (``u``) at one level.
"""

from __future__ import annotations

import torch

from tpugan_torch.nn.layers import Conv, Dense, winit

N_ITER = 1  # power iterations per training forward (the JAX default)


def _l2_normalize(x, eps: float = 1e-12):
    return x * torch.rsqrt(torch.sum(x * x) + eps)


def spectral_sigma(w: torch.Tensor, u: torch.Tensor, n_iter: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sigma, new u) for weight ``w`` (..., Cout) from ``u`` (Cout,) after
    ``n_iter`` power iterations; sigma is differentiable in ``w`` only."""
    w_mat = w.reshape(-1, w.shape[-1]).float()
    with torch.no_grad():
        # a fresh tensor: the caller may overwrite its buffer ``u`` before
        # the backward that reads this one
        u = u.float().clone()
        for _ in range(n_iter):
            v = _l2_normalize(w_mat @ u)
            u = _l2_normalize(w_mat.T @ v)
    wu = w_mat @ u
    v = _l2_normalize(wu.detach())
    return v @ wu, u


class _SpectralNormed:
    """Mixin over ``Conv`` / ``Dense``: a unit ``u`` buffer and a
    ``weight()`` of w / sigma that advances ``u`` in training forwards."""

    def _init_u(self, generator) -> None:
        cout = self.w.shape[-1]
        u = winit((cout,), generator=generator, device=self.w.device,
                  std=1.0)
        self.register_buffer("u", _l2_normalize(u))

    def weight(self) -> torch.Tensor:
        sigma, u = spectral_sigma(self.w, self.u,
                                  N_ITER if self.training else 0)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
        return self.w / sigma


class SNConv(_SpectralNormed, Conv):
    """``Conv`` on its spectrally normalized weight."""

    def __init__(self, *args, generator=None, **kwargs):
        super().__init__(*args, generator=generator, **kwargs)
        self._init_u(generator)


class SNDense(_SpectralNormed, Dense):
    """``Dense`` on its spectrally normalized weight."""

    def __init__(self, *args, generator=None, **kwargs):
        super().__init__(*args, generator=generator, **kwargs)
        self._init_u(generator)
