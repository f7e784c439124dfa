"""Generator and discriminator building blocks (port of
``tpugan/models/blocks.py``).

- ``GHead``: Dense z -> (s0 x s0) map -> BatchNorm -> ReLU.  The Dense output
  is reshaped as (N, s0, s0, c0), channels last, as in the JAX package.
- ``GBlock``: ConvTranspose(4, 2, 1) -> BatchNorm -> ReLU, or ConvT -> Tanh
  for the final layer.
- ``DBlock``: Conv(4, 2, 1) -> [BatchNorm] -> LeakyReLU.
- ``DTail``: flatten the final NHWC map -> Dense -> one logit per image.

Under the "pallas" impl (``ops.convs.set_default_impl``) an eval-mode GBlock
or DBlock is one call of a fused kernel (``cuda_convt.convt_affine_act``,
``cuda_conv.conv_affine_act``): BatchNorm (or the conv bias) folds into its
per-channel (a, b) epilogue.  These kernels are forward-only.  A train-mode
DBlock with BatchNorm runs ``cuda_conv_stats.conv_bn_stats`` when its own
``fuse_stats`` mode (``train.fuse_stats`` of the config that built it) is on:
the conv and its batch statistics in one kernel, with a PyTorch backward.
"""

from __future__ import annotations

import torch
from torch import nn

from tpugan_torch.nn.layers import (BatchNorm, Conv, ConvTranspose, Dense,
                                    LeakyReLU, ReLU, Tanh)
from tpugan_torch.ops import convs, cuda_conv, cuda_conv_stats, cuda_convt
from tpugan_torch.ops.fused import bn_act, bn_affine


class GBlock(nn.Module):
    """ConvT(k4,s2,p1) + BN + ReLU; ``final=True`` swaps BN+ReLU for Tanh."""

    def __init__(self, cin, cout, *, batchnorm=True, final=False,
                 kernel=4, stride=2, padding=1, dtype=torch.bfloat16,
                 device="cuda", generator=None):
        super().__init__()
        # BN follows, so the conv bias would be normalized away; the final
        # (Tanh) layer keeps its bias.
        self.conv = ConvTranspose(cin, cout, kernel, stride, padding,
                                  use_bias=final or not batchnorm, dtype=dtype,
                                  device=device, generator=generator)
        self.bn = (BatchNorm(cout, dtype=dtype, device=device,
                             generator=generator)
                   if (batchnorm and not final) else None)
        self.act = Tanh() if final else ReLU()
        self.final = final

    def _fused_eval(self, x):
        conv = self.conv
        if self.bn is not None:
            a, b = bn_affine(self.bn.scale, self.bn.bias, self.bn.mean,
                             self.bn.var, self.bn.eps)
        else:
            a = torch.ones(conv.cout, device=x.device)
            b = (conv.b.float() if conv.b is not None
                 else torch.zeros(conv.cout, device=x.device))
        return cuda_convt.convt_affine_act(
            x.to(conv.dtype), conv.w.to(conv.dtype), a, b,
            act="tanh" if self.final else "relu", out_dtype=conv.dtype)

    def forward(self, x):
        if not self.training and convs.resolve_impl(None) == "pallas":
            return self._fused_eval(x)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class GHead(nn.Module):
    """z (N, nz) -> (N, s0, s0, cout) via matmul, then BN + ReLU."""

    def __init__(self, nz, s0, cout, *, batchnorm=True, dtype=torch.bfloat16,
                 device="cuda", generator=None):
        super().__init__()
        self.s0, self.cout = s0, cout
        self.dense = Dense(nz, s0 * s0 * cout, use_bias=not batchnorm,
                           dtype=dtype, device=device, generator=generator)
        self.bn = (BatchNorm(cout, dtype=dtype, device=device,
                             generator=generator) if batchnorm else None)

    def forward(self, z):
        x = self.dense(z).reshape(z.shape[0], self.s0, self.s0, self.cout)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x)


class DBlock(nn.Module):
    """Conv(k4,s2,p1) + [BN] + LeakyReLU(leak); spectral norm raises (it is
    not ported yet).  ``fuse_stats`` ("on" | "off" | "auto") selects the
    train-mode path of a block with BN."""

    def __init__(self, cin, cout, *, batchnorm=False, spectral_norm=False,
                 leak=0.2, fuse_stats="off", dtype=torch.bfloat16,
                 device="cuda", generator=None):
        super().__init__()
        if fuse_stats not in cuda_conv_stats.FUSE_MODES:
            raise ValueError(f"unknown fuse_stats mode {fuse_stats!r}")
        self.fuse_stats = fuse_stats
        if spectral_norm:
            raise NotImplementedError(
                "spectral norm is not ported yet (ROADMAP.md, Queue A: "
                "'Discriminator models', SpectralNorm)")
        self.conv = Conv(cin, cout, use_bias=not batchnorm, dtype=dtype,
                         device=device, generator=generator)
        self.bn = (BatchNorm(cout, dtype=dtype, device=device,
                             generator=generator) if batchnorm else None)
        self.act = LeakyReLU(leak)

    def _fused_train(self, x):
        dt = self.conv.dtype
        y, mean, var = cuda_conv_stats.conv_bn_stats(x.to(dt),
                                                     self.conv.w.to(dt))
        out = bn_act(y, self.bn.scale, self.bn.bias, mean, var,
                     eps=self.bn.eps, act="leaky_relu", leak=self.act.slope,
                     out_dtype=dt)
        self.bn.update_running(mean.detach(), var.detach(),
                               y.shape[0] * y.shape[1] * y.shape[2])
        return out

    def _fused_eval(self, x):
        conv = self.conv
        if self.bn is not None:
            a, b = bn_affine(self.bn.scale, self.bn.bias, self.bn.mean,
                             self.bn.var, self.bn.eps)
        else:  # no BN: the conv keeps its bias
            a, b = torch.ones(conv.cout, device=x.device), conv.b.float()
        return cuda_conv.conv_affine_act(
            x.to(conv.dtype), conv.w.to(conv.dtype), a, b, act="leaky_relu",
            leak=self.act.slope, out_dtype=conv.dtype)

    def forward(self, x):
        if self.training:
            if (self.bn is not None
                    and cuda_conv_stats.fuse_stats_enabled(self.fuse_stats, x)
                    and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
                return self._fused_train(x)
        elif convs.resolve_impl(None) == "pallas":
            return self._fused_eval(x)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class DTail(nn.Module):
    """Flatten the final s0 x s0 NHWC map and project to one logit."""

    def __init__(self, s0, cin, *, dtype=torch.bfloat16, device="cuda",
                 generator=None):
        super().__init__()
        self.s0, self.cin = s0, cin
        self.dense = Dense(s0 * s0 * cin, 1, use_bias=True, dtype=dtype,
                           device=device, generator=generator)

    def forward(self, x):
        return self.dense(x.reshape(x.shape[0], -1))[:, 0]
