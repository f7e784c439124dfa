"""Core layers: conv / transpose conv / dense / batchnorm / embedding (port
of ``tpugan/nn/layers.py``).

Layout and precision follow the JAX package so that weights carry across by
name alone:

- activations are NHWC; Conv and ConvT weights are HWIO
  ``(k, k, Cin, Cout)``, unflipped; Dense weights are ``(din, dout)``;
- parameters live in fp32 and each layer casts them to its compute dtype
  (bf16 under ``precision="bf16"``); matmuls sum in fp32;
- BatchNorm statistics are computed and stored in fp32 whatever the compute
  dtype.

Where the JAX modules thread state functionally, these keep BatchNorm's
running statistics as buffers updated in place (``mean``, ``var``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpugan_torch.ops import convs
from tpugan_torch.utils.device import resolve_device

# Reference init idiom: conv/dense weights ~ N(0, 0.02); BN scale ~ N(1, 0.02).
INIT_STD = 0.02


def winit(shape, *, generator: torch.Generator | None = None,
          device="cuda", std: float = INIT_STD) -> torch.Tensor:
    """N(0, std) fp32 weights drawn from ``generator`` (on its own device),
    placed on ``device``."""
    gdev = generator.device if generator is not None else "cpu"
    w = torch.randn(shape, generator=generator, device=gdev) * std
    return w.to(resolve_device(device))


class Conv(nn.Module):
    """Strided 2D convolution, NHWC activations, HWIO weight ``w``."""

    def __init__(self, cin: int, cout: int, kernel: int = 4, stride: int = 2,
                 padding: int = 1, use_bias: bool = True,
                 dtype=torch.bfloat16, *, device="cuda", generator=None):
        super().__init__()
        self.cin, self.cout = cin, cout
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        self.w = nn.Parameter(winit((kernel, kernel, cin, cout),
                                    generator=generator, device=device))
        self.b = (nn.Parameter(torch.zeros(cout, device=resolve_device(device)))
                  if use_bias else None)

    def forward(self, x):
        y = convs.conv2d(x.to(self.dtype), self.w.to(self.dtype),
                         stride=self.stride, padding=self.padding)
        if self.b is not None:
            y = y + self.b
        return y.to(self.dtype)


class ConvTranspose(nn.Module):
    """Transpose conv with reference ``ConvTranspose2d(k, s, p)`` semantics,
    out = (in - 1) * s - 2p + k; weight ``w`` is HWIO, unflipped."""

    def __init__(self, cin: int, cout: int, kernel: int = 4, stride: int = 2,
                 padding: int = 1, use_bias: bool = True,
                 dtype=torch.bfloat16, *, device="cuda", generator=None):
        super().__init__()
        if kernel - 1 - padding < 0:
            raise ValueError("require kernel - 1 - padding >= 0")
        self.cin, self.cout = cin, cout
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        self.w = nn.Parameter(winit((kernel, kernel, cin, cout),
                                    generator=generator, device=device))
        self.b = (nn.Parameter(torch.zeros(cout, device=resolve_device(device)))
                  if use_bias else None)

    def forward(self, x):
        y = convs.conv_transpose2d(x.to(self.dtype), self.w.to(self.dtype),
                                   stride=self.stride, padding=self.padding)
        if self.b is not None:
            y = y + self.b
        return y.to(self.dtype)


class Dense(nn.Module):
    """Linear layer, weight ``w`` (din, dout): G's z -> s0 x s0 head."""

    def __init__(self, din: int, dout: int, use_bias: bool = True,
                 dtype=torch.bfloat16, *, device="cuda", generator=None):
        super().__init__()
        self.din, self.dout = din, dout
        self.dtype = dtype
        self.w = nn.Parameter(winit((din, dout), generator=generator,
                                    device=device))
        self.b = (nn.Parameter(torch.zeros(dout, device=resolve_device(device)))
                  if use_bias else None)

    def forward(self, x):
        # operands rounded to the compute dtype, products summed in fp32
        y = x.to(self.dtype).float() @ self.w.to(self.dtype).float()
        if self.b is not None:
            y = y + self.b
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """Batch normalization over all axes but the last (channels).

    Training normalizes with the biased batch variance (clamped at >= 0) and
    updates the running stats with the unbiased one, momentum 0.1; eval uses
    the running stats.  Statistics are fp32.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, dtype=torch.bfloat16, *,
                 device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.c, self.eps, self.momentum = num_features, eps, momentum
        self.dtype = dtype
        self.scale = nn.Parameter(
            1.0 + winit((num_features,), generator=generator, device=dev))
        self.bias = nn.Parameter(torch.zeros(num_features, device=dev))
        self.register_buffer("mean", torch.zeros(num_features, device=dev))
        self.register_buffer("var", torch.ones(num_features, device=dev))

    @torch.no_grad()
    def update_running(self, mean, var, n: int) -> None:
        """Momentum update of the running stats from a batch's biased
        mean/var over n elements."""
        unbiased = var * (n / max(n - 1, 1))
        self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
        self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)

    def forward(self, x):
        xf = x.float()
        red = tuple(range(x.dim() - 1))
        if self.training:
            mean = xf.mean(dim=red)
            # E[x^2] - E[x]^2 can land slightly negative for near-constant
            # channels (fp32 cancellation); rsqrt would then yield NaN.
            var = torch.clamp((xf * xf).mean(dim=red) - mean * mean, min=0.0)
            n = xf.numel() // x.shape[-1]
            self.update_running(mean.detach(), var.detach(), n)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * inv + self.bias).to(self.dtype)


class Embedding(nn.Module):
    """Label embedding for the conditional G, table ~ N(0, 1)."""

    def __init__(self, n_classes: int, dim: int, dtype=torch.bfloat16, *,
                 device="cuda", generator=None):
        super().__init__()
        self.n, self.dim = n_classes, dim
        self.dtype = dtype
        self.table = nn.Parameter(winit((n_classes, dim), generator=generator,
                                        device=device, std=1.0))

    def forward(self, y):
        return self.table[y].to(self.dtype)


class ReLU(nn.Module):
    def forward(self, x):
        return torch.relu(x)


class LeakyReLU(nn.Module):
    def __init__(self, slope: float = 0.2):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return F.leaky_relu(x, self.slope)


class Tanh(nn.Module):
    def forward(self, x):
        return torch.tanh(x)
