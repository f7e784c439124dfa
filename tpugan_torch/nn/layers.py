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
import torch.distributed as dist
from torch import nn

from tpugan_torch.ops import convs
from tpugan_torch.ops.kernel_common import leaky_relu
from tpugan_torch.parallel import collectives, spatial
from tpugan_torch.parallel.mesh import batch_group
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

    def weight(self) -> torch.Tensor:
        """The fp32 weight the forward uses (``SNConv``: w / sigma)."""
        return self.w

    def forward(self, x):
        y = convs.conv2d(x.to(self.dtype), self.weight().to(self.dtype),
                         stride=self.stride, padding=self.padding)
        if self.b is not None:
            y = y + spatial.feed(self.b, y)
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
            y = y + spatial.feed(self.b, y)
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

    def weight(self) -> torch.Tensor:
        """The fp32 weight the forward uses (``SNDense``: w / sigma)."""
        return self.w

    def forward(self, x):
        # operands rounded to the compute dtype, products summed in fp32
        y = x.to(self.dtype).float() @ self.weight().to(self.dtype).float()
        if self.b is not None:
            y = y + self.b
        return y.to(self.dtype)


class BatchNorm(nn.Module):
    """Batch normalization over all axes but the last (channels).

    Training normalizes with the biased batch variance (clamped at >= 0) and
    updates the running stats with the unbiased one, momentum 0.1; eval uses
    the running stats.  Statistics are fp32.  Under a mesh the statistics
    are the global batch's: the per-channel sums of x and x^2 are
    all-reduced over the batch-sharded axes (not ``nn.SyncBatchNorm``:
    this is the JAX package's E[x^2] - E[x]^2).
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

    def _global_moments(self, xf, red, groups):
        """(E[x], E[x^2], n) over the batch shared by ``groups``: the
        per-channel sums all-reduced in fp32 (the backward all-reduces too:
        every rank's normalized rows depend on the global statistics); the
        shards are equal, so the count is this rank's times the groups'
        sizes."""
        c = xf.shape[-1]
        stats = torch.cat([xf.sum(dim=red), (xf * xf).sum(dim=red)])
        n = xf.numel() // c
        for group in groups:
            stats = collectives.all_reduce_sum(stats, group)
            n *= dist.get_world_size(group)
        return stats[:c] / n, stats[c:] / n, n

    def forward(self, x):
        xf = x.float()
        red = tuple(range(x.dim() - 1))
        scale, bias = spatial.feed(self.scale, x), spatial.feed(self.bias, x)
        if self.training:
            # under a mesh: the data axis of the step, and space when x is
            # a spatial shard (parallel/mesh.batch_ctx, parallel/spatial)
            groups = [g for g in [batch_group()] + spatial.bn_groups(x)
                      if g is not None]
            if groups:
                mean, sq, n = self._global_moments(xf, red, groups)
            else:
                mean, sq = xf.mean(dim=red), (xf * xf).mean(dim=red)
                n = xf.numel() // x.shape[-1]
            # E[x^2] - E[x]^2 can land slightly negative for near-constant
            # channels (fp32 cancellation); rsqrt would then yield NaN.
            var = torch.clamp(sq - mean * mean, min=0.0)
            self.update_running(mean.detach(), var.detach(), n)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * scale
        if torch.is_grad_enabled():
            return ((xf - mean) * inv + bias).to(self.dtype)
        # no graph to keep (sampling, FID): the same three ops in place,
        # the same bits, without a map-sized temporary for each
        y = xf.clone() if xf is x else xf
        return y.sub_(mean).mul_(inv).add_(bias).to(self.dtype)


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
    """JAX's leaky_relu, its derivative at 0 included
    (``ops/kernel_common.leaky_relu``)."""

    def __init__(self, slope: float = 0.2):
        super().__init__()
        self.slope = slope

    def forward(self, x):
        return leaky_relu(x, self.slope)


class Tanh(nn.Module):
    def forward(self, x):
        return torch.tanh(x)
