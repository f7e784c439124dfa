"""Fused normalize + activation epilogues (port of ``tpugan/ops/fused.py``).

The affine form: given BN statistics (mean, var) and parameters
(scale, bias),

    y = act((x - mean) * rsqrt(var + eps) * scale + bias)
      = act(x * a + b)   with  a = scale*rsqrt(var+eps),  b = bias - mean*a

so a fused conv kernel only needs a per-channel multiply-add epilogue.
"""

from __future__ import annotations

import torch

from tpugan_torch.ops.kernel_common import act as _act


def bn_affine(scale, bias, mean, var, eps: float):
    """Fold BN stats+params into per-channel (a, b) for a fused epilogue."""
    a = scale * torch.rsqrt(var + eps)
    return a, bias - mean * a


def bn_act(x, scale, bias, mean, var, *, eps: float = 1e-5,
           act: str = "relu", leak: float = 0.2, out_dtype=None):
    """Apply BN (given stats) then activation; compute in fp32."""
    a, b = bn_affine(scale, bias, mean, var, eps)
    y = _act(x.float() * a + b, act, leak)
    return y.to(out_dtype or x.dtype)


def bias_act(x, bias, *, act: str = "leaky_relu", leak: float = 0.2,
             out_dtype=None):
    """Bias + activation epilogue (for BN-free layers)."""
    y = x.float()
    if bias is not None:
        y = y + bias
    y = _act(y, act, leak)
    return y.to(out_dtype or x.dtype)
