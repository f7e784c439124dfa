"""Strided conv + per-channel batch statistics in one pass (port of
``tpugan/ops/pallas_conv_stats.py``; kernel in ``csrc/cuda_conv_stats.cu``).

In a train-mode DBlock the unfused path writes the conv output, reads it
again to reduce BatchNorm's batch statistics, and a third time to normalize.
``conv_stats`` emits the conv output and its per-channel mean and biased
variance together, taken from the fp32 sums before y is rounded to x's
dtype, so the normalize + activation epilogue is the only other pass.

``conv_bn_stats`` is the differentiable op a train-mode DBlock calls: its
forward is ``conv_stats`` (the kernel on a CUDA tensor, the plain version on
a CPU tensor); its backward is the exact unfused VJP in PyTorch's own conv
gradients, as the JAX package computes it with XLA.  ``set_fuse_stats``
selects the path ("on" | "off" | "auto"; "auto" fuses on CUDA tensors).
"""

from __future__ import annotations

import ctypes

import torch

from tpugan_torch.ops import _build
from tpugan_torch.ops.cuda_conv import (check_bf16_operands, check_conv421,
                                        check_forward_only, conv421_plain)

# Kernel launches made by ``conv_stats`` (CUDA tensors only).
launches = 0

FUSE_MODES = ("on", "off", "auto")
_FUSE_MODE = "off"  # process default; a train step sets train.fuse_stats


def set_fuse_stats(mode: str) -> None:
    """Set the train-path conv + BN-stats fusion mode."""
    global _FUSE_MODE
    if mode not in FUSE_MODES:
        raise ValueError(f"unknown fuse_stats mode {mode!r}")
    _FUSE_MODE = mode


def fuse_stats_enabled(x: torch.Tensor) -> bool:
    """Whether a train-mode DBlock fuses its conv and BN statistics for
    input ``x``."""
    if _FUSE_MODE == "auto":
        return x.device.type == "cuda"
    return _FUSE_MODE == "on"


def _moments(y32):
    mean = y32.mean(dim=(0, 1, 2))
    # clamp fp32 cancellation on near-constant channels (rsqrt NaN guard)
    var = torch.clamp((y32 * y32).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
    return mean, var


def conv_stats_plain(x, w):
    """The plain version: statistics of the fp32 sums, y rounded after."""
    y32 = conv421_plain(x, w)
    mean, var = _moments(y32)
    return y32.to(x.dtype), mean, var


def _lib():
    lib = _build.load("cuda_conv_stats")
    fn = lib.tg_conv_stats
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.tg_conv_stats_tile_rows.restype = ctypes.c_int
    return lib


def _launch(x, w):
    global launches
    check_bf16_operands(x, w, x.dtype)
    x = x.contiguous()
    w = w.contiguous()
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    lib = _lib()
    rows = n * (h // 2) * (wd // 2)
    tiles_m = -(-rows // lib.tg_conv_stats_tile_rows())
    y = torch.empty((n, h // 2, wd // 2, cout), dtype=x.dtype,
                    device=x.device)
    part = torch.empty((2, cout, tiles_m), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.tg_conv_stats(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(),
            stats.data_ptr(), n, h, wd, cin, cout, tiles_m,
            _build.stream_ptr())
    _build.check(rc, "conv_stats")
    launches += 1
    return y, stats[0], stats[1]


def conv_stats(x, w):
    """y = Conv(4, 2, 1)(x, w) with its per-channel batch mean and biased
    variance over (N, H/2, W/2), clamped at >= 0.

    Returns (y in x's dtype, mean f32, var f32).  Forward-only; on CUDA, x
    and w must be bf16.
    """
    check_conv421(x, w)
    check_forward_only("conv_stats", x, w)
    if x.device.type == "cpu":
        return conv_stats_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, w)


class _ConvBNStats(torch.autograd.Function):
    """Forward ``conv_stats``; backward the exact unfused VJP (first order
    only)."""

    @staticmethod
    def forward(ctx, x, w):
        y, mean, var = conv_stats(x, w)
        ctx.save_for_backward(x, w, y, mean)
        return y, mean, var

    @staticmethod
    def backward(ctx, yb, mb, vb):
        x, w, y, mean = ctx.saved_tensors
        count = y.shape[0] * y.shape[1] * y.shape[2]
        # mean = sum(y)/count adds mb/count to dL/dy; var = sum(y^2)/count
        # - mean^2 adds 2 (y - mean) vb / count (the chain through mean is
        # folded in: d var / d y_i = 2 y_i / count - 2 mean / count).
        extra = (mb + 2.0 * (y.float() - mean) * vb) / count
        gy = (yb.float() + extra).to(y.dtype).permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(
                (x.shape[0], x.shape[3], x.shape[1], x.shape[2]), w_oihw, gy,
                stride=2, padding=1).permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), w_oihw.shape, gy, stride=2,
                padding=1).permute(2, 3, 1, 0)
        return gx, gw


def conv_bn_stats(x, w):
    """Differentiable (y, mean, var) = Conv(4, 2, 1)(x, w) + batch stats."""
    return _ConvBNStats.apply(x, w)
