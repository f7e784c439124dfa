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
gradients, as the JAX package computes it with XLA.  Each DBlock holds its
own ``fuse_stats`` mode ("on" | "off" | "auto"; "auto" fuses on CUDA
tensors), from the config that built it; ``fuse_stats_enabled`` reads it.

The kernel reads x and w by TMA, x through a view that puts the two column
parities of 2 Cin channels side by side.  ``kernel_operands`` states the
rule: Cin is padded with zero channels to a multiple of 64 (x and w), Cout
with zero columns of w to a multiple of 8, and an operand off 16-byte
alignment is copied.  The discriminator's BN layers (Cin 64 to 256, Cout a
multiple of 64, tensors from PyTorch's allocator) take no copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpugan_torch.ops import _build
from tpugan_torch.ops.cuda_conv import (check_bf16_operands, check_conv421,
                                        check_forward_only, conv421_plain)
from tpugan_torch.ops.kernel_common import aligned, pad_dim, round_up

# Kernel launches made by ``conv_stats`` (CUDA tensors only).
launches = 0

FUSE_MODES = ("on", "off", "auto")


def fuse_stats_enabled(mode: str, x: torch.Tensor) -> bool:
    """Whether a train-mode DBlock in fuse_stats ``mode`` fuses its conv and
    BN statistics for input ``x``."""
    if mode not in FUSE_MODES:
        raise ValueError(f"unknown fuse_stats mode {mode!r}")
    if mode == "auto":
        return x.device.type == "cuda"
    return mode == "on"


def kernel_operands(x, w):
    """(x, w, ldb) as the kernel takes them: Cin zero-padded to a multiple
    of 64, Cout zero-padded to ldb, a multiple of 8, in w; an operand off
    16-byte alignment copied.  The padding adds zero products only."""
    cin_p = round_up(x.shape[3], 64)
    ldb = round_up(w.shape[3], 8)
    x = pad_dim(x, 3, cin_p)
    w = pad_dim(pad_dim(w, 2, cin_p), 3, ldb)
    return aligned(x), aligned(w), ldb


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
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.tg_conv_stats_plan.argtypes = [i, i, i, i, i, i,
                                           ctypes.POINTER(i)]
        lib.tg_conv_stats_plan.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _plan(n: int, h: int, w: int, cin_p: int, cout: int,
          device: int) -> tuple[int, int]:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = (ctypes.c_int * 2)()
    _lib().tg_conv_stats_plan(n, h, w, cin_p, cout, sms, out)
    return out[0], out[1]


def plan(x, cout: int) -> tuple[int, int]:
    """(tiles_m, splits) of a launch on the padded CUDA input ``x``: the
    kernel's tiles of the output grid and the blocks that split each tile's
    depth, as the library plans them for x's card (once a shape)."""
    return _plan(*x.shape, cout, x.device.index)


def _launch(x, w, splits=None):
    """The kernel on CUDA tensors.  ``splits`` is for measurement only: it
    overrides ``plan``'s depth split with another of 1, 2 or 4 dividing the
    16 Cin / 64 stages."""
    global launches
    check_bf16_operands(x, w, x.dtype)
    cout = w.shape[-1]
    x, w, ldb = kernel_operands(x.contiguous(), w.contiguous())
    n, h, wd, cin = x.shape
    tiles_m, planned = plan(x, cout)
    y = torch.empty((n, h // 2, wd // 2, cout), dtype=x.dtype,
                    device=x.device)
    # one buffer: the (mean, var) result, then the per-tile partials
    buf = torch.empty(2 * cout * (1 + tiles_m), dtype=torch.float32,
                      device=x.device)
    stats = buf.data_ptr()
    with torch.cuda.device(x.device):
        rc = _lib().tg_conv_stats(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), stats + 8 * cout,
            stats, n, h, wd, cin, cout, ldb, splits or planned, tiles_m,
            _build.stream_ptr(x.device.index))
    _build.check(rc, "conv_stats")
    launches += 1
    return y, buf[:cout], buf[cout:2 * cout]


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
