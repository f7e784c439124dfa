"""Fused ConvTranspose(k=4, s=2, p=1) + per-channel affine + activation
(port of ``tpugan/ops/pallas_convt.py``; kernel in ``csrc/cuda_convt.cu``).

Phase decomposition (zero-skipping transpose conv): with stride 2 the output
splits into 4 parity phases, and phase (di, dj) reads a fixed 2x2 subset of
the 4x4 taps (``kernel_common.TAPS``):

    out[2i+di, 2j+dj] = sum_{(kh,oh) in TAPS[di], (kw,ow) in TAPS[dj]}
                        x[i+oh, j+ow] @ W[kh, kw]

so a layer is 16 shifted (N*H*W, Cin) @ (Cin, Cout) matmuls with fp32
accumulation and no multiplies on dilation zeros.

``convt_affine_act`` takes a CPU tensor to the plain version below and a
CUDA tensor to the kernel; it raises on a shape or dtype the kernel does not
take, and when autograd would need a gradient through it (the kernel is
forward-only, as the Pallas kernel has no VJP).

The kernel reads x, and w where Cout > 8, by TMA, which needs rows of a
multiple of 16 bytes and 16-byte-aligned bases.  ``kernel_operands`` states
the rule: Cin is padded with zero channels to a multiple of 8 (x and w),
Cout with zero columns of w to a multiple of 8 where TMA reads w, and an
operand off 16-byte alignment is copied.  The generator's shapes (Cin 64 to
512, Cout 3 or a multiple of 64, tensors from PyTorch's allocator) take no
copy.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpugan_torch.ops import _build
from tpugan_torch.ops.kernel_common import (ACT_CODES, TAPS, aligned,
                                            pad_dim, round_up)
from tpugan_torch.ops.kernel_common import act as _act

# Kernel launches made by ``convt_affine_act`` (CUDA tensors only).
launches = 0

# Cout <= NARROW_COUT with Cin <= NARROW_MAX_CIN runs the four-phase kernel
# for few channels (csrc/cuda_convt.cu, convt_narrow), which keeps the whole
# weight in shared memory and reads it without TMA.
NARROW_COUT = 8
NARROW_MAX_CIN = 512


def _check(x, w, scale, shift, act):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    if w.dim() != 4 or w.shape[0] != 4 or w.shape[1] != 4:
        raise ValueError(f"w must be (4, 4, Cin, Cout), got {tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"Cin mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.shape[0] < 1:
        raise ValueError("empty batch")
    cout = w.shape[3]
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be ({cout},), got {tuple(t.shape)}")
    if act not in ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, scale, shift)):
        raise RuntimeError("convt_affine_act is forward-only: it has no "
                           "backward (run it under torch.no_grad())")


def convt_affine_act_plain(x, w, scale, shift, *, act: str = "relu",
                           leak: float = 0.2, out_dtype=None):
    """The plain PyTorch version: the same phase decomposition, fp32 sums
    of the operands as given (bf16 products are exact in fp32)."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    a = scale.float().reshape(1, 1, 1, cout)
    b = shift.float().reshape(1, 1, 1, cout)
    rows = []
    for di in (0, 1):
        cols = []
        for dj in (0, 1):
            acc = torch.zeros((n * h * wd, cout), dtype=torch.float32,
                              device=x.device)
            for kh, oh in TAPS[di]:
                for kw, ow in TAPS[dj]:
                    xs = xp[:, 1 + oh:1 + oh + h, 1 + ow:1 + ow + wd, :]
                    acc = acc + xs.reshape(-1, cin) @ wf[kh, kw]
            cols.append(_act(acc.reshape(n, h, wd, cout) * a + b, act, leak))
        rows.append(torch.stack(cols, dim=3))      # (N, H, W, 2, C)
    full = torch.stack(rows, dim=2)                # (N, H, 2, W, 2, C)
    return full.reshape(n, 2 * h, 2 * wd, cout).to(out_dtype or x.dtype)


def _lib():
    lib = _build.load("cuda_convt")
    fn = lib.tg_convt_affine_act
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float,
                       i, p]
        fn.restype = ctypes.c_int
    return lib


def kernel_operands(x, w):
    """(x, w, ldb) as the kernel takes them: Cin zero-padded to a multiple
    of 8; where the kernel reads w by TMA (Cout > NARROW_COUT or Cin >
    NARROW_MAX_CIN) Cout zero-padded to ldb, a multiple of 8; a TMA operand
    off 16-byte alignment copied.  The padding adds zero products only."""
    cin, cout = w.shape[2], w.shape[3]
    cin_p = round_up(cin, 8)
    x, w = pad_dim(x, 3, cin_p), pad_dim(w, 2, cin_p)
    if cout <= NARROW_COUT and cin_p <= NARROW_MAX_CIN:
        return aligned(x), w, cout
    ldb = round_up(cout, 8)
    return aligned(x), aligned(pad_dim(w, 3, ldb)), ldb


def _launch(x, w, scale, shift, act, leak, out_dtype):
    global launches
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 x and w, got "
                         f"{x.dtype} and {w.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    dev = x.device
    for t in (w, scale, shift):
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
    cout = w.shape[-1]
    x, w, ldb = kernel_operands(x.contiguous(), w.contiguous())
    a = scale.to(torch.float32).contiguous()
    b = shift.to(torch.float32).contiguous()
    n, h, wd, cin = x.shape
    y = torch.empty((n, 2 * h, 2 * wd, cout), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().tg_convt_affine_act(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), n, h, wd, cin, cout, ldb, ACT_CODES[act],
            float(leak), int(out_dtype == torch.float32),
            _build.stream_ptr(dev.index))
    _build.check(rc, "convt_affine_act")
    launches += 1
    return y


def convt_affine_act(x, w, scale, shift, *, act: str = "relu",
                     leak: float = 0.2, out_dtype=None):
    """Fused y = act(convT_{4,2,1}(x, w) * scale + shift).

    x: (N, H, W, Cin); w: (4, 4, Cin, Cout) HWIO deconv weights (unflipped);
    scale/shift: (Cout,) fp32 per-channel affine (from ``bn_affine``, or
    (1, bias) for a plain bias).  Returns (N, 2H, 2W, Cout) in ``out_dtype``
    (default: x's dtype).  On CUDA, x and w must be bf16.
    """
    _check(x, w, scale, shift, act)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return convt_affine_act_plain(x, w, scale, shift, act=act, leak=leak,
                                      out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, w, scale, shift, act, leak, out_dtype)


def conv_transpose2d(x, w):
    """The bare transpose conv (no epilogue), fp32 out: the ``ops.convs``
    "pallas" hook."""
    cout = w.shape[-1]
    one = torch.ones((cout,), dtype=torch.float32, device=x.device)
    zero = torch.zeros((cout,), dtype=torch.float32, device=x.device)
    return convt_affine_act(x, w, one, zero, act="none",
                            out_dtype=torch.float32)
