"""Fused strided Conv(k=4, s=2, p=1) + per-channel affine + activation
(port of ``tpugan/ops/pallas_conv.py``; kernel in ``csrc/cuda_conv.cu``).

The discriminator's conv.  With the input zero-padded by one pixel,

    out[i, j] = sum_{kh, kw} xp[2i + kh, 2j + kw] @ W[kh, kw]

so a layer is 16 shifted (N*Ho*Wo, Cin) @ (Cin, Cout) matmuls with fp32
accumulation.  The TPU kernel reads them from four parity planes of the
padded input built outside the kernel; the CUDA kernel reads the input in
place through a table of per-tap offsets (``csrc/conv_tile.cuh``).

``conv_affine_act`` takes a CPU tensor to the plain version below and a CUDA
tensor to the kernel; it raises on a shape or dtype the kernel does not
take, and when autograd would need a gradient through it (the kernel is
forward-only, as the Pallas kernel has no VJP).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpugan_torch.ops import _build
from tpugan_torch.ops.kernel_common import ACT_CODES, act as _act

# Kernel launches made by ``conv_affine_act`` (CUDA tensors only).
launches = 0


def check_conv421(x, w) -> None:
    """Raise on operands the Conv(4, 2, 1) kernels do not take."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, Cin), got {tuple(x.shape)}")
    if w.dim() != 4 or w.shape[0] != 4 or w.shape[1] != 4:
        raise ValueError(f"w must be (4, 4, Cin, Cout), got {tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"Cin mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}")
    n, h, wd, _ = x.shape
    if n < 1 or h < 2 or wd < 2 or h % 2 or wd % 2:
        raise ValueError(f"the conv kernel takes a batch of even-sized "
                         f"images, got {tuple(x.shape)}")


def check_forward_only(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} is forward-only: it has no backward "
                           f"(run it under torch.no_grad())")


def check_bf16_operands(x, w, out_dtype, *others) -> None:
    """The CUDA kernels' operand contract: bf16 x and w on one device."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 x and w, got "
                         f"{x.dtype} and {w.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    for t in (w, *others):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got "
                             f"{t.device}")


def conv421_plain(x, w):
    """The plain strided conv: 16 shifted matmuls, fp32 sums of the operands
    as given (bf16 products are exact in fp32); returns (N, H/2, W/2, Cout)
    fp32."""
    n, h, wd, cin = x.shape
    ho, wo = h // 2, wd // 2
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((n * ho * wo, w.shape[3]), dtype=torch.float32,
                      device=x.device)
    for kh in range(4):
        for kw in range(4):
            xs = xp[:, kh:kh + 2 * ho:2, kw:kw + 2 * wo:2, :]
            acc = acc + xs.reshape(-1, cin) @ wf[kh, kw]
    return acc.reshape(n, ho, wo, -1)


def conv_affine_act_plain(x, w, scale, shift, *, act: str = "leaky_relu",
                          leak: float = 0.2, out_dtype=None):
    """The plain PyTorch version of ``conv_affine_act``."""
    y = conv421_plain(x, w) * scale.float() + shift.float()
    return _act(y, act, leak).to(out_dtype or x.dtype)


def _lib():
    lib = _build.load("cuda_conv")
    fn = lib.tg_conv_affine_act
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, w, scale, shift, act, leak, out_dtype):
    global launches
    check_bf16_operands(x, w, out_dtype, scale, shift)
    x = x.contiguous()
    w = w.contiguous()
    a = scale.to(torch.float32).contiguous()
    b = shift.to(torch.float32).contiguous()
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty((n, h // 2, wd // 2, cout), dtype=out_dtype,
                    device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().tg_conv_affine_act(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), n, h, wd, cin, cout, ACT_CODES[act], float(leak),
            int(out_dtype == torch.float32), _build.stream_ptr(x.device.index))
    _build.check(rc, "conv_affine_act")
    launches += 1
    return y


def conv_affine_act(x, w, scale, shift, *, act: str = "leaky_relu",
                    leak: float = 0.2, out_dtype=None):
    """Fused y = act(conv_{4,2,1}(x, w) * scale + shift).

    x: (N, H, W, Cin), H and W even; w: (4, 4, Cin, Cout) HWIO;
    scale/shift: (Cout,) fp32 per-channel affine (from ``bn_affine``, or
    (1, bias) for a plain bias).  Returns (N, H/2, W/2, Cout) in
    ``out_dtype`` (default: x's dtype).  On CUDA, x and w must be bf16.
    """
    check_conv421(x, w)
    cout = w.shape[3]
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be ({cout},), got {tuple(t.shape)}")
    if act not in ACT_CODES:
        raise ValueError(f"unknown act {act!r}")
    check_forward_only("conv_affine_act", x, w, scale, shift)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return conv_affine_act_plain(x, w, scale, shift, act=act, leak=leak,
                                     out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, w, scale, shift, act, leak, out_dtype)


def conv2d(x, w):
    """The bare strided conv (no epilogue), fp32 out: the ``ops.convs``
    "pallas" hook."""
    cout = w.shape[-1]
    one = torch.ones((cout,), dtype=torch.float32, device=x.device)
    zero = torch.zeros((cout,), dtype=torch.float32, device=x.device)
    return conv_affine_act(x, w, one, zero, act="none",
                           out_dtype=torch.float32)
