"""Fused strided Conv(k=4, s=2, p=1) + per-channel affine + activation
(port of ``tpugan/ops/pallas_conv.py``; kernel in ``csrc/cuda_conv.cu``).

The discriminator's conv.  With the input zero-padded by one pixel,

    out[i, j] = sum_{kh, kw} xp[2i + kh, 2j + kw] @ W[kh, kw]

so a layer is 16 shifted (N*Ho*Wo, Cin) @ (Cin, Cout) matmuls with fp32
accumulation.  The TPU kernel reads them from four parity planes of the
padded input built outside the kernel; the CUDA kernel reads the input in
place.

The kernel has two paths, chosen by shape in the library's launch plan
(``plan``, ``tg_conv_affine_act_plan``):

- "narrow": Cin <= 16 with Cout <= 128 (the discriminator's RGB layer).  x
  and w are read as they are, by plain loads: no padding, no copy.
- "wide": every other Cin, zero-padded to a multiple of 64 (x and w), with
  Cout padded with zero columns of w to a multiple of 8 and operands off
  16-byte alignment copied (``wide_operands``: TMA reads them).  The
  discriminator's other layers (Cin 64 to 256, Cout a multiple of 64,
  tensors from PyTorch's allocator) take no copy.

fp32 operands (``train.precision="fp32"``, as the Pallas kernel takes them)
compute the same function with fp32 products, by a route decided from Cin
and Cout before the launch (``f32_path``): three TF32 passes over split
operands on the tensor cores, ``tg_conv_affine_act_tf32`` (Cin a multiple
of 32: kernel 5's fp32 conv tile, x copied only if off 16-byte alignment,
the weight split once a call into a scratch of ``torch.empty``, planned by
``plan_tf32``) or ``tg_conv_affine_act_tf32_narrow`` (Cin <= 16 with Cout
<= 128, the RGB layers: x and w read as they are); elsewhere
``tg_conv_affine_act_f32``, the FFMA mainloop of ``csrc/igemm_f32.cuh``,
which takes x and w as they are (any Cin and Cout, no padding, no plan).
A route's failed launch raises; nothing falls back to another.

``conv_affine_act`` takes a CPU tensor to the plain version below and a CUDA
tensor to the kernel; it raises on a shape or dtype the kernel does not
take (``kernel_common.check_operands``: x and w of one dtype, bf16 or fp32,
on every device), and when autograd would need a gradient through it (the
kernel is forward-only, as the Pallas kernel has no VJP).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tpugan_torch.ops import _build
from tpugan_torch.ops.kernel_common import (ACT_CODES, TF32_CIN, aligned,
                                            check_operands, pad_dim,
                                            round_up)
from tpugan_torch.ops.kernel_common import act as _act

# Kernel launches made by ``conv_affine_act`` (CUDA tensors only).
launches = 0

# The narrow tiles' shapes (kNarrowMaxCin, kNarrowMaxCout of the source).
NARROW_MAX_CIN, NARROW_MAX_COUT = 16, 128


def f32_path(cin: int, cout: int) -> str:
    """The route of kernel 4 on fp32 operands with ``cin`` input and
    ``cout`` output channels, decided before the launch: "tf32" (three TF32
    passes on the wide conv tile: Cin a multiple of 32), "tf32_narrow"
    (three TF32 passes on the narrow tile: Cin <= 16 with Cout <= 128) or
    "ffma" (the CUDA cores: the shapes neither tile takes).  A route's
    failed launch raises; nothing falls back to another."""
    if cin % TF32_CIN == 0:
        return "tf32"
    if cin <= NARROW_MAX_CIN and cout <= NARROW_MAX_COUT:
        return "tf32_narrow"
    return "ffma"


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


def wide_operands(x, w):
    """(x, w, ldb) as the wide conv kernels (this one's and
    ``cuda_conv_stats``') take them: Cin zero-padded to a multiple of 64,
    Cout zero-padded to ldb, a multiple of 8, in w; an operand off 16-byte
    alignment copied.  The padding adds zero products only."""
    cin_p = round_up(x.shape[3], 64)
    ldb = round_up(w.shape[3], 8)
    x = pad_dim(x, 3, cin_p)
    w = pad_dim(pad_dim(w, 2, cin_p), 3, ldb)
    return aligned(x), aligned(w), ldb


def kernel_operands(x, w, path: str):
    """(x, w, ldb) as the kernel takes them on ``path`` (``plan``'s): as
    they are on the narrow path, else ``wide_operands``."""
    if path == "narrow":
        return x, w, w.shape[3]
    return wide_operands(x, w)


def _lib():
    lib = _build.load("cuda_conv")
    if lib.tg_conv_affine_act.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for fn in (lib.tg_conv_affine_act, lib.tg_conv_affine_act_f32,
                   lib.tg_conv_affine_act_tf32_narrow):
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, i, p]
            fn.restype = ctypes.c_int
        lib.tg_conv_affine_act_tf32.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                                i, i, i, f, i, i, i, p]
        lib.tg_conv_affine_act_tf32.restype = ctypes.c_int
        for fn in (lib.tg_conv_affine_act_plan,
                   lib.tg_conv_affine_act_tf32_plan):
            fn.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
            fn.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _plan(n: int, h: int, w: int, cin: int, cout: int,
          device: int) -> tuple[str, int, int]:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = (ctypes.c_int * 3)()
    _lib().tg_conv_affine_act_plan(n, h, w, cin, cout, sms, out)
    return ("narrow" if out[0] else "wide"), out[1], out[2]


@functools.lru_cache(maxsize=None)
def _plan_tf32(n: int, h: int, w: int, cin: int, cout: int,
               device: int) -> tuple[int, int, int]:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = (ctypes.c_int * 3)()
    _lib().tg_conv_affine_act_tf32_plan(n, h, w, cin, cout, sms, out)
    return out[0], out[1], out[2]


def plan(x, cout: int) -> tuple[str, int, int]:
    """(path, tiles, splits) of a layer on the CUDA input ``x`` (as the
    caller gives it) with ``cout`` channels, as the library plans it for
    x's card (once a shape): the path (module doc), the tiles of the output
    grid and the blocks that split each tile's depth."""
    return _plan(*x.shape, cout, x.device.index)


def plan_tf32(x, cout: int) -> tuple[int, int, int]:
    """(tiles, splits, tile width) of the "tf32" route on an fp32 CUDA
    input ``x`` (Cin a multiple of 32), as the library plans it for x's
    card (once a shape): kernel 5's fp32 plan
    (``cuda_conv_stats.plan_tf32``), at most 2 blocks a tile, 64-wide
    tiles where 128-wide ones would leave half the card idle."""
    return _plan_tf32(*x.shape, cout, x.device.index)


def _launch(x, w, scale, shift, act, leak, out_dtype, splits=None):
    """The kernel on CUDA tensors.  ``splits`` is for measurement only: it
    overrides the planned depth split of the "tf32" route with another of
    1, 2 or 4 dividing its 16 Cin / 32 stages."""
    global launches
    cout = w.shape[-1]
    lib = _lib()
    route = (f32_path(x.shape[3], cout) if x.dtype == torch.float32
             else "bf16")
    if route == "tf32":
        x, w, ldb = aligned(x.contiguous()), w.contiguous(), cout
    elif route in ("tf32_narrow", "ffma"):
        # the narrow tile and the FFMA mainloop take the operands as they are
        x, w, ldb = x.contiguous(), w.contiguous(), cout
    else:
        x, w, ldb = kernel_operands(x.contiguous(), w.contiguous(),
                                    plan(x, cout)[0])
    a = scale.to(torch.float32).contiguous()
    b = shift.to(torch.float32).contiguous()
    n, h, wd, cin = x.shape
    y = torch.empty((n, h // 2, wd // 2, cout), dtype=out_dtype,
                    device=x.device)
    common = (a.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, wd, cin, cout,
              ldb, ACT_CODES[act], float(leak),
              int(out_dtype == torch.float32))
    stream = _build.stream_ptr(x.device.index)
    with torch.cuda.device(x.device):
        if route == "tf32":
            _, planned, bn = plan_tf32(x, cout)
            # scratch: the weight's TF32 part and rest, K-major
            ws = torch.empty(32 * cin * cout, dtype=torch.float32,
                             device=x.device)
            rc = lib.tg_conv_affine_act_tf32(
                x.data_ptr(), w.data_ptr(), ws.data_ptr(), *common,
                splits or planned, bn, stream)
        else:
            fn = {"tf32_narrow": lib.tg_conv_affine_act_tf32_narrow,
                  "ffma": lib.tg_conv_affine_act_f32,
                  "bf16": lib.tg_conv_affine_act}[route]
            rc = fn(x.data_ptr(), w.data_ptr(), *common, stream)
    _build.check(rc, "conv_affine_act")
    launches += 1
    return y


def conv_affine_act(x, w, scale, shift, *, act: str = "leaky_relu",
                    leak: float = 0.2, out_dtype=None):
    """Fused y = act(conv_{4,2,1}(x, w) * scale + shift).

    x: (N, H, W, Cin), H and W even; w: (4, 4, Cin, Cout) HWIO;
    scale/shift: (Cout,) fp32 per-channel affine (from ``bn_affine``, or
    (1, bias) for a plain bias).  Returns (N, H/2, W/2, Cout) in
    ``out_dtype`` (default: x's dtype).  x and w are bf16, or fp32 (fp32
    products on the card), of one dtype.
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
    check_operands(x, w, out_dtype, scale, shift)
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
