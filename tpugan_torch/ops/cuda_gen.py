"""Whole eval-mode generator in one kernel launch, full-resolution NHWC
between layers: megakernel v1 (port of ``tpugan/ops/pallas_gen.py``; kernel
in ``csrc/cuda_gen.cu``).

The generator runs as dense head x folded-BN affine -> ReLU ->
[ConvT(4,2,1) + affine + ReLU] x -> ConvT + bias + Tanh, with bf16 operands
to every matmul, fp32 sums, and activations rounded to bf16 between layers
(the final image too, as the Pallas kernel does).  Eval mode only: BatchNorm
folds into per-channel (a, b) (``fold_generator``).  Unconditional only; the
v2 kernel (``cuda_gen2``) takes conditional generators.
"""

from __future__ import annotations

import ctypes

import torch

from tpugan_torch.ops import _build
from tpugan_torch.ops.cuda_convt import convt_affine_act_plain
from tpugan_torch.ops.fused import bn_affine

# Kernel launches made by ``generator_forward`` (CUDA tensors only).
launches = 0

# csrc/convt_tile.cuh kMaxLayers: ConvT layers the kernels' argument holds
MAX_LAYERS = 8


def fold_generator(g, eps: float = 1e-5):
    """Fold an eval-mode ``Generator``'s params and BN running stats into
    ``((wh, ah, bh), [(w, a, b) per ConvT layer], (s0, c0))``, fp32.

    The head affine is per channel, tiled over the s0*s0 pixels of the
    (s0, s0, c0)-flattened dense output; without head BN the Dense bias is
    already full size.  A block without BN has identity scale and its conv
    bias as shift; the final layer is (1, bias).
    """
    s0, c0 = g.head.s0, g.head.cout
    dev = g.head.dense.w.device
    dense = g.head.dense
    if g.head.bn is not None:
        bn = g.head.bn
        a, b = bn_affine(bn.scale, bn.bias, bn.mean, bn.var, eps)
        ah, bh = a.repeat(s0 * s0), b.repeat(s0 * s0)
    else:
        ah = torch.ones(s0 * s0 * c0, device=dev)
        bh = (dense.b.float() if dense.b is not None
              else torch.zeros(s0 * s0 * c0, device=dev))

    def affine(blk):
        conv, cout = blk.conv, blk.conv.cout
        if blk.bn is not None:
            return bn_affine(blk.bn.scale, blk.bn.bias, blk.bn.mean,
                             blk.bn.var, eps)
        return (torch.ones(cout, device=dev),
                conv.b.float() if conv.b is not None
                else torch.zeros(cout, device=dev))

    blocks = [(blk.conv.w, *affine(blk)) for blk in [*g.blocks, g.final]]
    detach = lambda t: t.detach().float()  # noqa: E731
    return ((detach(dense.w), detach(ah), detach(bh)),
            [tuple(detach(t) for t in blk) for blk in blocks], (s0, c0))


def head_plain(z, head, s0, c0):
    """relu((bf16 z @ bf16 wh) * ah + bh) as (N, s0, s0, c0) fp32."""
    wh, ah, bh = head
    h = z.to(torch.bfloat16).float() @ wh.to(torch.bfloat16).float()
    return torch.relu(h * ah + bh).reshape(z.shape[0], s0, s0, c0)


def generator_forward_plain(z, head, blocks, s0, c0):
    """The plain PyTorch version of the v1 kernel: (N, S, S, C) fp32."""
    x = head_plain(z, head, s0, c0).to(torch.bfloat16)
    for i, (w, a, b) in enumerate(blocks):
        x = convt_affine_act_plain(
            x, w.to(torch.bfloat16), a, b,
            act="tanh" if i == len(blocks) - 1 else "relu",
            out_dtype=torch.bfloat16)
    return x.float()


def check_folded(z, head, blocks, s0, c0):
    """Validate a folded generator against the kernels' limits."""
    wh, ah, bh = head
    if z.dim() != 2 or z.shape[0] < 1 or z.shape[1] != wh.shape[0]:
        raise ValueError(f"z must be (n, {wh.shape[0]}), got {tuple(z.shape)}")
    hw = (s0 * s0 * c0,)
    if wh.shape[1] != hw[0] or ah.shape != hw or bh.shape != hw:
        raise ValueError("head shapes do not match (s0, c0)")
    if not 1 <= len(blocks) <= MAX_LAYERS:
        raise ValueError(f"1..{MAX_LAYERS} ConvT layers supported, "
                         f"got {len(blocks)}")
    cin = c0
    for w, a, b in blocks:
        if tuple(w.shape[:3]) != (4, 4, cin):
            raise ValueError(f"ConvT weight {tuple(w.shape)} does not take "
                             f"{cin} channels with a 4x4 kernel")
        cin = w.shape[3]
        if a.shape != (cin,) or b.shape != (cin,):
            raise ValueError("block affine shapes do not match Cout")
    if torch.is_grad_enabled() and z.requires_grad:
        raise RuntimeError("the generator kernels are forward-only: run them "
                           "under torch.no_grad()")


def launch(lib_name: str, fn_name: str, z, head, blocks, s0, c0, out_shape):
    """Launch a megakernel (``cuda_gen.tg_gen_forward`` or
    ``cuda_gen2.tg_gen2_forward``, which share one C signature) and return
    its fp32 output of ``out_shape``.

    Each block of the grid runs ``bt`` images; its activations ping-pong
    between two workspace buffers in device memory sized for the largest
    layer output.
    """
    dev = z.device
    bf = torch.bfloat16
    wh, ah, bh = head
    n, nz = z.shape
    z = z.to(bf).contiguous()
    wh = wh.to(device=dev, dtype=bf).contiguous()
    ah = ah.to(device=dev, dtype=torch.float32).contiguous()
    bh = bh.to(device=dev, dtype=torch.float32).contiguous()
    ws = [w.to(device=dev, dtype=bf).contiguous() for w, _, _ in blocks]
    as_ = [a.to(device=dev, dtype=torch.float32).contiguous()
           for _, a, _ in blocks]
    bs = [b.to(device=dev, dtype=torch.float32).contiguous()
          for _, _, b in blocks]
    couts = [w.shape[3] for w in ws]
    # largest activation the workspace must hold: the head output and every
    # layer output but the last, which goes straight to y
    elems, hs = s0 * s0 * c0, s0
    for c in couts[:-1]:
        hs *= 2
        elems = max(elems, hs * hs * c)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bt = max(1, -(-n // (2 * sms)))
    grid = -(-n // bt)
    work = torch.empty(grid * 2 * bt * elems, dtype=bf, device=dev)
    y = torch.empty(out_shape, dtype=torch.float32, device=dev)

    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, p, p, p, p, p, ctypes.c_longlong,
                       p, i, i, p]
        fn.restype = ctypes.c_int
    nl = len(ws)
    w_ptrs = (ctypes.c_void_p * nl)(*[w.data_ptr() for w in ws])
    a_ptrs = (ctypes.c_void_p * nl)(*[a.data_ptr() for a in as_])
    b_ptrs = (ctypes.c_void_p * nl)(*[b.data_ptr() for b in bs])
    c_arr = (ctypes.c_int * nl)(*couts)
    addr = lambda arr: ctypes.cast(arr, ctypes.c_void_p)  # noqa: E731
    with torch.cuda.device(dev):
        rc = fn(z.data_ptr(), nz, wh.data_ptr(), ah.data_ptr(), bh.data_ptr(),
                s0, c0, nl, addr(w_ptrs), addr(a_ptrs), addr(b_ptrs),
                addr(c_arr), work.data_ptr(), elems, y.data_ptr(), n, bt,
                _build.stream_ptr(dev.index))
    _build.check(rc, fn_name)
    return y


def generator_forward(g, z, *, eps: float = 1e-5):
    """Run an unconditional eval-mode ``Generator`` as one kernel launch:
    z (N, nz) -> images (N, S, S, C) fp32.  The plain version for a CPU z."""
    global launches
    if not hasattr(g, "head"):
        raise ValueError("megakernel v1 takes unconditional generators only; "
                         "use cuda_gen2 for a CondGenerator")
    head, blocks, (s0, c0) = fold_generator(g, eps)
    check_folded(z, head, blocks, s0, c0)
    if z.device.type == "cpu":
        return generator_forward_plain(z, head, blocks, s0, c0)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    size = s0 * 2 ** len(blocks)
    y = launch("cuda_gen", "tg_gen_forward", z, head, blocks, s0, c0,
               (z.shape[0], size, size, blocks[-1][0].shape[3]))
    launches += 1
    return y
