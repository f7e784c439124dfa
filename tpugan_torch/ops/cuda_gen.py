"""Whole eval-mode generator in one kernel launch, full-resolution NHWC image:
megakernel v1 (port of ``tpugan/ops/pallas_gen.py``; kernel in
``csrc/cuda_gen.cu``), and the host rules it shares with megakernel v2
(``cuda_gen2``).

The generator runs as dense head x folded-BN affine -> ReLU ->
[ConvT(4,2,1) + affine + ReLU] x -> ConvT + bias + Tanh, with bf16 operands
to every matmul, fp32 sums, and activations rounded to bf16 between layers
(the final image too, as the Pallas kernel does).  Eval mode only: BatchNorm
folds into per-channel (a, b) (``fold_generator``).  Unconditional only; the
v2 kernel (``cuda_gen2``) takes conditional generators.

Both megakernels are one persistent, cooperative launch of the same walk
over the head and the ConvT layers (``csrc/gen_sm90.cuh``), with the same
C interface (entry points ``tg_gen_*`` in ``cuda_gen``'s library,
``tg_gen2_*`` in ``cuda_gen2``'s); they differ only in where the image goes
and whether it is rounded.  Between layers the walk keeps the activations
as bf16 NHWC in a workspace of ``2 n workspace_elems(...)`` elements.  It
reads z, wh, the activations and the wide layers' weights by TMA, so
``kernel_operands`` pads: z's columns to a multiple of 8, c0 and every
inner layer's Cout to a multiple of 8 (zero weight columns with a zero
affine, so the extra channels are relu(0) = 0, and zero weight rows in the
next layer), and a wide last layer's weight columns to a multiple of 8.
The full-width generators take no copy but z's (nz = 100 -> 104).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpugan_torch.ops import _build
from tpugan_torch.ops.cuda_convt import convt_affine_act_plain
from tpugan_torch.ops.fused import bn_affine
from tpugan_torch.ops.kernel_common import aligned, pad_dim, round_up

# Kernel launches made by ``generator_forward`` (CUDA tensors only).
launches = 0

# csrc/gen_sm90.cuh kMaxLayers: ConvT layers the kernels' argument holds
MAX_LAYERS = 8

# the kinds of a layer in the libraries' walk (``plan``)
HEAD, WIDE, NARROW = 0, 1, 2

# the megakernels' libraries: v1's (this module's) and v2's
V1, V2 = "cuda_gen", "cuda_gen2"


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


def kernel_operands(z, head, blocks, s0, c0, kinds):
    """Either kernel's operands for a folded generator (module doc): ``(z,
    head, blocks, c0)`` with z bf16 (n, ldz), head (wh bf16, ah, bh f32),
    blocks [(w bf16, a f32, b f32, ldb)], c0 padded.  ``kinds``: each ConvT
    layer's kind in the library's walk (``layer_kinds``); a narrow last
    layer's weight is read by plain loads, unpadded.  The padding adds zero
    products and zero channels only."""
    dev, bf, f32 = z.device, torch.bfloat16, torch.float32
    wh, ah, bh = head
    c0p = round_up(c0, 8)
    if c0p != c0:  # per head pixel: (nz, s0 s0, c0) -> (nz, s0 s0, c0p)
        wh = pad_dim(wh.reshape(wh.shape[0], s0 * s0, c0), 2, c0p).flatten(1)
        ah = pad_dim(ah.reshape(s0 * s0, c0), 1, c0p).flatten()
        bh = pad_dim(bh.reshape(s0 * s0, c0), 1, c0p).flatten()
    zb = pad_dim(z.to(bf), 1, round_up(z.shape[1], 8)).contiguous()
    head = (aligned(wh.to(device=dev, dtype=bf).contiguous()),
            ah.to(device=dev, dtype=f32).contiguous(),
            bh.to(device=dev, dtype=f32).contiguous())
    ops, cin = [], c0p
    for i, (w, a, b) in enumerate(blocks):
        w = pad_dim(w, 2, cin)
        cout = w.shape[3]
        if i < len(blocks) - 1:  # zero weight columns, zero affine
            ldb = round_up(cout, 8)
            w, a, b = pad_dim(w, 3, ldb), pad_dim(a, 0, ldb), pad_dim(b, 0, ldb)
        elif kinds[i] == NARROW:
            ldb = cout
        else:
            ldb = round_up(cout, 8)
            w = pad_dim(w, 3, ldb)
        ops.append((aligned(w.to(device=dev, dtype=bf).contiguous()),
                    a.to(device=dev, dtype=f32).contiguous(),
                    b.to(device=dev, dtype=f32).contiguous(), ldb))
        cin = ldb
    return aligned(zb), head, ops, c0p


def workspace_elems(s0: int, c0: int, couts) -> int:
    """The largest activation of one image the walk's workspace holds: the
    head output and every layer output but the last, which goes to y."""
    elems, hs = s0 * s0 * c0, s0
    for c in couts[:-1]:
        hs *= 2
        elems = max(elems, hs * hs * c)
    return elems


_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interface both libraries export: (argument types, result type)
_SIGNATURES = {
    "forward": ([_P, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                 ctypes.c_longlong, _P, _P, _P, _I, _P], _I),
    "plan": ([_I, _I, _I, _I, _I, _P, _I, _P], None),
    "resident": ([ctypes.POINTER(_I)], _I),
}


def _entry(lib: str, what: str):
    """Entry point ``what`` ("forward", "plan" or "resident") of megakernel
    ``lib``'s library (``tg_gen_*`` for V1, ``tg_gen2_*`` for V2), its
    argument types set."""
    fn = getattr(_build.load(lib), f"tg_{lib.removeprefix('cuda_')}_{what}")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGNATURES[what]
    return fn


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def resident(device, lib: str = V1) -> int:
    """Blocks of megakernel ``lib``'s kernel the card holds at once: the
    grid's bound."""
    out = ctypes.c_int()
    fn = _entry(lib, "resident")
    with torch.cuda.device(device):
        _build.check(fn(ctypes.byref(out)), fn.__name__)
    return out.value


def plan(n: int, ldz: int, s0: int, c0: int, couts, blocks: int,
         lib: str = V1):
    """The walk of megakernel ``lib``'s library for n images on a card of
    ``blocks`` resident blocks: (grid, [(kind, tile columns, tiles, stages a
    tile) for the head and each ConvT layer]), kind HEAD, WIDE or NARROW."""
    nl = len(couts)
    out = (ctypes.c_int * (1 + 4 * (nl + 1)))()
    _entry(lib, "plan")(n, ldz, s0, c0, nl,
                        ctypes.cast(_ints(couts), ctypes.c_void_p), blocks,
                        ctypes.cast(out, ctypes.c_void_p))
    return out[0], [tuple(out[1 + 4 * l:5 + 4 * l]) for l in range(nl + 1)]


@functools.lru_cache(maxsize=None)
def _kinds(lib: str, s0: int, c0: int, couts: tuple) -> tuple:
    # n, z's width and the grid set no layer's kind
    return tuple(layer[0] for layer in plan(1, 8, s0, c0, couts, 1, lib)[1][1:])


def layer_kinds(s0: int, c0: int, couts, lib: str = V1) -> tuple:
    """Each ConvT layer's kind (WIDE or NARROW) in the walk (once a shape).
    The padding of ``kernel_operands`` leaves every kind as it is: a layer
    is narrow by its Cout (<= 8) and its Cin's 64-channel chunks."""
    return _kinds(lib, s0, c0, tuple(couts))


def run(lib: str, z, head, blocks, s0, c0, y, stamps=None):
    """Launch megakernel ``lib`` on ``kernel_operands``' output into the
    fp32 image ``y`` (in the kernel's layout); ``stamps`` as in
    ``cuda_gen2.launch``."""
    dev = z.device
    n, ldz = z.shape
    wh, ah, bh = head
    couts = [a.shape[0] for _, a, _, _ in blocks]
    elems = workspace_elems(s0, c0, couts)
    work = torch.empty(2 * n * elems, dtype=torch.bfloat16, device=dev)
    sync = torch.empty(1, dtype=torch.int32, device=dev)
    nl = len(blocks)
    ptrs = lambda k: (ctypes.c_void_p * nl)(  # noqa: E731
        *[blk[k].data_ptr() for blk in blocks])
    addr = lambda arr: ctypes.cast(arr, ctypes.c_void_p)  # noqa: E731
    fn = _entry(lib, "forward")
    with torch.cuda.device(dev):
        rc = fn(z.data_ptr(), wh.shape[0], ldz, wh.data_ptr(), ah.data_ptr(),
                bh.data_ptr(), s0, c0, nl, addr(ptrs(0)), addr(ptrs(1)),
                addr(ptrs(2)), addr(_ints(couts)),
                addr(_ints([blk[3] for blk in blocks])), work.data_ptr(),
                elems, sync.data_ptr(),
                None if stamps is None else stamps.data_ptr(), y.data_ptr(),
                n, _build.stream_ptr(dev.index))
    _build.check(rc, fn.__name__)
    return y


def launch(z, head, blocks, s0, c0, stamps=None):
    """The v1 kernel on ``kernel_operands``' output: returns the (N, S, S, C)
    fp32 image, every value a bf16's.  ``stamps`` as in
    ``cuda_gen2.launch``."""
    size = s0 * 2 ** len(blocks)
    y = torch.empty((z.shape[0], size, size, blocks[-1][1].shape[0]),
                    dtype=torch.float32, device=z.device)
    return run(V1, z, head, blocks, s0, c0, y, stamps)


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
    kinds = layer_kinds(s0, c0, [w.shape[3] for w, _, _ in blocks])
    zb, hb, bb, c0p = kernel_operands(z, head, blocks, s0, c0, kinds)
    y = launch(zb, hb, bb, s0, c0p)
    launches += 1
    return y
