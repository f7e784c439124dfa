"""Whole eval-mode generator in one kernel launch, phase-separated layout
between layers: megakernel v2 (port of ``tpugan/ops/pallas_gen2.py``; kernel
in ``csrc/cuda_gen2.cu``).

Activations stay in a phase-separated layout

    X_l : (P, P, N, base, base, C_l)      P = 2^l

whose base grid is frozen at the head's s0 x s0 (4, or 7 at 28 px): each
ConvT(4,2,1) doubles the phase axes instead of the spatial ones, and the
full-resolution coordinate is h = b * P + o.  The one depth-to-space runs
outside the kernel (``depth_to_space``).  Between layers the activations
are fp32 rounded to bf16 as matmul operands, and the final image is fp32
unrounded, as in the Pallas kernel.

Conditional generators fold the label embedding into z outside the kernel:
z <- concat(z, embed[y]) feeds the inner generator's (nz + embed_dim)-wide
dense head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpugan_torch.ops.cuda_gen import check_folded, fold_generator, head_plain
from tpugan_torch.ops.cuda_gen import launch as _launch
from tpugan_torch.ops.kernel_common import TAPS, act as _act

# Kernel launches made by ``generator_forward`` (CUDA tensors only).
launches = 0


def _shift_phase(xp, c: int, axis_phase: int, axis_base: int, base: int):
    """Tap input: phase o + c of the halo-padded stack ``xp``; a phase index
    stepping outside [0, P) wraps into the +-1 base cell."""

    def win(s):  # base window shifted by s: indices [1+s, 1+s+base)
        return xp.narrow(axis_base, 1 + s, base)

    if c == 0:
        return win(0)
    p = xp.shape[axis_phase]
    if p == 1:
        return win(c)
    if c == 1:
        # phases 1..P-1 from window 0; phase P wraps to phase 0, base +1
        return torch.cat([win(0).narrow(axis_phase, 1, p - 1),
                          win(1).narrow(axis_phase, 0, 1)], dim=axis_phase)
    # c == -1: phase -1 wraps to phase P-1, base -1
    return torch.cat([win(-1).narrow(axis_phase, p - 1, 1),
                      win(0).narrow(axis_phase, 0, p - 1)], dim=axis_phase)


def _pad_base(x):
    """Zero halo on the two base-grid axes (3, 4) of (P, P, N, b, b, C)."""
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def _convt_block_phase(x, w, a, b, act: str):
    """One ConvT(4,2,1) + affine + act in phase space:
    (P, P, N, base, base, Cin) fp32 -> (2P, 2P, N, base, base, Cout)."""
    ph, pw, n, base = x.shape[:4]
    cin, cout = x.shape[-1], w.shape[-1]
    xp = _pad_base(x)
    m = ph * pw * n * base * base
    wb = w.to(torch.bfloat16).float()
    rows = []
    for dh in (0, 1):
        cols = []
        for dw in (0, 1):
            acc = torch.zeros((m, cout), dtype=torch.float32, device=x.device)
            for kh, ch in TAPS[dh]:
                xh = _shift_phase(xp, ch, axis_phase=0, axis_base=3, base=base)
                for kw, cw in TAPS[dw]:
                    xs = _shift_phase(xh, cw, axis_phase=1, axis_base=4,
                                      base=base)
                    xs = xs.reshape(m, cin).to(torch.bfloat16).float()
                    acc = acc + xs @ wb[kh, kw]
            y = _act(acc * a + b, act)
            cols.append(y.reshape(ph, pw, n, base, base, cout))
        # out phase 2*ow + dw along axis 1
        rows.append(torch.stack(cols, dim=2).reshape(
            ph, 2 * pw, n, base, base, cout))
    return torch.stack(rows, dim=1).reshape(2 * ph, 2 * pw, n, base, base, cout)


def generator_forward_plain(z, head, blocks, s0, c0):
    """The plain PyTorch version of the v2 kernel: the phase-space forward,
    returning the phased (P, P, N, base, base, C) fp32 output."""
    x = head_plain(z, head, s0, c0).reshape(1, 1, z.shape[0], s0, s0, c0)
    for i, (w, a, b) in enumerate(blocks):
        x = _convt_block_phase(x, w, a, b,
                               "tanh" if i == len(blocks) - 1 else "relu")
    return x


def depth_to_space(phased):
    """(P, P, N, base, base, C) -> (N, base*P, base*P, C): spatial position
    is (base, phase) major/minor."""
    p, _, n, base, _, c = phased.shape
    return phased.permute(2, 3, 0, 4, 1, 5).reshape(n, base * p, base * p, c)


def fold_inputs(g, z, y=None, eps: float = 1e-5):
    """(folded head, blocks, (s0, c0), z') for ``g``; a conditional
    generator's embedding folds into z' = concat(z, embed[y])."""
    if hasattr(g, "embed"):
        if y is None:
            raise ValueError("conditional generator: labels y required")
        y = torch.as_tensor(y, device=z.device)
        if y.shape != (z.shape[0],):
            raise ValueError(f"labels must be ({z.shape[0]},), got "
                             f"{tuple(y.shape)}")
        if int(y.min()) < 0 or int(y.max()) >= g.n_classes:
            raise ValueError(f"labels out of range [0, {g.n_classes})")
        e = g.embed.table.detach()[y]
        z = torch.cat([z.float(), e.float()], dim=-1)
        g = g.g
    elif y is not None:
        raise ValueError("unconditional generator: labels not accepted")
    head, blocks, (s0, c0) = fold_generator(g, eps)
    return head, blocks, (s0, c0), z


def generator_forward(g, z, y=None, *, eps: float = 1e-5):
    """Run an eval-mode ``Generator`` or ``CondGenerator`` (with labels y)
    as one kernel launch: z (N, nz) -> images (N, S, S, C) fp32.  The plain
    version for a CPU z."""
    global launches
    head, blocks, (s0, c0), z = fold_inputs(g, z, y, eps)
    check_folded(z, head, blocks, s0, c0)
    if z.device.type == "cpu":
        return depth_to_space(generator_forward_plain(z, head, blocks, s0, c0))
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    p = 2 ** len(blocks)
    phased = _launch("cuda_gen2", "tg_gen2_forward", z, head, blocks, s0, c0,
                     (p, p, z.shape[0], s0, s0, blocks[-1][0].shape[3]))
    launches += 1
    return depth_to_space(phased)
