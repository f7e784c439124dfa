"""Shared pieces of the kernel family: the transpose-conv tap table and the
activation epilogue, one definition each (port of
``tpugan/ops/kernel_common.py``), and the operand padding the TMA kernels'
wrappers apply.  ``csrc/convt_sm90.cuh`` carries the same table, and
``csrc/igemm_sm90.cuh`` the same activation codes, for the CUDA side.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# ConvTranspose(4, 2, 1) as 4 phase matmuls: output parity d reads kernel
# row k at input offset o, i.e. out[2i+d] += x[i+o] @ w[k].
TAPS = {0: [(1, 0), (3, -1)], 1: [(0, 1), (2, 0)]}

# activation name -> the integer code the CUDA kernels take
ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}

# the operand dtypes of the conv kernels (1, 4, 5), as the TPU kernels take
# them: products in the operands' dtype, sums in fp32
OPERAND_DTYPES = (torch.bfloat16, torch.float32)


# fp32 operands of kernels 1 and 5 take the three-pass TF32 route on the
# Hopper mainloop where Cin is a multiple of TF32_CIN (32 fp32 channels
# fill a stage's 128-byte row), and the FFMA mainloop (csrc/igemm_f32.cuh)
# elsewhere: the narrow fp32 path.
TF32_CIN = 32


def f32_route(cin: int) -> str:
    """The route of kernels 1 and 5 on fp32 operands with ``cin`` input
    channels, decided before the launch: "tf32" (three TF32 passes over
    split operands on the tensor cores) or "ffma" (the CUDA cores).  A
    route's failed launch raises; nothing falls back to the other."""
    return "tf32" if cin % TF32_CIN == 0 else "ffma"


def check_operands(x, w, out_dtype, *others) -> None:
    """The conv kernels' operand contract, on every device (the plain
    versions keep it too): x and w of one dtype, bf16 or fp32; out bf16 or
    fp32; every operand on x's device.  Raises ``ValueError``."""
    if x.dtype not in OPERAND_DTYPES or w.dtype != x.dtype:
        raise ValueError(f"the conv kernels take x and w of one dtype, bf16 "
                         f"or fp32, got {x.dtype} and {w.dtype}")
    if out_dtype not in OPERAND_DTYPES:
        raise ValueError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    for t in (w, *others):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got "
                             f"{t.device}")


def round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pad_dim(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-padded at the end of ``dim`` to ``size`` (itself if it is
    that size already)."""
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 1 - dim) + (0, extra))


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data is off 16-byte alignment (TMA
    takes 16-byte-aligned bases only)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def leaky_relu(y: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    """JAX's ``leaky_relu``: ``where(y >= 0, y, leak * y)``.  The values
    are ``F.leaky_relu``'s; the derivative at exactly 0 is JAX's 1, where
    PyTorch's is ``leak`` (an augmentation's zeroed or zero-padded pixels
    make exact zeros in a layer with a zero bias).  Where no gradient is
    taken it is ``F.leaky_relu``, one op for three, the same bits (-0.0 and
    NaN included)."""
    if not (y.requires_grad and torch.is_grad_enabled()):
        return F.leaky_relu(y, leak)
    return torch.where(y >= 0, y, y * leak)


def act(y: torch.Tensor, kind: str, leak: float = 0.2) -> torch.Tensor:
    """Activation epilogue shared by every kernel ('none' = identity)."""
    if kind == "relu":
        return torch.relu(y)
    if kind == "leaky_relu":
        return leaky_relu(y, leak)
    if kind == "tanh":
        return torch.tanh(y)
    if kind == "none":
        return y
    raise ValueError(f"unknown act {kind!r}")
