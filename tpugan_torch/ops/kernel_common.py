"""Shared pieces of the kernel family: the transpose-conv tap table and the
activation epilogue, one definition each (port of
``tpugan/ops/kernel_common.py``), and the operand padding the TMA kernels'
wrappers apply.  ``csrc/convt_tile.cuh`` and ``csrc/cuda_convt.cu`` carry
the same table and the same activation codes for the CUDA side.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# ConvTranspose(4, 2, 1) as 4 phase matmuls: output parity d reads kernel
# row k at input offset o, i.e. out[2i+d] += x[i+o] @ w[k].
TAPS = {0: [(1, 0), (3, -1)], 1: [(0, 1), (2, 0)]}

# activation name -> the integer code the CUDA kernels take
ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "tanh": 3}


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


def act(y: torch.Tensor, kind: str, leak: float = 0.2) -> torch.Tensor:
    """Activation epilogue shared by every kernel ('none' = identity)."""
    if kind == "relu":
        return torch.relu(y)
    if kind == "leaky_relu":
        return F.leaky_relu(y, leak)
    if kind == "tanh":
        return torch.tanh(y)
    if kind == "none":
        return y
    raise ValueError(f"unknown act {kind!r}")
