"""The input pipeline's host ops in C++ (port of ``tpugan/native``):
``batch_gather`` assembles a batch from the decoded uint8 dataset,
flipping rows where asked, and ``normalize_u8_f32`` maps uint8 to float32
in [-1, 1], each on one thread per 4 MiB of output (at most 8).

The library, ``csrc/imageops.cpp``, is built with ``g++`` at first use
(``ops/_build.load_host``); a failed build raises, there is no quiet
fallback.  ``batch_gather_plain`` and ``normalize_u8_f32_plain`` are the
numpy versions of the same functions, the references of the tests.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from tpugan_torch.ops import _build

_MAX_THREADS = min(8, os.cpu_count() or 1)
# bytes a gather thread is worth: a 1.5 MiB batch (128 images at 64 px)
# took 1.94 ms on 8 threads against numpy's 0.20 on one (NVIDIA H100
# machine's host, chip_smoke.py phase 13)
_BYTES_PER_THREAD = 4 << 20


def _threads(nbytes: int) -> int:
    return max(1, min(_MAX_THREADS, nbytes // _BYTES_PER_THREAD))


def _lib() -> ctypes.CDLL:
    lib = _build.load_host("imageops")
    if lib.tpugan_batch_gather_u8.argtypes is None:
        lib.tpugan_batch_gather_u8.restype = ctypes.c_int
        lib.tpugan_batch_gather_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.tpugan_normalize_u8_f32.restype = ctypes.c_int
        lib.tpugan_normalize_u8_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64]
    return lib


def _checked_index(images: np.ndarray, idx) -> np.ndarray:
    """``idx`` as int64 under numpy's bounds contract: negatives wrap, an
    index out of range raises ``IndexError``."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"batch_gather takes uint8 NHWC images, got "
                         f"{images.dtype} {images.shape}")
    idx = np.ascontiguousarray(idx, np.int64).reshape(-1)
    n_img = images.shape[0]
    if len(idx) and (idx.min() < -n_img or idx.max() >= n_img):
        raise IndexError(
            f"batch_gather index out of range for {n_img} images: "
            f"[{idx.min()}, {idx.max()}]")
    return idx % n_img if len(idx) and idx.min() < 0 else idx


def batch_gather(images: np.ndarray, idx,
                 flip: Optional[np.ndarray] = None) -> np.ndarray:
    """``out[i] = images[idx[i]]``, horizontally flipped where
    ``flip[i]``; ``images`` is C-contiguous uint8 (N, H, W, C)."""
    idx = _checked_index(images, idx)
    if not images.flags.c_contiguous:
        raise ValueError("batch_gather takes a C-contiguous dataset")
    n, (_, h, w, c) = len(idx), images.shape
    out = np.empty((n, h, w, c), np.uint8)
    fptr = None
    if flip is not None:
        flip = np.ascontiguousarray(flip, np.uint8).reshape(-1)
        if len(flip) != n:
            raise ValueError(f"{len(flip)} flip flags for {n} indices")
        fptr = flip.ctypes.data
    rc = _lib().tpugan_batch_gather_u8(
        images.ctypes.data, idx.ctypes.data, fptr, out.ctypes.data,
        n, h, w, c, _threads(out.nbytes))
    if rc != 0:
        raise RuntimeError(f"tpugan_batch_gather_u8 failed rc={rc}")
    return out


def batch_gather_plain(images: np.ndarray, idx,
                       flip: Optional[np.ndarray] = None) -> np.ndarray:
    """``batch_gather`` in numpy (fancy indexing)."""
    out = images[_checked_index(images, idx)]
    if flip is not None:
        sel = np.asarray(flip).reshape(-1).astype(bool)
        out[sel] = out[sel, :, ::-1, :]
    return out


def normalize_u8_f32(x: np.ndarray) -> np.ndarray:
    """uint8 -> float32 ``x / 127.5 - 1`` (IEEE division, as numpy and the
    device compute it)."""
    flat = np.ascontiguousarray(x, np.uint8)
    out = np.empty(flat.shape, np.float32)
    rc = _lib().tpugan_normalize_u8_f32(flat.ctypes.data, out.ctypes.data,
                                        flat.size, _threads(out.nbytes))
    if rc != 0:
        raise RuntimeError(f"tpugan_normalize_u8_f32 failed rc={rc}")
    return out


def normalize_u8_f32_plain(x: np.ndarray) -> np.ndarray:
    """``normalize_u8_f32`` in numpy."""
    return np.asarray(x, np.uint8).astype(np.float32) / np.float32(127.5) - 1.0
