"""Image grid assembly and PNG output (port of ``tpugan/utils/images.py``).

PNG encoding is written out with ``zlib`` (8-bit grayscale or RGB, no
filtering), so the serving path needs no imaging package.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1, 1] float NHWC -> uint8, clipping out-of-range values."""
    x = np.asarray(images, np.float32)
    x = (x + 1.0) * 127.5
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              pad_value: int = 0) -> np.ndarray:
    """Tile (N, H, W, C) uint8 images into one (gh*H', gw*W', C) grid."""
    n, h, w, c = images.shape
    ncol = nrow
    nrows = -(-n // ncol)
    grid = np.full((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   pad_value, np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(array: np.ndarray) -> bytes:
    """PNG-encode a uint8 (H, W), (H, W, 1) or (H, W, 3) array in memory."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {arr.dtype}")
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png takes (H, W[, 1|3]), got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str, array: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(array))
