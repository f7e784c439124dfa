"""The train step's threefry draws made on the card (kernel in
``csrc/cuda_threefry.cu``; no TPU kernel: the JAX step draws on its
device inside the jitted step).

Each function here is the draw of ``sample/threefry.py`` of the same name
from a host key (a ``(2,)`` uint32 array), as a tensor on ``device``: the
three the train step makes.

- ``bernoulli``: bool;
- ``randint``: int64 (threefry's int32 values, widened as the step
  indexes with them);
- ``normal``: float32.

On a CUDA device each is one launch into a ``torch.empty`` tensor on the
current stream, the key's two words passed as launch arguments: nothing is
copied and the host does not wait.  ``bernoulli`` and ``randint`` are
threefry.py's bits; ``normal`` rounds log1p once from double, where
numpy's float32 log1p may be off by an ulp, so it may differ from the
host's draw by the few ulps (at most 3) that the erf_inv polynomial makes
of that; JAX's own draw on the CPU lies within 3 ulps of both.  Each
launch counts ``device_draws`` and ``device_draws_bytes``
(``utils/tracing.py``).  On the CPU each is the host draw itself
(``torch.from_numpy``): neither the kernel nor its library is touched.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpugan_torch.ops import _build
from tpugan_torch.sample import threefry
from tpugan_torch.utils import tracing

# Kernel launches made here (CUDA devices only).
launches = 0


def _lib():
    lib = _build.load("cuda_threefry")
    if lib.tg_threefry_normal.argtypes is None:
        p, u, n, f = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_longlong,
                      ctypes.c_float)
        lib.tg_threefry_bernoulli.argtypes = [u, u, n, f, p, p]
        lib.tg_threefry_randint.argtypes = [u, u, n, n, u, p, p]
        lib.tg_threefry_normal.argtypes = [u, u, n, p, p]
        for fn in (lib.tg_threefry_bernoulli, lib.tg_threefry_randint,
                   lib.tg_threefry_normal):
            fn.restype = ctypes.c_int
    return lib


def _draw(name, key, shape, dtype, device, *args):
    """One launch of ``tg_threefry_<name>`` filling a new ``shape`` tensor
    of ``dtype`` on the CUDA ``device``."""
    global launches
    if device.type != "cuda":
        raise ValueError(f"the threefry kernel draws on a CUDA device, not "
                         f"{device}")
    key = np.asarray(key, np.uint32)
    if key.shape != (2,):
        raise ValueError(f"one key of shape (2,), got {key.shape}")
    out = torch.empty(shape, dtype=dtype, device=device)
    fn = getattr(_lib(), "tg_threefry_" + name)
    with torch.cuda.device(device):
        rc = fn(int(key[0]), int(key[1]), out.numel(), *args, out.data_ptr(),
                _build.stream_ptr(device.index))
    _build.check(rc, f"threefry {name}")
    launches += 1
    tracing.count("device_draws")
    tracing.count("device_draws_bytes", out.numel() * out.element_size())
    return out


def bernoulli(key, p, shape, device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(threefry.bernoulli(key, p, shape))
    return _draw("bernoulli", key, shape, torch.bool, device,
                 float(np.float32(p)))


def randint(key, minval: int, maxval: int, shape, device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(threefry.randint(key, minval, maxval, shape)
                                .astype(np.int64))
    span = max(maxval - minval, 1)
    if not (-2 ** 31 <= minval and span < 2 ** 32):
        raise ValueError(f"randint over [{minval}, {maxval}) does not fit "
                         f"threefry's int32 draw")
    return _draw("randint", key, shape, torch.int64, device, int(minval),
                 span)


def normal(key, shape, device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(threefry.normal(key, shape))
    return _draw("normal", key, shape, torch.float32, device)
