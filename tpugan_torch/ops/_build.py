"""Build and load the CUDA kernels of ``tpugan_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  A library
is built once, at first use, into ``tpugan_torch/_build/`` (listed in
``.gitignore``), under a name that hashes its sources and flags, so an edit
rebuilds it.  ``build_all`` starts one ``nvcc`` per source at once.  The
Hopper kernels (``cuda_convt``, ``cuda_conv_stats``) include
``csrc/igemm_sm90.cuh``; it needs no library beyond the CUDA runtime (the
TMA tensor maps are encoded through the runtime's driver entry point).

Nothing here runs at import: the CPU tests import every module, and a
machine without a CUDA toolkit has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("cuda_convt", "cuda_gen", "cuda_gen2", "cuda_conv",
           "cuda_conv_stats")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "on this machine")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path, float] | None:
    path = _lib_path(name)
    if path.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path, time.time()


def _finish(name: str, job) -> tuple[float, str]:
    if job is None:
        return 0.0, ""
    proc, tmp, path, t0 = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, path)
    return time.time() - t0, out


def build_all() -> dict[str, tuple[float, str]]:
    """Build every kernel library, one nvcc per source in parallel; returns
    each build's (seconds from the start, compiler output: registers, shared
    memory, spills); (0, "") for a library already built."""
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        if name not in _LIBS:
            _finish(name, _start(name))
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return _LIBS[name]


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        import torch

        raise RuntimeError(f"{what}: CUDA error {rc} at launch "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr(device: int) -> int:
    """The raw handle of the current stream on CUDA device ``device``: the
    call PyTorch's own generated launchers make, without the Stream object
    that ``torch.cuda.current_stream()`` builds (several microseconds of
    host time a launch)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device)
