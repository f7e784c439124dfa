"""Convolution ops (NHWC activations, HWIO weights) with switchable
implementations (port of ``tpugan/ops/convs.py``).

``conv2d`` is a strided conv; ``conv_transpose2d`` has reference
``ConvTranspose2d(k, s, p)`` semantics, ``out = (in - 1) * s - 2p + k``,
with unflipped HWIO weights.  impl "xla" leaves each to PyTorch's own
``F.conv2d`` / ``F.conv_transpose2d`` (as the JAX package leaves them to
XLA); impl "pallas" runs the hand-written kernels of ``ops/cuda_conv.py`` /
``ops/cuda_convt.py`` (their plain versions for a CPU tensor).  Unlike the
JAX package there is no quiet fallback: "pallas" on a shape a kernel does
not take raises.  The kernels are forward-only, so the train step runs its
forwards under ``using_impl("xla")``, whatever the default is.

Ahead of the impl, both ops consult the spatial context
(``parallel/spatial.py``), as the JAX package's do: a qualifying conv runs
sharded with a halo exchange, and a map the context shards but this conv
does not is gathered whole first.
"""

from __future__ import annotations

import contextlib

import torch.nn.functional as F

IMPLS = ("xla", "pallas")

_DEFAULT_IMPL = "xla"


def set_default_impl(impl: str) -> None:
    """Set the process-wide default kernel backend ("xla" | "pallas")."""
    global _DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"unknown ops impl {impl!r}")
    _DEFAULT_IMPL = impl


@contextlib.contextmanager
def using_impl(impl: str):
    """The default impl is ``impl`` inside the block, and what it was
    before after it."""
    global _DEFAULT_IMPL
    prev = _DEFAULT_IMPL
    set_default_impl(impl)
    try:
        yield
    finally:
        _DEFAULT_IMPL = prev


def resolve_impl(impl: str | None) -> str:
    impl = _DEFAULT_IMPL if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown ops impl {impl!r}")
    return impl


def conv2d(x, w, *, stride: int, padding: int, impl: str | None = None):
    """Strided conv: x (N, H, W, Cin), w (kh, kw, Cin, Cout); returns
    (N, H', W', Cout) in x's dtype."""
    from tpugan_torch.parallel import spatial

    y = spatial.maybe_spatial_conv2d(x, w, stride=stride, padding=padding)
    if y is not None:
        return y
    x = spatial.replicated(x)
    if resolve_impl(impl) == "pallas":
        if stride != 2 or padding != 1 or tuple(w.shape[:2]) != (4, 4):
            raise ValueError(
                f"the conv kernel takes k=4, s=2, p=1 only; got "
                f"k={tuple(w.shape[:2])}, s={stride}, p={padding}")
        from tpugan_torch.ops import cuda_conv

        return cuda_conv.conv2d(x, w).to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose2d(x, w, *, stride: int, padding: int,
                     impl: str | None = None):
    """Transpose conv: x (N, H, W, Cin), w (k, k, Cin, Cout) unflipped;
    returns (N, H', W', Cout) in x's dtype, H' = (H-1)*stride - 2*padding + k.
    """
    from tpugan_torch.parallel import spatial

    k = w.shape[0]
    if k - 1 - padding < 0:
        raise ValueError("require kernel - 1 - padding >= 0")
    y = spatial.maybe_spatial_conv_transpose2d(x, w, stride=stride,
                                               padding=padding)
    if y is not None:
        return y
    x = spatial.replicated(x)
    if resolve_impl(impl) == "pallas":
        if stride != 2 or padding != 1 or tuple(w.shape[:2]) != (4, 4):
            raise ValueError(
                f"the ConvT kernel takes k=4, s=2, p=1 only; got "
                f"k={tuple(w.shape[:2])}, s={stride}, p={padding}")
        from tpugan_torch.ops import cuda_convt

        return cuda_convt.conv_transpose2d(x, w).to(x.dtype)
    # torch's ConvTranspose2d weight (Cin, Cout, kh, kw) is the HWIO weight
    # transposed, with no flip: both are the adjoint of the strided conv.
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1),
                           stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()
