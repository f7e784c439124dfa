"""The draws of ``ops/cuda_threefry.py`` on the CPU, and the bounds its
card tests hold ``normal`` to.

On the CPU each draw is ``sample/threefry.py``'s, as a tensor of the
documented dtype, and no kernel library is loaded.  The kernel's
``normal`` takes log1p in double, rounded once to float32
(``normal_exact_log1p`` is that formula in numpy); numpy's float32 log1p
is an ulp off that on some inputs (SIMD builds), and over every uniform
value the normal can take, an ulp of log1p moves the normal by at most
three ulps: the tolerance of ``tests/test_torch_port_cuda_draws.py``
against the host's own draw.  JAX's normal on the CPU, the reference of
both, is neither formula: XLA takes its own float32 log1p and fuses the
polynomial's multiply-adds; over every uniform it lies within three ulps
of each.  ``data/jax_normal_draw.npy`` is JAX's draw of ``JAX_KEY`` at the
flagship's latents' shape, which the card tests hold the kernel to; JAX is
imported inside the test that checks it, so the card tests import this
file without JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpugan_torch.ops import _build, cuda_threefry
from tpugan_torch.sample import threefry

KEY = np.array([0xFFFFFFFF, 0x80000001], np.uint32)
JAX_KEY = np.array([0x9E3779B9, 0xDEADBEEF], np.uint32)
JAX_DRAW = Path(__file__).resolve().parent / "data" / "jax_normal_draw.npy"
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def _normal_of(x, w):
    """threefry's normal from its uniform x and w = -log1p(-x^2)."""
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, threefry._ERFINV_LT5[0], threefry._ERFINV_GE5[0])
    for i in range(1, 9):
        p = (np.where(lt, threefry._ERFINV_LT5[i], threefry._ERFINV_GE5[i])
             + p * w).astype(np.float32)
    return (threefry._SQRT2 * (p * x).astype(np.float32)).astype(np.float32)


def _exact_w(x):
    return -np.log1p((-x * x).astype(np.float64)).astype(np.float32)


def normal_exact_log1p(key, shape):
    """``threefry.normal`` with log1p taken in double and rounded once to
    float32, as the kernel takes it; every other step is threefry.py's."""
    x = threefry.uniform(key, shape, _LO, 1.0)
    return _normal_of(x, _exact_w(x))


def ulps(a, b):
    """The distance of float32 arrays a and b in units in the last place
    (ordered bit patterns)."""
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


C, T = cuda_threefry, threefry
# (a draw on a device, the host's draw, its dtype)
DRAWS = {
    "bernoulli": (lambda dev: C.bernoulli(KEY, 0.5, (6, 1, 1, 1), dev),
                  lambda: T.uniform(KEY, (6, 1, 1, 1)) < 0.5, np.bool_),
    "bernoulli_p": (lambda dev: C.bernoulli(KEY, 0.3, (9,), dev),
                    lambda: T.uniform(KEY, (9,)) < np.float32(0.3),
                    np.bool_),
    "randint": (lambda dev: C.randint(KEY, 0, 202599, (7,), dev),
                lambda: T.randint(KEY, 0, 202599, (7,)).astype(np.int64),
                np.int64),
    "randint_labels": (lambda dev: C.randint(KEY, 0, 2, (3, 5), dev),
                       lambda: T.randint(KEY, 0, 2, (3, 5)).astype(np.int64),
                       np.int64),
    "normal": (lambda dev: C.normal(KEY, (4, 3), dev),
               lambda: T.normal(KEY, (4, 3)), np.float32),
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_cpu_draw_is_the_host_draw_without_a_library(name, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel library was loaded on the CPU")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(cuda_threefry, "_lib", refuse)
    before = cuda_threefry.launches
    draw, ref, dtype = DRAWS[name]
    for dev in ("cpu", torch.device("cpu")):
        got = draw(dev)
        assert got.device.type == "cpu" and got.numpy().dtype == dtype
        np.testing.assert_array_equal(got.numpy(), ref())
    assert cuda_threefry.launches == before


def test_a_cuda_draw_is_refused_off_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_threefry.normal(KEY, (2,), "meta")


def test_an_ulp_of_log1p_moves_the_normal_at_most_three_ulps():
    """Every uniform the normal can take (2^23 mantissas), w from a
    correctly rounded log1p and w an ulp off either way; and threefry's
    own normal against the kernel's formula, the same at most."""
    worst_w = worst_host = 0
    for start in range(0, 2 ** 23, 2 ** 21):
        x = _uniforms(start, start + 2 ** 21)
        w = _exact_w(x)
        exact = _normal_of(x, w)
        for toward in (-np.inf, np.inf):
            off = _normal_of(x, np.nextafter(w, np.float32(toward)))
            worst_w = max(worst_w, int(ulps(off, exact).max()))
        host = _normal_of(x, -np.log1p(-x * x))
        worst_host = max(worst_host, int(ulps(host, exact).max()))
    assert worst_w <= 3 and worst_host <= 3, (worst_w, worst_host)
    # and the formula is threefry's where log1p agrees
    x = threefry.uniform(KEY, (4096,), _LO, 1.0)
    same = _exact_w(x) == -np.log1p(-x * x)
    np.testing.assert_array_equal(
        normal_exact_log1p(KEY, (4096,))[same],
        threefry.normal(KEY, (4096,))[same])


def _uniforms(start, stop):
    """Every uniform the normal can take, mantissas ``start`` to ``stop``."""
    m = np.arange(start, stop, dtype=np.uint32)
    f = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(_LO, f * (np.float32(1.0) - _LO) + _LO).astype(
        np.float32)


def test_jax_normal_lies_within_three_ulps_of_both_formulas():
    """JAX's normal on the CPU over every uniform value, against the
    kernel's formula (log1p correctly rounded) and threefry.py's (numpy's
    log1p): at most three ulps from each, and not bit for bit either; and
    the saved draw is JAX's."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    key = jnp.asarray(JAX_KEY)
    # jax.random.normal is sqrt(2) * erf_inv of its uniform, in one jit
    sqrt2_erfinv = jax.jit(lambda u: jnp.float32(np.sqrt(2.0))
                           * lax.erf_inv(u))
    u = jax.random.uniform(key, (1024, 100), jnp.float32, _LO, 1.0)
    drawn = np.asarray(jax.random.normal(key, (1024, 100), jnp.float32))
    np.testing.assert_array_equal(np.asarray(sqrt2_erfinv(u)).view(np.int32),
                                  drawn.view(np.int32))
    np.testing.assert_array_equal(np.load(JAX_DRAW).view(np.int32),
                                  drawn.view(np.int32))
    worst, differ = {"kernel": 0, "host": 0}, {"kernel": 0, "host": 0}
    for start in range(0, 2 ** 23, 2 ** 21):
        x = _uniforms(start, start + 2 ** 21)
        jx = np.asarray(sqrt2_erfinv(x))
        for name, w in (("kernel", _exact_w(x)),
                        ("host", -np.log1p(-x * x))):
            d = ulps(jx, _normal_of(x, w))
            worst[name] = max(worst[name], int(d.max()))
            differ[name] += int((d > 0).sum())
    assert all(v <= 3 for v in worst.values()), worst
    assert all(v > 0 for v in differ.values()), differ
