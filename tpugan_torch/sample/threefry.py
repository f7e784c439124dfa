"""The JAX random draws the sampler's determinism contract rests on, in
numpy: ``threefry2x32``, ``PRNGKey``, ``fold_in``, ``split``, ``uniform``,
``bernoulli``, ``normal``, ``truncated_normal``, ``randint`` and
``permutation``, as JAX 0.9 computes them with
``jax_threefry_partitionable=True`` (``jax/_src/prng.py``,
``jax/_src/random.py``).  Integer draws, permutations, uniform bits and
bernoulli draws are bit-exact; normal draws run XLA's float32
``erf_inv`` polynomial on those bits and differ from JAX on the CPU by at
most 3 ulps (on ~5% of the values): XLA takes its own float32 ``log1p``
there and fuses the polynomial's multiply-adds, numpy rounds each one
(``tests/test_torch_port_draws.py`` holds it over every uniform).

A key is a ``(..., 2)`` uint32 array; every function broadcasts over the
leading axes, so n per-index keys draw in one vectorized call.
"""

from __future__ import annotations

import math

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2 = np.float32(np.sqrt(2.0))


def _rotl(x, d: int):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counts (x1, x2) under key
    (k1, k2); all uint32 arrays, broadcast together."""
    k1, k2, x1, x2 = (np.asarray(v, np.uint32) for v in (k1, k2, x1, x2))
    k1, k2, x1, x2 = np.broadcast_arrays(k1, k2, x1, x2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [x1 + ks[0], x2 + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed mod 2^32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the count (0, data)."""
    key = np.asarray(key, np.uint32)
    data = np.asarray(data, np.int64).astype(np.uint32)
    a, b = threefry2x32(key[..., 0], key[..., 1], np.uint32(0), data)
    return np.stack([a, b], axis=-1)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (fold-like under partitionable threefry):
    (..., num, 2) keys."""
    key = np.asarray(key, np.uint32)[..., None, :]
    a, b = threefry2x32(key[..., 0], key[..., 1], np.uint32(0),
                        np.arange(num, dtype=np.uint32))
    return np.stack([a, b], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (per key): the hash of the
    element's flat index as a 64-bit count, halves xor-ed."""
    key = np.asarray(key, np.uint32)
    size = int(np.prod(shape))
    lead = key.shape[:-1]
    kk = key.reshape(lead + (1,) * len(shape) + (2,))
    idx = np.arange(size, dtype=np.uint64).reshape(shape)
    a, b = threefry2x32(kk[..., 0], kk[..., 1],
                        (idx >> np.uint64(32)).astype(np.uint32),
                        idx.astype(np.uint32))
    return a ^ b


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` float32 in [minval, maxval)."""
    bits = random_bits(key, shape)
    fbits = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = fbits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


def bernoulli(key, p, shape) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for a float32 ``p``:
    ``uniform(key, shape) < p``, bool."""
    return uniform(key, shape) < np.float32(p)


# XLA's float32 erf_inv: M. Giles, "Approximating the erfinv function",
# a degree-8 polynomial in w = -log1p(-x^2) (shifted), split at w = 5.
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)


def _erfinv(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for i in range(1, 9):
        p = (np.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]) + p * w
             ).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x
                    ).astype(np.float32)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal`` float32: sqrt(2) * erfinv(U(nextafter(-1, 0), 1))."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (_SQRT2 * _erfinv(u)).astype(np.float32)


def truncated_normal(key, lower: float, upper: float, shape) -> np.ndarray:
    """``jax.random.truncated_normal`` float32 on (lower, upper)."""
    lower, upper = np.float32(lower), np.float32(upper)
    erf = lambda v: np.float32(math.erf(float(v / _SQRT2)))  # noqa: E731
    u = uniform(key, shape, erf(lower), erf(upper))
    out = (_SQRT2 * _erfinv(u)).astype(np.float32)
    return np.clip(out, np.nextafter(lower, np.float32(np.inf)),
                   np.nextafter(upper, np.float32(-np.inf)))


def randint(key, minval: int, maxval: int, shape=()) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` int32, per key:
    (*key's leading axes, *shape)."""
    keys = split(key, 2)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = np.uint32(max(maxval - minval, 1))
    with np.errstate(over="ignore"):
        mult = np.uint32((2 ** 16) % span)
        mult = np.uint32((mult * mult) % span)
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` for an int n: int32 (n,).  JAX
    sorts ``arange(n)`` by fresh 32-bit random bits, stably, in
    ``ceil(3 ln n / ln(2^32 - 1))`` rounds, splitting the key before each
    (``jax/_src/random.py``, ``_shuffle``)."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key, 2)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x
