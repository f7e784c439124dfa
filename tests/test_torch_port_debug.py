"""The port's sanitizers (``tpugan_torch/utils/debug.py``) against the JAX
package's (``tpugan/utils/debug.py``).

``assert_finite``: a NaN or Inf planted in the same numpy-seeded nested
state (dicts, lists, tuples and a namedtuple of float, bfloat16 and
integer leaves) raises ``FloatingPointError`` with the same message in
both packages, naming the same key path: the first bad leaf in
``jax.tree_util``'s order.  ``sanitize``: the same backward (the
gradient of ``sqrt(sum(x ** 2))``, a gradient penalty's norm written out,
0 * inf at x = 0) raises in both packages where it makes a NaN and in
neither where it does not.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.utils import debug as jax_debug
from tpugan_torch.utils import debug

Moments = collections.namedtuple("Moments", "mean var")


def _state(seed=0):
    """A train-state-like nest of numpy leaves."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "step": np.array(3, np.int32),
        "g": {"w": f(4, 3), "b": f(3)},
        "d": {"layers": [f(2, 2), f(5)],
              "bn": Moments(f(5), np.abs(f(5)))},
        "ema": (f(3), f(2, 2).astype(jnp.bfloat16)),
    }


def _put(tree, path, value):
    """``tree`` with ``value`` written at the flat index ``path[-1]`` of the
    leaf at ``path[:-1]``."""
    *keys, i = path
    leaf = tree
    for k in keys:
        leaf = getattr(leaf, k) if isinstance(k, str) and isinstance(
            leaf, tuple) else leaf[k]
    leaf.reshape(-1)[i] = value


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*map(_torch, tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(_torch, tree))
    if tree.dtype == jnp.bfloat16:
        return torch.from_numpy(tree.astype(np.float32)).bfloat16()
    return torch.from_numpy(tree)


PLANTS = [
    [("g", "w", 5)],
    [("d", "layers", 1, 0)],
    [("d", "bn", "var", 2)],
    [("ema", 1, 3)],
    [("g", "w", 0), ("d", "layers", 0, 1)],  # 'd' sorts first
    [("ema", 0, 1), ("g", "b", 2)],
]


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf],
                         ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("plants", PLANTS,
                         ids=lambda ps: "+".join(str(p[:-1]) for p in ps))
def test_assert_finite_names_the_jax_key_path(plants, bad):
    state = _state()
    for path in plants:
        _put(state, path, bad)
    with pytest.raises(FloatingPointError) as want:
        jax_debug.assert_finite(_jax(state), where="at step 3")
    with pytest.raises(FloatingPointError) as got:
        debug.assert_finite(_torch(state), where="at step 3")
    assert str(got.value) == str(want.value)


def test_assert_finite_passes_a_finite_state():
    state = _state()
    jax_debug.assert_finite(_jax(state))
    debug.assert_finite(_torch(state))
    # integer leaves are not checked (no NaN to hold), as in JAX
    debug.assert_finite({"n": torch.tensor([2 ** 31 - 1])})


@pytest.mark.parametrize("zero", [True, False], ids=["nan", "clean"])
def test_sanitize_raises_on_a_nan_backward_as_jax_does(zero):
    x = np.zeros(3, np.float32) if zero else np.arange(1.0, 4.0,
                                                      dtype=np.float32)

    def jax_grad():
        with jax_debug.sanitize(nans=True, leaks=False):
            return np.asarray(jax.grad(
                lambda v: jnp.sqrt(jnp.sum(v ** 2)))(jnp.asarray(x)))

    def port_grad(nans=True):
        xt = torch.from_numpy(x.copy()).requires_grad_()
        with debug.sanitize(nans=nans):
            torch.sqrt(torch.sum(xt ** 2)).backward()
        return xt.grad.numpy()

    if zero:
        with pytest.raises(FloatingPointError):
            jax_grad()
        with pytest.raises(RuntimeError, match="nan"):
            port_grad()
        assert np.isnan(port_grad(nans=False)).all()  # off: no check
    else:
        np.testing.assert_allclose(port_grad(), jax_grad(), rtol=1e-6)
    with pytest.raises(TypeError):  # no tracers, so no leak checking
        debug.sanitize(nans=True, leaks=False)
