"""The port's spectral norm (``tpugan_torch/nn/spectral_norm.py``) against
``tpugan.nn.spectral_norm.SpectralNorm``, on a Conv and on a Dense (the
tail's 1-column weight and a wider one), in fp32, from the same weights and
``u``: sigma, the new ``u`` and the output of a training forward; the eval
forward, which leaves ``u`` as it was; the weight gradient; a double
backward (the WGAN-GP case); and two training forwards then one backward.

Tolerances: sigma and ``u`` come from a few fp32 matrix-vector products and
norms, ~1e-7 relative apart; outputs and gradients are fp32 sums in another
order, whose entries cancel down to far below the largest: 1e-5 relative
plus 2e-6 of the result's largest entry (through w / sigma, with sigma
~0.1, a gradient's entries run to O(100)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import to_numpy
from tpugan.nn.layers import Conv as JaxConv, Dense as JaxDense
from tpugan.nn.spectral_norm import SpectralNorm
from tpugan_torch.ckpt.from_jax import load_jax_module
from tpugan_torch.nn.spectral_norm import SNConv, SNDense, spectral_sigma

# (kind, layer args, input shape)
LAYERS = [("conv", (3, 8), (2, 8, 8, 3)),
          ("dense_tail", (48, 1), (4, 48)),
          ("dense", (48, 6), (4, 48))]
IDS = [k for k, _, _ in LAYERS]


def _twin(kind, args, seed=0):
    """(jax SpectralNorm, params, state, port layer) with JAX's weights and
    u carried across by name."""
    if kind == "conv":
        jl = SpectralNorm(JaxConv(*args, dtype=jnp.float32))
        pl = SNConv(*args, dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
    else:
        jl = SpectralNorm(JaxDense(*args, dtype=jnp.float32))
        pl = SNDense(*args, dtype=torch.float32, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    params, state = jl.init(jax.random.PRNGKey(seed))
    # a bias that is not zero, so that the output checks it too
    params = dict(params, b=jax.random.normal(jax.random.PRNGKey(seed + 1),
                                              params["b"].shape) * 0.1)
    load_jax_module(pl, to_numpy(params), to_numpy(state))
    return jl, params, state, pl


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                               atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize("kind,args,shape", LAYERS, ids=IDS)
def test_training_forward_matches_jax(rng, kind, args, shape):
    jl, params, state, pl = _twin(kind, args)
    x = _x(rng, shape)
    sigma_ref, u_ref = jl._sigma(params["w"], state["u"], 1)
    sigma, u = spectral_sigma(pl.w, pl.u, 1)
    np.testing.assert_allclose(sigma.item(), float(sigma_ref), rtol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-6,
                               atol=1e-7)
    ref, new_state = jl.apply(params, state, jnp.asarray(x), train=True)
    pl.train()
    got = pl(torch.from_numpy(x))
    _close(got.detach(), ref)
    np.testing.assert_allclose(pl.u.numpy(), np.asarray(new_state["u"]),
                               rtol=1e-6, atol=1e-7)
    assert abs(np.linalg.norm(pl.u.numpy()) - 1.0) < 1e-6


@pytest.mark.parametrize("kind,args,shape", LAYERS, ids=IDS)
def test_eval_forward_keeps_u(rng, kind, args, shape):
    jl, params, state, pl = _twin(kind, args)
    # a u that is not yet the top singular vector, so that an iteration
    # in eval would show in sigma
    x = _x(rng, shape)
    ref, new_state = jl.apply(params, state, jnp.asarray(x), train=False)
    u_before = pl.u.clone()
    with torch.no_grad():
        got = pl.eval()(torch.from_numpy(x))
    _close(got, ref)
    assert torch.equal(pl.u, u_before)
    np.testing.assert_array_equal(np.asarray(new_state["u"]),
                                  np.asarray(state["u"]))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind,args,shape", LAYERS, ids=IDS)
def test_weight_gradient_matches_jax(rng, kind, args, shape, train):
    jl, params, state, pl = _twin(kind, args)
    x = _x(rng, shape)

    def loss(p):
        y, _ = jl.apply(p, state, jnp.asarray(x), train=train)
        return jnp.sum(jnp.square(y))

    grads = jax.grad(loss)(params)
    pl.train(train)
    pl(torch.from_numpy(x)).square().sum().backward()
    for k in ("w", "b"):
        _close(getattr(pl, k).grad, grads[k])


@pytest.mark.parametrize("kind,args,shape", LAYERS, ids=IDS)
def test_double_backward_matches_jax(rng, kind, args, shape):
    """d/dw of |d/dx sum(y^2)|^2 through the eval-mode layer, as the
    gradient penalty differentiates D."""
    jl, params, state, pl = _twin(kind, args)
    x = _x(rng, shape)

    def penalty(p):
        gx = jax.grad(lambda xx: jnp.sum(jnp.square(
            jl.apply(p, state, xx, train=False)[0])))(jnp.asarray(x))
        return jnp.sum(jnp.square(gx))

    grads = jax.grad(penalty)(params)
    pl.eval()
    xt = torch.from_numpy(x).requires_grad_()
    gx, = torch.autograd.grad(pl(xt).square().sum(), xt, create_graph=True)
    gx.square().sum().backward()
    for k in ("w", "b"):
        _close(getattr(pl, k).grad, grads[k])


@pytest.mark.parametrize("kind,args,shape", LAYERS, ids=IDS)
def test_two_training_forwards_then_one_backward(rng, kind, args, shape):
    """The D step's order: real then fake forward (u advanced by each), one
    backward.  The graph keeps its own copies of u, so the in-place update
    of the buffer between the forwards breaks nothing."""
    jl, params, state, pl = _twin(kind, args)
    x1, x2 = _x(rng, shape), _x(rng, shape)

    def loss(p):
        y1, s1 = jl.apply(p, state, jnp.asarray(x1), train=True)
        y2, s2 = jl.apply(p, s1, jnp.asarray(x2), train=True)
        return jnp.sum(y1) - jnp.sum(jnp.square(y2)), s2

    grads, new_state = jax.grad(loss, has_aux=True)(params)
    pl.train()
    y1 = pl(torch.from_numpy(x1))
    y2 = pl(torch.from_numpy(x2))
    (y1.sum() - y2.square().sum()).backward()
    for k in ("w", "b"):
        _close(getattr(pl, k).grad, grads[k])
    np.testing.assert_allclose(pl.u.numpy(), np.asarray(new_state["u"]),
                               rtol=1e-6, atol=1e-7)
