"""The port's WGAN-GP gradient penalty (``losses/gradient_penalty.py``)
against ``tpugan.losses.gradient_penalty``, in fp32, through the eval-mode
discriminator of ``wgan_gp_cifar10`` (no BN) and of ``sngan_cifar10``
(spectral norm), from the same weights: the penalty with the interpolation
weights given (the parity hook) and drawn from a threefry key, the
gradients of lambda * gp with respect to D's parameters (a double
backward), and the train step's penalty under the "pallas" impl, which must
still run on PyTorch's ops.

Tolerances: the penalty is a mean of squared per-sample gradient norms, each
an fp32 sum over a backward in another order: 1e-5 relative.  Its
parameter gradients come from a second backward through the same layers,
with entries that cancel far below the largest: 1e-4 relative plus 1e-5 of
the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import to_numpy, twin_train_states
from tpugan.configs import get_preset
from tpugan.data.datasets import make_synthetic
from tpugan.losses.gradient_penalty import gradient_penalty as jax_gp
from tpugan.models import build_models
from tpugan_torch.ckpt.from_jax import flatten, load_jax_module
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.losses.gradient_penalty import gradient_penalty
from tpugan_torch.models.registry import build_discriminator
from tpugan_torch.ops import convs, cuda_conv
from tpugan_torch.train.steps import build_train_step

PRESETS = ["wgan_gp_cifar10", "sngan_cifar10"]
OVER = {"model.ndf": 8}
LAMBDA = 10.0


def _twin(preset):
    cfg = get_preset(preset).override(OVER)
    _, d = build_models(cfg.model, "fp32")
    params, state = d.init(jax.random.PRNGKey(4))
    td = build_discriminator(port_preset(preset).override(OVER).model,
                             "fp32", device="cpu",
                             generator=torch.Generator().manual_seed(4))
    load_jax_module(td, to_numpy(params), to_numpy(state))
    return d, params, state, td.eval()


def _pair(rng, n=4):
    real = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    fake = np.tanh(rng.standard_normal((n, 32, 32, 3))).astype(np.float32)
    return real, fake


@pytest.mark.parametrize("draw", ["alpha", "key"])
@pytest.mark.parametrize("preset", PRESETS)
def test_penalty_matches_jax(rng, preset, draw):
    d, params, state, td = _twin(preset)
    real, fake = _pair(rng)
    key = jax.random.PRNGKey(11)
    alpha = (rng.uniform(0, 1, 4).astype(np.float32) if draw == "alpha"
             else None)
    ref = jax_gp(lambda x: d.apply(params, state, x, train=False)[0],
                 jnp.asarray(real), jnp.asarray(fake), key,
                 alpha=None if alpha is None else jnp.asarray(alpha))
    u_before = {k: v.clone() for k, v in td.state_dict().items()
                if k.endswith(".u")}
    got = gradient_penalty(td, torch.from_numpy(real), torch.from_numpy(fake),
                           np.asarray(key), alpha=alpha)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    assert float(ref) > 0
    # the eval-mode D keeps spectral norm's u
    for k, u in u_before.items():
        assert torch.equal(td.state_dict()[k], u), k


@pytest.mark.parametrize("preset", PRESETS)
def test_penalty_gradients_match_jax(rng, preset):
    d, params, state, td = _twin(preset)
    real, fake = _pair(rng)
    alpha = rng.uniform(0, 1, 4).astype(np.float32)

    def scaled(p):
        return LAMBDA * jax_gp(lambda x: d.apply(p, state, x, train=False)[0],
                               jnp.asarray(real), jnp.asarray(fake), None,
                               alpha=jnp.asarray(alpha))

    grads = flatten(to_numpy(jax.grad(scaled)(params)))
    (LAMBDA * gradient_penalty(td, torch.from_numpy(real),
                               torch.from_numpy(fake), alpha=alpha)).backward()
    # the penalty does not depend on the tail's bias: no gradient in torch,
    # a zero one in JAX
    got = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
           for k, p in td.named_parameters()}
    assert sorted(got) == sorted(grads)
    for k, v in grads.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)


def test_step_penalty_runs_on_pytorch_ops_under_pallas(monkeypatch):
    """The JAX trainer's rule: the differentiated step never reaches a
    kernel.  Under ``set_default_impl("pallas")`` the step (its eval-mode
    penalty D included) calls no kernel-4 wrapper, which is forward-only
    and would raise, and logs what the "xla" impl logs."""
    over = {"model.ngf": 4, "model.ndf": 4, "model.nz": 8,
            "data.batch_size": 4, "train.precision": "fp32"}
    data = make_synthetic(32, 3, 4, seed=1)["images"]
    calls = []
    real = cuda_conv.conv_affine_act
    monkeypatch.setattr(cuda_conv, "conv_affine_act",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    metrics = {}
    for impl in ("xla", "pallas"):
        *_, pcfg, pstate = twin_train_states("wgan_gp_cifar10", over)
        step = build_train_step(pcfg, pstate.g, pstate.d)
        convs.set_default_impl(impl)
        try:
            _, metrics[impl] = step(pstate, {"image": torch.from_numpy(data)})
            assert convs.resolve_impl(None) == impl
        finally:
            convs.set_default_impl("xla")
    assert calls == []
    assert metrics["pallas"]["gp"].item() > 0
    for k, v in metrics["xla"].items():
        assert torch.equal(metrics["pallas"][k], v), k
