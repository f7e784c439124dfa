"""The port's discriminator, losses and random draws against the JAX
package: ``Discriminator`` in train mode (fuse_stats on and off: logits,
BatchNorm running statistics and parameter gradients) and in eval mode (the
"xla" impl and the fused "pallas" kernels' plain versions), every loss
kind, and the train step's threefry draws against ``jax.random``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import module_arrays, to_numpy
from tpugan import ops as jax_ops
from tpugan.configs import get_preset
from tpugan.losses import adversarial as jax_losses
from tpugan.models import build_models
from tpugan_torch.ckpt.from_jax import flatten, load_jax_module
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.losses import adversarial as losses
from tpugan_torch.models.registry import build_discriminator
from tpugan_torch.ops import convs, cuda_conv, cuda_conv_stats
from tpugan_torch.sample import threefry

PRESETS = [("dcgan_celeba64", {"model.ndf": 8}),
           ("dcgan_cifar10", {"model.ndf": 8}),
           ("dcgan_mnist", {"model.ndf": 8})]


def _twin(preset, overrides, fuse_stats="off"):
    cfg = get_preset(preset).override(overrides)
    _, d = build_models(cfg.model, "fp32")
    params, state = d.init(jax.random.PRNGKey(3))
    pcfg = port_preset(preset).override(overrides)
    td = build_discriminator(pcfg.model, "fp32", fuse_stats=fuse_stats,
                             device="cpu",
                             generator=torch.Generator().manual_seed(3))
    load_jax_module(td, to_numpy(params), to_numpy(state))
    return cfg, d, params, state, td


def _images(rng, cfg, n=6):
    s, c = cfg.model.image_size, cfg.model.channels
    return rng.uniform(-1, 1, (n, s, s, c)).astype(np.float32)


@pytest.fixture
def fuse():
    yield
    jax_ops.set_fuse_stats("off")


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("preset,overrides", PRESETS)
def test_discriminator_train_mode_matches_jax(rng, fuse, preset, overrides,
                                              mode):
    cfg, d, params, state, td = _twin(preset, overrides, mode)
    x = _images(rng, cfg)
    jax_ops.set_fuse_stats(mode)

    def loss(p):
        logits, ns = d.apply(p, state, jnp.asarray(x), train=True)
        return jnp.sum(jnp.square(logits)), (logits, ns)

    (_, (ref, new_state)), grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    td.train()
    before = cuda_conv_stats.launches
    got = td(torch.from_numpy(x))
    assert cuda_conv_stats.launches == before  # CPU: the plain version
    (got ** 2).sum().backward()
    # fp32; conv sums in another order, and the BN normalization divides
    # by per-channel std over as few as 6 * 2 * 2 values
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    arrays = module_arrays(td)
    for k, v in flatten(to_numpy(new_state)).items():
        np.testing.assert_allclose(arrays[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    pgrads = {k: p.grad.numpy() for k, p in td.named_parameters()}
    for k, v in flatten(to_numpy(grads)).items():
        # the backward sums in another order through up to 4 blocks
        np.testing.assert_allclose(pgrads[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("preset,overrides", PRESETS)
def test_discriminator_eval_mode_matches_jax(rng, preset, overrides, impl):
    cfg, d, params, state, td = _twin(preset, overrides)
    # running statistics from two train-mode batches, so eval folds them
    for _ in range(2):
        _, state = d.apply(params, state, jnp.asarray(_images(rng, cfg)),
                           train=True)
    load_jax_module(td, to_numpy(params), to_numpy(state))
    x = _images(rng, cfg)
    ref, _ = d.apply(params, state, jnp.asarray(x), train=False)
    convs.set_default_impl(impl)
    try:
        with torch.no_grad():
            got = td.eval()(torch.from_numpy(x))
    finally:
        convs.set_default_impl("xla")
    # fp32; "pallas" folds BN into the conv's epilogue (a*y + b in place of
    # (y - mean) * rsqrt(var + eps) * scale + bias): rounding only
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_eval_pallas_is_one_fused_kernel_per_block(monkeypatch):
    cfg = port_preset("dcgan_celeba64").override({"model.ndf": 8})
    td = build_discriminator(cfg.model, "fp32", device="cpu",
                             generator=torch.Generator().manual_seed(0))
    calls = []
    real = cuda_conv.conv_affine_act
    monkeypatch.setattr(
        cuda_conv, "conv_affine_act",
        lambda *a, **k: calls.append(k["act"]) or real(*a, **k))
    convs.set_default_impl("pallas")
    try:
        with torch.no_grad():
            td.eval()(torch.zeros(2, 64, 64, 3))
    finally:
        convs.set_default_impl("xla")
    assert calls == ["leaky_relu"] * 4


def test_unported_discriminators_raise():
    with pytest.raises(NotImplementedError, match="CondDiscriminator"):
        build_discriminator(port_preset("cdcgan_celeba64").model, device="cpu")
    with pytest.raises(NotImplementedError, match="SpectralNorm"):
        build_discriminator(port_preset("sngan_cifar10").model, device="cpu")


@pytest.mark.parametrize("kind", ["bce", "lsgan", "wgan", "wgan_gp", "hinge"])
@pytest.mark.parametrize("labels", [(1.0, 0.0), (0.9, 0.1)])
def test_losses_match_jax(rng, kind, labels):
    real = rng.standard_normal(16).astype(np.float32) * 3
    fake = rng.standard_normal(16).astype(np.float32) * 3
    rl, fl = labels
    got = (losses.d_loss_fn(kind, torch.from_numpy(real),
                            torch.from_numpy(fake), real_label=rl,
                            fake_label=fl),
           losses.g_loss_fn(kind, torch.from_numpy(fake), real_label=rl))
    ref = (jax_losses.d_loss_fn(kind, jnp.asarray(real), jnp.asarray(fake),
                                real_label=rl, fake_label=fl),
           jax_losses.g_loss_fn(kind, jnp.asarray(fake), real_label=rl))
    # fp32 means of 16 terms; softplus may differ by an ulp between XLA
    # and torch
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown loss"):
        losses.d_loss_fn("nope", torch.zeros(2), torch.zeros(2))


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_step_draws_match_jax_random(seed):
    """The train step's key schedule and draws: split(rng, 8), the hflip
    bits and the two latents."""
    root = jax.random.PRNGKey(seed)
    rng = jax.random.split(root, 3)[2]
    keys = jax.random.split(rng, 8)
    prng = threefry.split(threefry.prng_key(seed), 3)[2]
    pkeys = threefry.split(prng, 8)
    np.testing.assert_array_equal(pkeys, np.asarray(keys))
    flip = np.asarray(jax.random.bernoulli(keys[6], 0.5, (16, 1, 1, 1)))
    np.testing.assert_array_equal(
        threefry.uniform(pkeys[6], (16, 1, 1, 1)) < 0.5, flip)
    for k in (1, 2):
        z = np.asarray(jax.random.normal(keys[k], (16, 20), jnp.float32))
        # one ulp of XLA's float32 erf_inv (sample/threefry.py)
        np.testing.assert_allclose(threefry.normal(pkeys[k], (16, 20)), z,
                                   rtol=0, atol=5e-7)
