"""The port's discriminator, losses and random draws against the JAX
package: ``Discriminator`` (with spectral norm for ``sngan_cifar10``) and
``CondDiscriminator`` (``cdcgan_celeba64``/``128``) in train mode
(fuse_stats on and off: logits, BatchNorm running statistics, spectral
norm's u and parameter gradients) and in eval mode (the "xla" impl and the
fused "pallas" kernels' plain versions, in fp32 and, block by block, in
bf16), every loss kind, and the train step's threefry draws against
``jax.random``."""

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
from tpugan_torch.nn.spectral_norm import spectral_sigma
from tpugan_torch.ops import convs, cuda_conv, cuda_conv_stats
from tpugan_torch.sample import threefry

PRESETS = [("dcgan_celeba64", {"model.ndf": 8}),
           ("dcgan_cifar10", {"model.ndf": 8}),
           ("dcgan_mnist", {"model.ndf": 8}),
           ("sngan_cifar10", {"model.ndf": 8}),
           ("cdcgan_celeba64", {"model.ndf": 8})]
# 128 px: five blocks, gradients with entries up to O(10)
CDCGAN128 = ("cdcgan_celeba128", {"model.ndf": 4})


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


def _inputs(rng, cfg, n=6):
    """(JAX input, port arguments): the images, and for a conditional D
    with them labels of both classes."""
    x = _images(rng, cfg, n)
    if cfg.model.arch != "cdcgan":
        return jnp.asarray(x), (torch.from_numpy(x),)
    y = np.arange(n) % cfg.model.n_classes
    return ((jnp.asarray(x), jnp.asarray(y, jnp.int32)),
            (torch.from_numpy(x), torch.from_numpy(y)))


@pytest.fixture
def fuse():
    yield
    jax_ops.set_fuse_stats("off")


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("preset,overrides", PRESETS)
def test_discriminator_train_mode_matches_jax(rng, fuse, preset, overrides,
                                              mode):
    _check_train_mode(rng, preset, overrides, mode, grad_atol=lambda v: 1e-5)


@pytest.mark.parametrize("mode", ["on", "off"])
def test_cdcgan128_discriminator_train_mode_matches_jax(rng, fuse, mode):
    # the gradients' entries reach O(10) at 128 px, and one that cancels
    # carries the sum-order noise of the largest: 1e-6 of it, not 1e-5
    # absolute
    _check_train_mode(rng, *CDCGAN128, mode,
                      grad_atol=lambda v: 1e-6 * np.abs(v).max())


def _check_train_mode(rng, preset, overrides, mode, grad_atol):
    cfg, d, params, state, td = _twin(preset, overrides, mode)
    xj, xt = _inputs(rng, cfg)
    jax_ops.set_fuse_stats(mode)

    def loss(p):
        logits, ns = d.apply(p, state, xj, train=True)
        return jnp.sum(jnp.square(logits)), (logits, ns)

    (_, (ref, new_state)), grads = jax.value_and_grad(loss, has_aux=True)(
        params)
    td.train()
    before = cuda_conv_stats.launches
    got = td(*xt)
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
        np.testing.assert_allclose(pgrads[k], v, rtol=1e-3,
                                   atol=grad_atol(v), err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("preset,overrides", PRESETS + [CDCGAN128])
def test_discriminator_eval_mode_matches_jax(rng, preset, overrides, impl):
    cfg, d, params, state, td = _twin(preset, overrides)
    # running statistics (and spectral norm's u) from two train-mode
    # batches, so eval folds them
    for _ in range(2):
        _, state = d.apply(params, state, _inputs(rng, cfg)[0], train=True)
    load_jax_module(td, to_numpy(params), to_numpy(state))
    xj, xt = _inputs(rng, cfg)
    ref, _ = d.apply(params, state, xj, train=False)
    convs.set_default_impl(impl)
    try:
        with torch.no_grad():
            got = td.eval()(*xt)
    finally:
        convs.set_default_impl("xla")
    # fp32; "pallas" folds BN into the conv's epilogue (a*y + b in place of
    # (y - mean) * rsqrt(var + eps) * scale + bias): rounding only
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    # eval keeps the stored u
    arrays = module_arrays(td)
    for k, v in flatten(to_numpy(state)).items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)


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


@pytest.mark.parametrize("preset,n_blocks,cin", [("sngan_cifar10", 3, 3),
                                                 ("cdcgan_celeba64", 4, 4)])
def test_eval_pallas_is_one_fused_kernel_per_block_of_new_ds(
        monkeypatch, preset, n_blocks, cin):
    """The spectrally normalized D hands the kernel W / sigma (sigma from
    the stored u) in the compute dtype; the conditional D's first block
    takes the image and the label plane, Cin = 4 (kernel 4's narrow path on
    the card)."""
    cfg = port_preset(preset).override({"model.ndf": 8})
    td = build_discriminator(cfg.model, "bf16", device="cpu",
                             generator=torch.Generator().manual_seed(0))
    calls = []
    real = cuda_conv.conv_affine_act
    monkeypatch.setattr(
        cuda_conv, "conv_affine_act",
        lambda x, w, *a, **k: calls.append((x.shape[3], w)) or real(
            x, w, *a, **k))
    s = cfg.model.image_size
    x = torch.zeros(2, s, s, 3)
    args = (x, torch.tensor([0, 1])) if preset.startswith("cdcgan") else (x,)
    convs.set_default_impl("pallas")
    try:
        with torch.no_grad():
            td.eval()(*args)
    finally:
        convs.set_default_impl("xla")
    assert len(calls) == n_blocks and calls[0][0] == cin
    blocks = td.d.blocks if preset.startswith("cdcgan") else td.blocks
    for (_, w), blk in zip(calls, blocks):
        conv = blk.conv
        assert w.dtype == torch.bfloat16
        if preset == "sngan_cifar10":
            sigma = spectral_sigma(conv.w, conv.u, 0)[0]
            assert torch.equal(w, (conv.w / sigma).to(torch.bfloat16))
        else:
            assert torch.equal(w, conv.w.to(torch.bfloat16))


def test_discriminator_keys_are_the_jax_names():
    """load_jax_module maps by name: spectral norm's u sits beside w and b
    (``block{i}.conv.u``, ``tail.dense.u``), and the conditional D keeps
    ``embed.table``, ``proj.{w,b}`` and ``d.*``."""
    for preset in ("sngan_cifar10", "cdcgan_celeba64"):
        cfg = get_preset(preset).override({"model.ndf": 4})
        _, d = build_models(cfg.model, "fp32")
        params, state = d.init(jax.random.PRNGKey(0))
        td = build_discriminator(port_preset(preset).override(
            {"model.ndf": 4}).model, "fp32", device="cpu",
            generator=torch.Generator().manual_seed(0))
        assert set(td.state_dict()) == (set(flatten(params))
                                        | set(flatten(state)))
        # u is state: the optimizer's moments follow the parameters alone
        assert set(dict(td.named_parameters())) == set(flatten(params))
        if preset == "sngan_cifar10":
            assert {"tail.dense.u", "block0.conv.u"} <= set(flatten(state))


# A bf16 eval block against tpugan's: the port's fused block rounds once,
# after the fp32 affine and activation; tpugan rounds the conv output to
# bf16, then applies BN (fp32, rounded) and the activation.  Rounding the
# conv first moves the output by half an ulp of |conv| * a (a = BN's
# scale * rsqrt(var + eps), 1 without BN), the BN output's rounding and the
# final roundings by an ulp of the output: 2^-7 |ref| + 2^-6 of the largest
# |conv| * a (2^-8 relative: half an ulp, counted twice), a few ulps of the
# layer's largest value.
BF16_BLOCKS = [
    # (label, cin, cout, batchnorm, spectral_norm, input size)
    ("first block, no BN", 3, 16, False, False, 16),
    ("BN block", 16, 32, True, False, 8),
    ("spectral norm", 16, 32, False, True, 8),
]


@pytest.mark.parametrize("label,cin,cout,bn,sn,size", BF16_BLOCKS,
                         ids=[b[0] for b in BF16_BLOCKS])
def test_bf16_fused_eval_dblock_matches_jax(rng, label, cin, cout, bn, sn,
                                            size):
    from tpugan.models.blocks import DBlock as JaxDBlock
    from tpugan_torch.models.blocks import DBlock

    jb = JaxDBlock(cin, cout, batchnorm=bn, spectral_norm=sn,
                   dtype=jnp.bfloat16)
    params, state = jb.init(jax.random.PRNGKey(2))
    if not bn:  # a bias that is not zero
        params["conv"]["b"] = jax.random.normal(jax.random.PRNGKey(3),
                                                (cout,)) * 0.1
    x = rng.standard_normal((4, size, size, cin)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    # running statistics (u) from two train-mode batches
    for _ in range(2):
        _, state = jb.apply(params, state, jnp.asarray(
            rng.standard_normal(x.shape), jnp.bfloat16), train=True)
    ref, _ = jb.apply(params, state, xb, train=False)
    tb = DBlock(cin, cout, batchnorm=bn, spectral_norm=sn, device="cpu",
                generator=torch.Generator().manual_seed(2))
    load_jax_module(tb, to_numpy(params), to_numpy(state))
    convs.set_default_impl("pallas")
    try:
        with torch.no_grad():
            got = tb.eval()(torch.from_numpy(x).to(torch.bfloat16))
    finally:
        convs.set_default_impl("xla")
    assert got.dtype == torch.bfloat16
    # |conv| * a, the scale the conv's rounding acts at
    conv = tb.conv
    a = (tb.bn.scale * torch.rsqrt(tb.bn.var + tb.bn.eps) if bn
         else torch.ones(cout))
    pre = cuda_conv.conv421_plain(torch.from_numpy(x).to(torch.bfloat16),
                                  conv.weight().to(torch.bfloat16)) * a
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    err = (got.float() - ref).abs()
    limit = 2.0 ** -7 * ref.abs() + 2.0 ** -6 * pre.abs().max()
    assert bool((err <= limit).all()), (
        f"{label}: max err {err.max().item()}, largest value "
        f"{ref.abs().max().item()}, largest |conv| * a "
        f"{pre.abs().max().item()}")


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


@pytest.mark.parametrize("shape,lo,hi", [((128,), 0, 2), ((3, 5), 0, 10),
                                         ((7,), -4, 1000), ((), 0, 2)])
@pytest.mark.parametrize("seed", [0, 123456])
def test_randint_matches_jax_random(seed, shape, lo, hi):
    """``randint`` with a shape, as the step draws the fake labels from
    k_yd / k_yg: bit for bit ``jax.random.randint``."""
    key = jax.random.split(jax.random.PRNGKey(seed), 8)[4]
    got = threefry.randint(np.asarray(key), lo, hi, shape)
    ref = np.asarray(jax.random.randint(key, shape, lo, hi))
    assert got.dtype == np.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
