"""The discriminator's kernel modules (plain versions, on the CPU) against
the JAX package: the fused strided conv (``cuda_conv`` vs ``pallas_conv``)
and the conv + batch statistics (``cuda_conv_stats`` vs
``pallas_conv_stats``), the Pallas kernels run in interpret mode; the
``conv_bn_stats`` backward against ``jax.grad`` of the JAX custom VJP; and
``ops.convs.conv2d``'s two impls against the JAX XLA conv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tpugan.ops import pallas_conv, pallas_conv_stats
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.models.blocks import DBlock
from tpugan_torch.models.registry import build_models
from tpugan_torch.ops import convs, cuda_conv, cuda_conv_stats


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _operands(rng, n, h, cin, cout):
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((4, 4, cin, cout)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "tanh", "none"])
@pytest.mark.parametrize("n,h,cin,cout", [(2, 16, 3, 8), (3, 8, 16, 12),
                                          (1, 4, 33, 7)])
def test_conv_affine_act_matches_pallas(rng, n, h, cin, cout, act):
    x, w = _operands(rng, n, h, cin, cout)
    a = rng.standard_normal(cout).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_conv.conv_affine_act(
            jnp.asarray(x), jnp.asarray(w), a, b, act=act, leak=0.1,
            out_dtype=jnp.float32)
    before = cuda_conv.launches
    got = cuda_conv.conv_affine_act(_t(x), _t(w), _t(a), _t(b), act=act,
                                    leak=0.1, out_dtype=torch.float32)
    assert cuda_conv.launches == before  # a CPU tensor takes the plain path
    assert got.shape == (n, h // 2, h // 2, cout)
    # fp32 both sides; only the order of the fp32 sums differs
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n,h,cin,cout", [(4, 8, 16, 32), (2, 32, 3, 16)])
def test_conv2d_hook_matches_pallas(rng, n, h, cin, cout):
    x, w = _operands(rng, n, h, cin, cout)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_conv.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2,
                                 padding=1)
    got = cuda_conv.conv2d(_t(x), _t(w))
    assert got.dtype == torch.float32
    # fp32, sum order only
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("n,h,cin,cout", [(6, 16, 8, 16), (2, 8, 3, 5),
                                          (3, 4, 33, 9)])
def test_conv_stats_matches_pallas(rng, n, h, cin, cout):
    x, w = _operands(rng, n, h, cin, cout)
    # an offset channel mean makes E[y^2] - mean^2 cancel, as in training
    x = x + 0.5
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_conv_stats.conv_stats(jnp.asarray(x), jnp.asarray(w),
                                           out_dtype=jnp.float32)
    got = cuda_conv_stats.conv_stats(_t(x), _t(w))
    # y: fp32 sum order only.  mean/var: fp32 sums over 2..48 rows per
    # channel in another order, and var = E[y^2] - mean^2 loses about
    # log2(E[y^2]/var) bits to cancellation
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-3,
                               atol=1e-5)
    assert (got[2] >= 0).all()


def test_conv_stats_clamps_var_and_takes_stats_before_rounding():
    # channels whose mean dwarfs their spread: E[y^2] - mean^2 cancels
    # and may round below 0; the variance is clamped at 0
    g = torch.Generator().manual_seed(0)
    x = 100.0 + 1e-3 * torch.randn(2, 8, 8, 3, generator=g)
    w = torch.zeros(4, 4, 3, 4)
    w[1:3, 1:3] = 1.0  # the interior taps only: every output sees them
    _, _, var = cuda_conv_stats.conv_stats(x, w)
    assert (var >= 0).all()
    # bf16 output, fp32 statistics of the unrounded sums
    xb = torch.randn(2, 8, 8, 4).bfloat16()
    wb = torch.randn(4, 4, 4, 3).bfloat16()
    yb, mb, vb = cuda_conv_stats.conv_stats(xb, wb)
    y32 = cuda_conv.conv421_plain(xb, wb)
    assert yb.dtype == torch.bfloat16 and mb.dtype == torch.float32
    torch.testing.assert_close(mb, y32.mean(dim=(0, 1, 2)), rtol=0, atol=0)


def test_conv_bn_stats_grad_matches_jax(rng):
    """The port's backward equals jax.grad through the JAX custom VJP for a
    loss that pulls on all three outputs (y, mean, var) asymmetrically, as
    tests/test_fused_train_path.py does in the JAX package."""
    x, w = _operands(rng, 4, 16, 8, 16)
    cw = rng.standard_normal(16).astype(np.float32)

    def jloss(x, w):
        y, m, v = pallas_conv_stats.conv_bn_stats(x, w)
        return (jnp.sum(jnp.tanh(y) * cw) + jnp.sum(m * cw ** 2)
                + jnp.sum(jnp.sqrt(v + 1.0)))

    gx_ref, gw_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    tc = _t(cw)
    y, m, v = cuda_conv_stats.conv_bn_stats(tx, tw)
    loss = ((torch.tanh(y) * tc).sum() + (m * tc ** 2).sum()
            + torch.sqrt(v + 1.0).sum())
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    # fp32; the conv gradients sum in another order on each side
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_ref), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_ref), rtol=1e-4,
                               atol=1e-5)


def test_conv_bn_stats_skips_the_unneeded_weight_grad(rng, monkeypatch):
    x, w = _operands(rng, 2, 8, 4, 6)
    calls = []
    real = torch.nn.grad.conv2d_weight
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tx = _t(x).requires_grad_()
    y, m, v = cuda_conv_stats.conv_bn_stats(tx, _t(w))
    (y.sum() + v.sum()).backward()
    assert tx.grad is not None and not calls


def test_fuse_stats_switch():
    """Each DBlock holds its own mode, from the config that built it: two
    discriminators in one process run their own paths."""
    cpu = torch.zeros(1)
    for mode, want in (("on", True), ("off", False), ("auto", False)):
        assert cuda_conv_stats.fuse_stats_enabled(mode, cpu) is want
    with pytest.raises(ValueError, match="fuse_stats"):
        cuda_conv_stats.fuse_stats_enabled("maybe", cpu)
    with pytest.raises(ValueError, match="fuse_stats"):
        DBlock(3, 8, batchnorm=True, fuse_stats="maybe", device="cpu")
    cfg = port_preset("dcgan_celeba64").override(
        {"model.ndf": 8, "model.ngf": 8, "model.nz": 8})
    calls = []
    real = cuda_conv_stats.conv_bn_stats
    x = torch.zeros(2, 64, 64, 3)
    for mode, fused in (("on", 3), ("off", 0)):
        _, d = build_models(cfg.model, "fp32", fuse_stats=mode, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        assert all(b.fuse_stats == mode for b in d.blocks)
        calls.clear()
        cuda_conv_stats.conv_bn_stats = (
            lambda *a: calls.append(1) or real(*a))
        try:
            d.train()(x)
        finally:
            cuda_conv_stats.conv_bn_stats = real
        assert len(calls) == fused


def test_conv2d_impls_agree_with_xla_conv(rng):
    from tpugan.ops.convs import conv2d as jax_conv2d

    x, w = _operands(rng, 2, 8, 16, 8)
    ref = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), stride=2,
                                padding=1, impl="xla"))
    for impl in ("xla", "pallas"):
        got = convs.conv2d(_t(x), _t(w), stride=2, padding=1, impl=impl)
        assert got.shape == (2, 4, 4, 8)
        # fp32, sum order only
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    # other strides go to the "xla" impl and are refused by "pallas"
    w3 = (rng.standard_normal((3, 3, 16, 8)) * 0.1).astype(np.float32)
    ref = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w3), stride=1,
                                padding=1, impl="xla"))
    got = convs.conv2d(_t(x), _t(w3), stride=1, padding=1, impl="xla")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="k=4, s=2, p=1"):
        convs.conv2d(_t(x), _t(w3), stride=1, padding=1, impl="pallas")


def test_kernels_refuse_what_they_do_not_take():
    x, w = torch.zeros(2, 8, 8, 4), torch.zeros(4, 4, 4, 6)
    one, zero = torch.ones(6), torch.zeros(6)
    with pytest.raises(ValueError, match="even"):
        cuda_conv.conv_affine_act(torch.zeros(2, 7, 8, 4), w, one, zero)
    with pytest.raises(ValueError, match="Cin"):
        cuda_conv_stats.conv_stats(x, torch.zeros(4, 4, 5, 6))
    with pytest.raises(ValueError, match="scale"):
        cuda_conv.conv_affine_act(x, w, torch.ones(5), zero)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv.conv_affine_act(x, w.requires_grad_(), one, zero)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv_stats.conv_stats(x, w)
