"""The port's kernel modules (plain versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode: the per-layer fused ConvT
(``cuda_convt`` vs ``pallas_convt``), the BN fold (``cuda_gen.fold_generator``
vs ``pallas_gen.fold_generator``) and the two whole-generator megakernels
(``cuda_gen`` / ``cuda_gen2`` vs ``pallas_gen`` / ``pallas_gen2``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port_common import twin_generators
from tpugan.ops import pallas_convt, pallas_gen, pallas_gen2
from tpugan_torch.ops import convs, cuda_convt, cuda_gen, cuda_gen2


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("act", ["relu", "tanh", "none"])
@pytest.mark.parametrize("n,h,cin,cout", [(4, 4, 32, 16), (2, 8, 16, 8),
                                          (3, 16, 8, 8)])
def test_convt_affine_act_matches_pallas(rng, n, h, cin, cout, act):
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((4, 4, cin, cout)) * 0.1).astype(np.float32)
    a = rng.standard_normal(cout).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_convt.convt_affine_act(
            jnp.asarray(x), jnp.asarray(w), a, b, act=act,
            out_dtype=jnp.float32)
    got = cuda_convt.convt_affine_act(_t(x), _t(w), _t(a), _t(b), act=act,
                                      out_dtype=torch.float32)
    # fp32 both sides; only the order of the fp32 sums differs
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "none"])
def test_fused_epilogues_match_jax(rng, act):
    from tpugan.ops import fused as jax_fused
    from tpugan_torch.ops import fused

    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(8).astype(np.float32)
                         for _ in range(3))
    var = rng.random(8).astype(np.float32)
    ref = jax_fused.bn_act(jnp.asarray(x), scale, bias, mean, var, act=act,
                           leak=0.1)
    got = fused.bn_act(_t(x), _t(scale), _t(bias), _t(mean), _t(var),
                       act=act, leak=0.1)
    # fp32; XLA's CPU rsqrt may sit an ulp from torch's
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    ref = jax_fused.bias_act(jnp.asarray(x), bias, act=act, leak=0.1)
    got = fused.bias_act(_t(x), _t(bias), act=act, leak=0.1)
    # the same fp32 add and activation on both sides; tanh may differ by
    # an ulp between XLA and torch
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_convt_impls_agree_with_xla_convt(rng):
    """The "pallas" impl (plain kernel on CPU) and the "xla" impl
    (F.conv_transpose2d) both equal the JAX XLA transpose conv."""
    from tpugan.ops.convs import conv_transpose2d as jax_convt

    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (rng.standard_normal((4, 4, 16, 8)) * 0.1).astype(np.float32)
    ref = np.asarray(jax_convt(jnp.asarray(x), jnp.asarray(w), stride=2,
                               padding=1, impl="xla"))
    for impl in ("xla", "pallas"):
        got = convs.conv_transpose2d(_t(x), _t(w), stride=2, padding=1,
                                     impl=impl)
        assert got.shape == (2, 16, 16, 8)
        # fp32, sum order only
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_convt_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 8, 8, 4)
    with pytest.raises(ValueError):
        convs.conv_transpose2d(x, torch.zeros(3, 3, 4, 8), stride=2,
                               padding=1, impl="pallas")
    with pytest.raises(ValueError):
        convs.conv_transpose2d(x, torch.zeros(4, 4, 4, 8), stride=1,
                               padding=1, impl="pallas")
    with pytest.raises(ValueError):
        cuda_convt.convt_affine_act(x, torch.zeros(4, 4, 5, 8),
                                    torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError):
        cuda_convt.convt_affine_act(x, torch.zeros(4, 4, 4, 8),
                                    torch.ones(8), torch.zeros(8), act="gelu")
    w = torch.zeros(4, 4, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_convt.convt_affine_act(x, w, torch.ones(8), torch.zeros(8))


@pytest.mark.parametrize("batchnorm", [True, False])
def test_fold_generator_matches_pallas_fold(batchnorm):
    _, g, params, state, _, tg = twin_generators(
        "dcgan_celeba64", {"model.ngf": 8, "model.g_batchnorm": batchnorm})
    (wh, ah, bh), blocks, (s0, c0) = pallas_gen.fold_generator(
        g, params, state)
    (pwh, pah, pbh), pblocks, (ps0, pc0) = cuda_gen.fold_generator(tg)
    assert (ps0, pc0) == (s0, c0) and len(pblocks) == len(blocks)
    # Weights and the no-BN affines (ones, biases) carry over exactly.  The
    # BN affines go through rsqrt: XLA's CPU rsqrt is not correctly rounded
    # (about a third of its results sit an ulp from torch's), so those hold
    # to 2 ulp.
    bn_tol = dict(rtol=2.4e-7, atol=0) if batchnorm else dict(rtol=0, atol=0)
    np.testing.assert_array_equal(pwh.numpy(), np.asarray(wh))
    np.testing.assert_allclose(pah.numpy(), np.asarray(ah), **bn_tol)
    np.testing.assert_allclose(pbh.numpy(), np.asarray(bh), **bn_tol)
    for i, ((w, a, b), (pw, pa, pb)) in enumerate(zip(blocks, pblocks)):
        tol = bn_tol if i < len(blocks) - 1 else dict(rtol=0, atol=0)
        np.testing.assert_array_equal(pw.numpy(), np.asarray(w))
        np.testing.assert_allclose(pa.numpy(), np.asarray(a), **tol)
        np.testing.assert_allclose(pb.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("preset,size", [("dcgan_celeba64", 64),
                                         ("dcgan_cifar10", 32),
                                         ("dcgan_mnist", 28)])
def test_megakernels_plain_match_pallas(rng, preset, size):
    """Plain v1 / v2 == the Pallas megakernels (interpret mode) on the same
    folded generator, at all three base grids (4x4 and the 7x7 MNIST head).
    """
    cfg, g, params, state, _, tg = twin_generators(
        preset, {"model.ngf": 16}, precision="bf16")
    z = rng.standard_normal((8, cfg.model.nz)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref1 = np.asarray(pallas_gen.generator_forward(
            g, params, state, jnp.asarray(z), out_dtype=jnp.float32))
        ref2 = np.asarray(pallas_gen2.generator_forward(
            g, params, state, jnp.asarray(z), out_dtype=jnp.float32))
    got1 = cuda_gen.generator_forward(tg, _t(z)).numpy()
    got2 = cuda_gen2.generator_forward(tg, _t(z)).numpy()
    assert got1.shape == got2.shape == (8, size, size, cfg.model.channels)
    # v1 rounds every activation (and the image) to bf16: a one-ulp flip of
    # a bf16 activation from a different fp32 sum order moves a pixel by up
    # to ~1e-2, so v1 holds at the 5e-2 of the JAX megakernel test.
    np.testing.assert_allclose(got1, ref1, atol=5e-2)
    # v2 keeps fp32 activations and an fp32 image; bf16 only at the matmul
    # operands, so sum-order ulps stay far smaller.
    np.testing.assert_allclose(got2, ref2, atol=5e-4)


def test_megakernel_v2_conditional_plain_matches_pallas(rng):
    cfg, g, params, state, _, tg = twin_generators(
        "cdcgan_celeba64", {"model.ngf": 8, "model.nz": 8,
                            "model.embed_dim": 4}, precision="bf16", seed=3)
    z = rng.standard_normal((4, 8)).astype(np.float32)
    y = np.array([0, 1, 1, 0], np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_gen2.generator_forward(
            g, params, state, jnp.asarray(z), out_dtype=jnp.float32,
            y=jnp.asarray(y)))
    got = cuda_gen2.generator_forward(tg, _t(z), torch.from_numpy(y)).numpy()
    assert got.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(got, ref, atol=5e-4)  # as the v2 test above
    with pytest.raises(ValueError, match="labels"):
        cuda_gen2.generator_forward(tg, _t(z))
    with pytest.raises(ValueError, match="out of range"):
        cuda_gen2.generator_forward(tg, _t(z), torch.tensor([0, 1, 2, 0]))
    with pytest.raises(ValueError, match="unconditional"):
        cuda_gen.generator_forward(tg, _t(z))


def test_v2_phase_layout_is_the_full_resolution_image(rng):
    """depth_to_space of the phase-space forward == the full-resolution
    forward of the same folded generator (the layout is only addressing)."""
    _, _, _, _, _, tg = twin_generators("dcgan_cifar10", {"model.ngf": 8})
    z = _t(rng.standard_normal((3, 100)))
    head, blocks, (s0, c0) = cuda_gen.fold_generator(tg)
    phased = cuda_gen2.generator_forward_plain(z, head, blocks, s0, c0)
    assert phased.shape == (8, 8, 3, 4, 4, 3)
    full = cuda_gen.head_plain(z, head, s0, c0)
    for i, (w, a, b) in enumerate(blocks):
        full = cuda_convt.convt_affine_act_plain(
            full.to(torch.bfloat16).float(), w.to(torch.bfloat16).float(),
            a, b, act="tanh" if i == len(blocks) - 1 else "relu")
    # same operands and products; only the fp32 sum order differs
    np.testing.assert_allclose(cuda_gen2.depth_to_space(phased).numpy(),
                               full.numpy(), atol=1e-5)
