"""The fp32 slice against the JAX package, on the CPU: ``dcgan_celeba64`` at
``train.precision="fp32"`` with ``train.kernels="pallas"`` and
``train.fuse_stats="on"`` (ngf = ndf = 8), the configuration whose kernels 1,
4 and 5 take fp32 operands on the card.  One train step from one carried
state (the whole state after it), then the trained nets in eval mode under
"pallas": D's logits through kernel 4, G's images through kernel 1, and each
of kernels 1, 4 and 5 at the slice's own layers against the JAX package's
Pallas kernel in interpret mode.  Also ``from_jax`` for this configuration
and the kernel wrappers' dtype rule on CPU tensors.

On the CPU a wrapper runs its plain version, and the JAX package's "pallas"
impl and its fused conv + statistics resolve to XLA off a TPU: the step
and the eval nets meet JAX's plain references there, the kernels' fp32
function its Pallas kernels in interpret mode.

Tolerances (fp32 on both sides): the step's parameters to lr / 20 and its
moments, losses and BN statistics as ``test_torch_port_train_step.py``
states them; activations and logits differ by fp32 sum order only, ~1e-6
relative, held to 1e-4 relative plus 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port_common import (assert_metrics_close, assert_moments_close,
                                assert_state_close, module_arrays,
                                run_twin_steps, to_numpy, twin_train_states)
from tpugan.models import build_models
from tpugan.ops import convs as jax_convs
from tpugan.ops import pallas_conv, pallas_conv_stats, pallas_convt
from tpugan_torch.ckpt.from_jax import flatten
from tpugan_torch.ops import convs, cuda_conv, cuda_conv_stats, cuda_convt
from tpugan_torch.ops.fused import bn_affine

PRESET = "dcgan_celeba64"
OVER = {"model.ngf": 8, "model.ndf": 8, "data.batch_size": 6,
        "train.precision": "fp32", "train.kernels": "pallas",
        "train.fuse_stats": "on"}


@pytest.fixture(scope="module")
def stepped():
    """(JAX cfg, JAX g, JAX d, JAX state, port state, JAX metrics, port
    metrics) after one step of both packages from one carried state."""
    jstate, pstate, jms, pms = run_twin_steps(PRESET, OVER, calls=1)
    from tpugan.configs import get_preset

    cfg = get_preset(PRESET).override(OVER)
    g, d = build_models(cfg.model, cfg.train.precision)
    return cfg, g, d, jstate, pstate, jms, pms


def test_step_one_state_matches_jax(stepped):
    _, _, _, jstate, pstate, jms, pms = stepped
    assert pstate.d.blocks[1].fuse_stats == "on"
    assert all(p.dtype == torch.float32 for p in pstate.d.parameters())
    assert_metrics_close(jms, pms)
    # lr = 2e-4: a wrong update moves a parameter by ~lr
    assert_state_close(jstate, pstate, atol=1e-5)
    # Adam's first moments are 0.5 g.  D's tail bias gradient is a sum of
    # 12 terms (sigmoid - label) / 12 of ~0.04 each that cancels to ~2e-3,
    # so the logits' fp32 sum-order differences (~1e-6; BatchNorm over 6
    # images amplifies them) show at ~6e-5 of it, and at twice that in
    # the second moments (g^2): 5e-4 of each tensor's largest (a wrong
    # gradient is off by its own size)
    assert_moments_close(jstate, pstate, rel=5e-4)


def _eval_inputs(cfg, n=6, seed=11):
    rng = np.random.default_rng(seed)
    s = cfg.model.image_size
    x = rng.uniform(-1, 1, (n, s, s, 3)).astype(np.float32)
    z = rng.standard_normal((n, cfg.model.nz)).astype(np.float32)
    return x, z


def test_eval_d_and_g_under_pallas_match_jax(stepped):
    """The stepped nets in eval mode (BN's running statistics moved by the
    step): the port's D under "pallas" is one kernel-4 call a block, its G
    one kernel-1 call a GBlock (plain versions here), against the JAX
    package's nets under its "pallas" impl."""
    cfg, g, d, jstate, pstate, _, _ = stepped
    x, z = _eval_inputs(cfg)
    jax_convs.set_default_impl("pallas")
    try:
        logits, _ = d.apply(jstate.params_d, jstate.state_d, jnp.asarray(x),
                            train=False)
        images, _ = g.apply(jstate.params_g, jstate.state_g, jnp.asarray(z),
                            train=False)
    finally:
        jax_convs.set_default_impl("xla")
    calls = {"conv": 0, "convt": 0}
    conv_fn, convt_fn = cuda_conv.conv_affine_act, cuda_convt.convt_affine_act

    def count(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            assert a[0].dtype == a[1].dtype == torch.float32
            return fn(*a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        from tpugan_torch.models import blocks

        mp.setattr(blocks.cuda_conv, "conv_affine_act", count("conv", conv_fn))
        mp.setattr(blocks.cuda_convt, "convt_affine_act",
                   count("convt", convt_fn))
        with torch.no_grad(), convs.using_impl("pallas"):
            got_d = pstate.d.eval()(torch.from_numpy(x))
            got_g = pstate.g.eval()(torch.from_numpy(z))
    assert calls == {"conv": len(pstate.d.blocks),
                     "convt": len(pstate.g.blocks) + 1}
    assert got_d.dtype == got_g.dtype == torch.float32
    np.testing.assert_allclose(got_d.numpy(), np.asarray(logits), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(images), rtol=1e-4,
                               atol=1e-5)


def test_slice_layers_match_the_pallas_kernels(stepped):
    """Kernels 1, 4 and 5 at the slice's layers, on the stepped nets'
    weights and their own fp32 activations (the D's chain from a seeded
    batch, the G's from seeded latents), each against the JAX package's
    Pallas kernel in interpret mode."""
    cfg, _, _, _, pstate, _, _ = stepped
    x, z = _eval_inputs(cfg, seed=12)
    d, g = pstate.d.eval(), pstate.g.eval()
    with torch.no_grad(), pltpu.force_tpu_interpret_mode():
        h = torch.from_numpy(x)
        for blk in d.blocks:
            w = blk.conv.w
            if blk.bn is not None:
                a, b = bn_affine(blk.bn.scale, blk.bn.bias, blk.bn.mean,
                                 blk.bn.var, blk.bn.eps)
                y, mean, var = cuda_conv_stats.conv_stats(h, w)
                ry, rmean, rvar = pallas_conv_stats.conv_stats(
                    jnp.asarray(h.numpy()), jnp.asarray(w.numpy()),
                    out_dtype=jnp.float32)
                np.testing.assert_allclose(y.numpy(), np.asarray(ry),
                                           rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(mean.numpy(), np.asarray(rmean),
                                           rtol=1e-4, atol=1e-6)
                # var = E[y^2] - mean^2 in fp32 on both sides
                np.testing.assert_allclose(var.numpy(), np.asarray(rvar),
                                           rtol=1e-4, atol=1e-5)
            else:
                a, b = torch.ones_like(w[0, 0, 0]), blk.conv.b
            got = cuda_conv.conv_affine_act(h, w, a, b, leak=blk.act.slope)
            ref = pallas_conv.conv_affine_act(
                jnp.asarray(h.numpy()), jnp.asarray(w.numpy()), a.numpy(),
                b.numpy(), act="leaky_relu", leak=blk.act.slope,
                out_dtype=jnp.float32)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-5)
            h = got
        h = g.head(torch.from_numpy(z))
        layers = [*g.blocks, g.final]
        for i, blk in enumerate(layers):
            w = blk.conv.w
            if blk.bn is not None:
                a, b = bn_affine(blk.bn.scale, blk.bn.bias, blk.bn.mean,
                                 blk.bn.var, blk.bn.eps)
            else:
                a, b = torch.ones_like(w[0, 0, 0]), blk.conv.b
            act = "tanh" if i == len(layers) - 1 else "relu"
            got = cuda_convt.convt_affine_act(h, w, a, b, act=act)
            ref = pallas_convt.convt_affine_act(
                jnp.asarray(h.numpy()), jnp.asarray(w.numpy()), a.numpy(),
                b.numpy(), act=act, out_dtype=jnp.float32)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-5)
            h = got


def test_from_jax_carries_the_fp32_slice():
    """``load_jax_train_state`` for this configuration: every parameter
    and BN statistic of both nets bit for bit, in fp32, into nets that
    compute in fp32 with fuse_stats on."""
    _, _, _, jstate, pcfg, pstate = twin_train_states(PRESET, OVER)
    assert pcfg.train.precision == "fp32"
    for mod, params, st in ((pstate.g, jstate.params_g, jstate.state_g),
                            (pstate.d, jstate.params_d, jstate.state_d)):
        arrays = module_arrays(mod)
        want = {**flatten(to_numpy(params)), **flatten(to_numpy(st))}
        assert sorted(want) == sorted(arrays)
        for k, v in want.items():
            np.testing.assert_array_equal(arrays[k], v, err_msg=k)
        assert all(t.dtype == torch.float32 for t in mod.state_dict().values())
    assert [blk.conv.dtype for blk in pstate.d.blocks] == [torch.float32] * 4
    assert [blk.fuse_stats for blk in pstate.d.blocks] == ["on"] * 4
    assert pstate.g.final.conv.dtype == torch.float32
    assert pstate.step == int(jstate.step) == 0


# ---------------------------------------------------------------------------
# The wrappers' dtype rule, on CPU tensors: x and w of one dtype, bf16 or
# fp32 (as on the card), fp16 and mixed dtypes refused
# ---------------------------------------------------------------------------

def _call(kernel, x, w):
    one = torch.ones(w.shape[3])
    if kernel == "convt":
        return cuda_convt.convt_affine_act(x, w, one, 0 * one)
    if kernel == "conv":
        return cuda_conv.conv_affine_act(x, w, one, 0 * one)
    if kernel == "conv_stats":
        return cuda_conv_stats.conv_stats(x, w)[0]
    return cuda_conv_stats.conv_bn_stats(x, w)[0]


KERNELS = ["convt", "conv", "conv_stats", "conv_bn_stats"]
F32, BF, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("dx,dw", [(F32, F32), (BF, BF)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_wrappers_take_fp32_and_bf16(kernel, dx, dw):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 4, 8), generator=gen).to(dx)
    w = torch.randn((4, 4, 8, 5), generator=gen).to(dw)
    y = _call(kernel, x, w)
    assert y.dtype == dx and bool(torch.isfinite(y.float()).all())


@pytest.mark.parametrize("dx,dw", [(F16, F16), (F32, BF), (BF, F32),
                                   (F32, F16)],
                         ids=["fp16", "fp32-bf16", "bf16-fp32", "fp32-fp16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_wrappers_refuse_fp16_and_mixed_dtypes(kernel, dx, dw):
    x = torch.zeros((2, 4, 4, 8), dtype=dx)
    w = torch.zeros((4, 4, 8, 5), dtype=dw)
    with pytest.raises(ValueError, match="one dtype, bf16 or fp32"):
        _call(kernel, x, w)


@pytest.mark.parametrize("kernel", ["convt", "conv"])
def test_wrappers_refuse_an_fp16_output(kernel):
    x, w = torch.zeros((2, 4, 4, 8)), torch.zeros((4, 4, 8, 5))
    one = torch.ones(5)
    fn = (cuda_convt.convt_affine_act if kernel == "convt"
          else cuda_conv.conv_affine_act)
    with pytest.raises(ValueError, match="out_dtype"):
        fn(x, w, one, 0 * one, out_dtype=F16)



# ---------------------------------------------------------------------------
# The three-pass TF32 scheme of kernels 1, 4 and 5 at fp32 (the card's
# route where Cin is a multiple of 32, and kernel 4's narrow tile at Cin <=
# 16), emulated on the CPU at every layer of the paths at full depth, batch
# 2, against the JAX package's fp32 Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def tf32_round(t):
    """fp32 ``t`` rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero: ``cvt.rna.tf32.f32``, as the kernels split x and w."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t):
    """(big, small): big = tf32_round(t), small = tf32_round(t - big), the
    kernels' split (t - big is exact in fp32)."""
    big = tf32_round(t)
    return big, tf32_round(t - big)


def three_pass(product, x, w):
    """``product`` (an fp32 bilinear function of x and w: every product of
    two TF32 values is exact in fp32) in the kernels' three passes: small
    x big + big x small + big x big, fp32 sums; and in one TF32 pass."""
    (xb, xs), (wb, ws) = split_tf32(x), split_tf32(w)
    return (product(xs, wb) + product(xb, ws) + product(xb, wb),
            product(xb, wb))


# (kernel, n, h, cin, cout): the D's BN layers (kernel 5) and the G's
# ConvT layers (kernel 1) of dcgan_celeba64 at full width, batch 2; the
# eval D's four layers (kernel 4: the RGB layer on the narrow tile), the
# conditional D's Cin-4 layer and dcgan_mnist's Cin-1 layer
TF32_LAYERS = [("conv_stats", 2, 32, 64, 128), ("conv_stats", 2, 16, 128, 256),
               ("conv_stats", 2, 8, 256, 512), ("convt", 2, 4, 512, 256),
               ("convt", 2, 8, 256, 128), ("convt", 2, 16, 128, 64),
               ("convt", 2, 32, 64, 3), ("conv", 2, 64, 3, 64),
               ("conv", 2, 32, 64, 128), ("conv", 2, 16, 128, 256),
               ("conv", 2, 8, 256, 512), ("conv", 2, 64, 4, 64),
               ("conv", 2, 28, 1, 32)]


@pytest.mark.parametrize("kernel,n,h,cin,cout", TF32_LAYERS)
def test_three_tf32_passes_match_the_fp32_pallas_kernels(kernel, n, h, cin,
                                                         cout):
    """The card's fp32 route of kernels 1, 4 and 5 (three TF32 passes over
    split operands, fp32 sums; kernel 4 through its affine and LeakyReLU)
    within 1e-5 of the layer's largest |ref| of the JAX package's fp32
    kernel: the limit ``chip_smoke.f32_check`` holds the card's kernels to
    (fp32 products summed in another order).  One TF32 pass errs beyond
    it, so the limit tells the two apart."""
    from tpugan_torch.ops.cuda_conv import conv421_plain
    from tpugan_torch.ops.kernel_common import f32_route

    if kernel == "conv":
        assert cuda_conv.f32_path(cin, cout) in ("tf32", "tf32_narrow")
    else:
        assert f32_route(cin) == "tf32"
    rng = np.random.default_rng(cin + cout)
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    w = (0.05 * rng.standard_normal((4, 4, cin, cout))).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if kernel == "conv_stats":
        with pltpu.force_tpu_interpret_mode():
            ry, rm, rv = (np.asarray(r) for r in pallas_conv_stats.conv_stats(
                jnp.asarray(x), jnp.asarray(w), out_dtype=jnp.float32))
        y, y1 = three_pass(conv421_plain, xt, wt)
        mean, var = cuda_conv_stats._moments(y)
        scale = np.abs(ry).max()
        # the statistics as chip_smoke.f32_stats_check holds them
        assert np.abs(mean.numpy() - rm).max() <= 1e-5 * scale
        assert np.abs(var.numpy() - rv).max() <= 1e-5 * (rv + rm * rm).max()
    elif kernel == "conv":
        a = (1 + 0.1 * rng.standard_normal(cout)).astype(np.float32)
        b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ry = np.asarray(pallas_conv.conv_affine_act(
                jnp.asarray(x), jnp.asarray(w), a, b, act="leaky_relu",
                leak=0.2, out_dtype=jnp.float32))
        y, y1 = (torch.nn.functional.leaky_relu(
            v * torch.from_numpy(a) + torch.from_numpy(b), 0.2)
            for v in three_pass(conv421_plain, xt, wt))
        scale = np.abs(ry).max()
    else:
        a = (1 + 0.1 * rng.standard_normal(cout)).astype(np.float32)
        b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            ry = np.asarray(pallas_convt.convt_affine_act(
                jnp.asarray(x), jnp.asarray(w), a, b, act="none",
                out_dtype=jnp.float32))
        one = torch.ones(cout)

        def convt(xv, wv):
            return cuda_convt.convt_affine_act_plain(xv, wv, one, 0 * one,
                                                     act="none")

        y, y1 = (v * torch.from_numpy(a) + torch.from_numpy(b)
                 for v in three_pass(convt, xt, wt))
        scale = np.abs(ry).max()
    err = np.abs(y.numpy() - ry).max()
    err1 = np.abs(y1.numpy() - ry).max()
    assert err <= 1e-5 * scale, (err / scale, err1 / scale)
    assert err1 > 1e-5 * scale, (err / scale, err1 / scale)


@pytest.mark.parametrize("cin,route", [(64, "tf32"), (128, "tf32"),
                                       (256, "tf32"), (512, "tf32"),
                                       (32, "tf32"), (96, "tf32"),
                                       (3, "ffma"), (4, "ffma"), (8, "ffma"),
                                       (16, "ffma"), (48, "ffma"),
                                       (100, "ffma")])
def test_f32_route_by_cin(cin, route):
    """The fp32 route rule of kernels 1 and 5: three TF32 passes where Cin
    is a multiple of 32 (every layer of the full-width paths), the FFMA
    mainloop elsewhere (the D's Cin-3/4 layers, ``dcgan_mnist`` at ngf 8)."""
    from tpugan_torch.ops.kernel_common import f32_route

    assert f32_route(cin) == route


@pytest.mark.parametrize("cin,cout,path", [
    (1, 32, "tf32_narrow"), (3, 64, "tf32_narrow"), (4, 64, "tf32_narrow"),
    (16, 128, "tf32_narrow"), (3, 128, "tf32_narrow"), (32, 64, "tf32"),
    (64, 128, "tf32"), (96, 40, "tf32"), (256, 512, "tf32"),
    (17, 64, "ffma"), (48, 64, "ffma"), (100, 64, "ffma"),
    (3, 129, "ffma")])
def test_kernel4_f32_path_by_cin(cin, cout, path):
    """Kernel 4's fp32 route rule: three TF32 passes on the wide conv tile
    where Cin is a multiple of 32, on the narrow tile at Cin <= 16 with
    Cout <= 128 (every D's RGB layer: Cin 1, 3, 4), the FFMA mainloop only
    where neither tile takes the shape."""
    assert cuda_conv.f32_path(cin, cout) == path
