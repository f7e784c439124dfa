"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (decided inside
the ``cuda`` fixture, never at import).  On a machine with an H100:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q

Edge shapes the main path never gives (Cin not a multiple of the 64-deep
stage, Cout not a multiple of 8 or of the tile width, ragged row tiles, the
7x7 base, batches that do not fill a block, operands off 16-byte
alignment) are here, beside one main-path layer of each kernel at a small
batch; ``chip_smoke.py`` holds the kernels at the main path's own shapes.
The limits are chip_smoke.py's: they follow each layer's own scale, so a
kernel that drops a stage of the depth fails.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from tpugan_torch.configs import get_preset
from tpugan_torch.models.registry import build_generator
from tpugan_torch.ops import (cuda_conv, cuda_conv_stats, cuda_convt,
                               cuda_gen, cuda_gen2)

pytestmark = pytest.mark.cuda

BF = torch.bfloat16


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(shape, gen, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale)


def assert_bf16_close(got, ref):
    """Two bf16 results of the same bf16 products whose fp32 sums differ in
    order: one flipped rounding (2^-7 of the value) plus 1e-3 of the
    result's largest value (chip_smoke.bf16_err)."""
    err = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    assert bool((err <= 2.0 ** -7 * r + 1e-3 * r.max()).all()), (
        f"max err {err.max().item()}, largest value {r.max().item()}")


def assert_fp32_close(got, ref):
    """Two fp32 sums of the same bf16 products in another order: 1e-4 of
    the result's largest value (chip_smoke.fp32_err)."""
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), (
        f"max err {err}, largest value {ref.abs().max().item()}")


def assert_close_in(dtype, got, ref):
    if dtype == BF:
        assert_bf16_close(got, ref)
    else:
        assert_fp32_close(got, ref)


# (n, h, w, cin, cout): Cin 20 and 33 (padded to a multiple of 8), 16 and
# 72 (not a multiple of the 64-deep stage), Cout 7 and 3 (the four-phase
# kernel for few channels), 16 and 40 (one ragged 64-wide tile), 200 (a
# ragged second 128-wide tile), rows that leave a box part empty (3 images
# of 6 x 10, two per box), a row wider than a box (160), and the main path's
# first layer (4x4x512 -> 8x8x256) and RGB layer (32x32x64 -> 64x64x3)
CONVT_SHAPES = [(3, 5, 5, 20, 7), (2, 4, 4, 64, 16), (1, 7, 7, 33, 40),
                (5, 8, 8, 16, 3), (3, 6, 10, 72, 200), (1, 3, 160, 8, 16),
                (2, 4, 4, 512, 256), (2, 32, 32, 64, 3)]


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "none"])
@pytest.mark.parametrize("out_dtype", [torch.float32, BF])
@pytest.mark.parametrize("n,h,w,cin,cout", CONVT_SHAPES)
def test_convt_kernel_matches_plain(cuda, n, h, w, cin, cout, act, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(n * 100 + cin)
    x = _rand((n, h, w, cin), gen, cuda).to(BF)
    wt = _rand((4, 4, cin, cout), gen, cuda, 0.1).to(BF)
    a, b = _rand((cout,), gen, cuda), _rand((cout,), gen, cuda)
    before = cuda_convt.launches
    got = cuda_convt.convt_affine_act(x, wt, a, b, act=act, leak=0.1,
                                      out_dtype=out_dtype)
    assert cuda_convt.launches == before + 1
    ref = cuda_convt.convt_affine_act_plain(x, wt, a, b, act=act, leak=0.1,
                                            out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (n, 2 * h, 2 * w, cout)
    assert_close_in(out_dtype, got, ref)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 4, 4, 512, 256),
                                            (2, 32, 32, 64, 3)])
def test_convt_kernel_gives_the_same_bits_twice(cuda, n, h, w, cin, cout):
    """A missed mbarrier wait in the ring shows as a rare, order-dependent
    error: two runs of the same inputs must agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(cin + cout)
    x = _rand((n, h, w, cin), gen, cuda).to(BF)
    wt = _rand((4, 4, cin, cout), gen, cuda, 0.05).to(BF)
    a, b = _rand((cout,), gen, cuda), _rand((cout,), gen, cuda)
    runs = [cuda_convt.convt_affine_act(x, wt, a, b, act="none",
                                        out_dtype=torch.float32)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


def test_convt_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4, 4, 8, device=cuda)
    w = torch.zeros(4, 4, 8, 8, device=cuda)
    one, zero = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        cuda_convt.convt_affine_act(x, w, one, zero)
    with pytest.raises(ValueError, match="out_dtype"):
        cuda_convt.convt_affine_act(x.to(BF), w.to(BF), one, zero,
                                    out_dtype=torch.float16)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_convt.convt_affine_act(x.to(BF), w.to(BF).requires_grad_(),
                                    one, zero)


@pytest.mark.parametrize("preset,overrides,n", [
    ("dcgan_mnist", {"model.ngf": 24}, 3),
    ("dcgan_cifar10", {"model.ngf": 16, "model.g_batchnorm": False}, 5),
    ("cdcgan_celeba64", {"model.ngf": 8, "model.nz": 20,
                         "model.embed_dim": 6}, 7),
])
def test_megakernels_match_plain(cuda, preset, overrides, n):
    cfg = get_preset(preset).override(overrides)
    gen = torch.Generator(device=cuda).manual_seed(1)
    g = build_generator(cfg.model, device=cuda, generator=gen)
    with torch.no_grad():
        g.train()
        z = _rand((16, cfg.model.nz), gen, cuda)
        y = torch.arange(16, device=cuda) % max(cfg.model.n_classes, 1)
        g(z, y) if cfg.model.arch == "cdcgan" else g(z)
        g.eval()
        z, y = z[:n], (y[:n] if cfg.model.arch == "cdcgan" else None)
        head, blocks, (s0, c0), zz = cuda_gen2.fold_inputs(g, z, y)
        before = cuda_gen2.launches
        got2 = cuda_gen2.generator_forward(g, z, y)
        assert cuda_gen2.launches == before + 1
        ref2 = cuda_gen2.depth_to_space(
            cuda_gen2.generator_forward_plain(zz, head, blocks, s0, c0))
        torch.cuda.synchronize()
        # fp32 activations, bf16 matmul operands: sum-order ulps only
        torch.testing.assert_close(got2, ref2, rtol=0, atol=3e-3)
        if y is None:
            got1 = cuda_gen.generator_forward(g, z)
            ref1 = cuda_gen.generator_forward_plain(zz, head, blocks, s0, c0)
            # bf16 activations and image: a flipped rounding moves a pixel
            err = (got1 - ref1).abs()
            assert err.max().item() <= 5e-2 and err.mean().item() <= 2e-3
        img = np.asarray(got2.cpu())
        assert img.shape == (n, cfg.model.image_size, cfg.model.image_size,
                             cfg.model.channels)
        # each image is computed alone: a batch of one gives the same bits
        one = cuda_gen2.generator_forward(g, z[:1], None if y is None
                                          else y[:1])
        assert torch.equal(one, got2[:1])


# (n, h, w, cin, cout): Cin 3 (depth 48) and 33 (not a multiple of the
# 32-deep step), Cout not a multiple of 16, rows not a multiple of the
# 64-row tile (3 * 5 * 3 = 45, 1 * 2 * 1 = 2), batch 1, and the aligned,
# 16-byte-staged case (Cin 64, Cout 128)
CONV_SHAPES = [(3, 10, 6, 3, 7), (2, 8, 8, 33, 40), (1, 4, 2, 16, 3),
               (1, 16, 16, 64, 128), (5, 6, 6, 32, 24)]
# and for the conv + BN-statistics kernel: Cin 96 (padded to 128), Cout 136
# (a ragged second 128-wide tile), 3 output grids of 6 x 10 (two per box),
# and the main path's first and last BN layers at batch 2 and 4
# (32x32x64 -> 16x16x128, whose depth splits over a cluster of 2 blocks;
# 8x8x256 -> 4x4x512, over a cluster of 4)
STATS_SHAPES = CONV_SHAPES + [(3, 12, 20, 96, 136), (2, 32, 32, 64, 128),
                              (4, 8, 8, 256, 512)]


def _conv_operands(cuda, n, h, w, cin, cout, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = _rand((n, h, w, cin), gen, cuda).to(BF)
    wt = _rand((4, 4, cin, cout), gen, cuda, 0.1).to(BF)
    return gen, x, wt


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "tanh", "none"])
@pytest.mark.parametrize("out_dtype", [torch.float32, BF])
@pytest.mark.parametrize("n,h,w,cin,cout", CONV_SHAPES)
def test_conv_kernel_matches_plain(cuda, n, h, w, cin, cout, act, out_dtype):
    gen, x, wt = _conv_operands(cuda, n, h, w, cin, cout, n * 100 + cin)
    a, b = _rand((cout,), gen, cuda), _rand((cout,), gen, cuda)
    before = cuda_conv.launches
    got = cuda_conv.conv_affine_act(x, wt, a, b, act=act, leak=0.1,
                                    out_dtype=out_dtype)
    assert cuda_conv.launches == before + 1
    ref = cuda_conv.conv_affine_act_plain(x, wt, a, b, act=act, leak=0.1,
                                          out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (n, h // 2, w // 2, cout)
    # same bf16 products; fp32 sums in another order (~1e-6 relative), and
    # for a bf16 output one flipped rounding (2^-8 relative)
    tol = 1e-2 if out_dtype == BF else 1e-4
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,h,w,cin,cout", STATS_SHAPES)
def test_conv_stats_kernel_matches_plain(cuda, n, h, w, cin, cout):
    _, x, wt = _conv_operands(cuda, n, h, w, cin, cout, n * 10 + cout)
    x = (x.float() + 0.5).to(BF)  # an offset mean: E[y^2] - mean^2 cancels
    before = cuda_conv_stats.launches
    y, mean, var = cuda_conv_stats.conv_stats(x, wt)
    assert cuda_conv_stats.launches == before + 1
    yr, mr, vr = cuda_conv_stats.conv_stats_plain(x, wt)
    torch.cuda.synchronize()
    assert y.dtype == BF
    assert_bf16_close(y, yr)
    # statistics from the fp32 sums on both sides: sum order only, and
    # var = E[y^2] - mean^2 loses a few bits to cancellation
    torch.testing.assert_close(mean, mr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(var, vr, rtol=1e-3, atol=1e-5)
    assert bool((var >= 0).all())
    # no atomics: the same bits on a second run
    y2, mean2, var2 = cuda_conv_stats.conv_stats(x, wt)
    assert torch.equal(y, y2) and torch.equal(mean, mean2)
    assert torch.equal(var, var2)


def test_conv_kernels_take_unaligned_operands(cuda):
    """Operands 2 bytes off 16-byte alignment take the scalar staging."""
    n, h, w, cin, cout = 2, 8, 8, 64, 32
    _, x, wt = _conv_operands(cuda, n, h, w, cin, cout, 5)
    xs = torch.empty(x.numel() + 1, dtype=BF, device=cuda)[1:].view(x.shape)
    ws = torch.empty(wt.numel() + 1, dtype=BF, device=cuda)[1:].view(wt.shape)
    xs.copy_(x)
    ws.copy_(wt)
    assert xs.data_ptr() % 16 and ws.data_ptr() % 16
    one = torch.ones(cout, device=cuda)
    zero = torch.zeros(cout, device=cuda)
    got = cuda_conv.conv_affine_act(xs, ws, one, zero, act="none",
                                    out_dtype=torch.float32)
    ref = cuda_conv.conv_affine_act(x, wt, one, zero, act="none",
                                    out_dtype=torch.float32)
    y, _, _ = cuda_conv_stats.conv_stats(xs, ws)
    y_ref, _, _ = cuda_conv_stats.conv_stats(x, wt)
    torch.cuda.synchronize()
    # the same products summed in the same order: the same bits
    assert torch.equal(got, ref) and torch.equal(y, y_ref)


def test_conv_bn_stats_backward_matches_autograd_of_plain(cuda):
    """The fused op's backward (PyTorch conv gradients of the unfused VJP)
    against autograd through the plain composition, in fp32."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x32 = _rand((4, 16, 16, 32), gen, cuda)
    w32 = _rand((4, 4, 32, 48), gen, cuda, 0.05)
    cw = _rand((48,), gen, cuda)

    def loss(y, m, v):
        return ((torch.tanh(y.float()) * cw).sum() + (m * cw ** 2).sum()
                + torch.sqrt(v + 1.0).sum())

    xr, wr = x32.clone().requires_grad_(), w32.clone().requires_grad_()
    y = cuda_conv.conv421_plain(xr, wr)
    m = y.mean(dim=(0, 1, 2))
    v = torch.clamp((y * y).mean(dim=(0, 1, 2)) - m * m, min=0.0)
    gx_ref, gw_ref = torch.autograd.grad(loss(y, m, v), (xr, wr))
    # the kernel takes bf16: bf16 operands, gradients in bf16 as JAX's VJP
    xb = x32.to(BF).requires_grad_()
    wb = w32.to(BF).requires_grad_()
    before = cuda_conv_stats.launches
    gx, gw = torch.autograd.grad(loss(*cuda_conv_stats.conv_bn_stats(xb, wb)),
                                 (xb, wb))
    assert cuda_conv_stats.launches == before + 1
    torch.cuda.synchronize()
    assert gx.dtype == BF and gw.dtype == BF
    # bf16 operands (2^-8 relative) and a bf16 cotangent and gradient:
    # a few percent of each gradient's scale
    for got, ref in ((gx, gx_ref), (gw, gw_ref)):
        err = (got.float() - ref).abs().max().item()
        assert err <= 3e-2 * ref.abs().max().item(), err


def test_conv_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(2, 8, 8, 8, device=cuda)
    w = torch.zeros(4, 4, 8, 8, device=cuda)
    one, zero = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        cuda_conv.conv_affine_act(x, w, one, zero)
    with pytest.raises(ValueError, match="bf16"):
        cuda_conv_stats.conv_stats(x, w)
    with pytest.raises(ValueError, match="out_dtype"):
        cuda_conv.conv_affine_act(x.to(BF), w.to(BF), one, zero,
                                  out_dtype=torch.float16)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv.conv_affine_act(x.to(BF), w.to(BF).requires_grad_(), one,
                                  zero)
