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
from tpugan_torch.ops.kernel_common import f32_route

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


def assert_image_close(got, ref):
    """A megakernel's image against its plain version: the same bf16
    products, fp32 sums in another order, which may flip an activation's
    bf16 rounding in any layer, compounding through the layers after it:
    2^-7 |ref| + 1e-2 of the image's largest value (chip_smoke.image_err).
    """
    err = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    assert bool((err <= 2.0 ** -7 * r + 1e-2 * r.max()).all()), (
        f"max err {err.max().item()}, largest value {r.max().item()}")


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
    # fp32 operands run the fp32 kernel; fp16 and mixed dtypes are refused
    before = cuda_convt.launches
    cuda_convt.convt_affine_act(x, w, one, zero)
    assert cuda_convt.launches == before + 1
    for xd, wd in ((torch.float16, torch.float16), (torch.float32, BF)):
        with pytest.raises(ValueError, match="one dtype, bf16 or fp32"):
            cuda_convt.convt_affine_act(x.to(xd), w.to(wd), one, zero)
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
            before = cuda_gen.launches
            got1 = cuda_gen.generator_forward(g, z)
            assert cuda_gen.launches == before + 1
            ref1 = cuda_gen.generator_forward_plain(zz, head, blocks, s0, c0)
            torch.cuda.synchronize()
            assert got1.shape == got2.shape
            assert_image_close(got1, ref1)
            assert torch.equal(cuda_gen.generator_forward(g, z[:1]), got1[:1])
        img = np.asarray(got2.cpu())
        assert img.shape == (n, cfg.model.image_size, cfg.model.image_size,
                             cfg.model.channels)
        # each image is computed alone: a batch of one gives the same bits
        one = cuda_gen2.generator_forward(g, z[:1], None if y is None
                                          else y[:1])
        assert torch.equal(one, got2[:1])


def _seeded_generator(cuda, preset, overrides, seed, batch):
    """An eval-mode generator of random weights, its BN statistics from one
    train-mode forward, and a batch of z."""
    cfg = get_preset(preset).override(overrides)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    g = build_generator(cfg.model, device=cuda, generator=gen)
    with torch.no_grad():
        g.train()
        g(_rand((max(batch, 8), cfg.model.nz), gen, cuda))
    return g.eval(), _rand((batch, cfg.model.nz), gen, cuda)


# unconditional generators: the 7 x 7 base and a 1-channel image, no BN
# (Cout 3 at ngf 16), the wide last layer (Cin 160), full width at 64 px
UNCOND = [("dcgan_mnist", {"model.ngf": 24}, 3),
          ("dcgan_cifar10", {"model.ngf": 16, "model.g_batchnorm": False}, 5),
          ("dcgan_cifar10", {"model.ngf": 160, "model.nz": 12}, 3),
          ("dcgan_celeba64", {}, 9)]


@pytest.mark.parametrize("preset,overrides,n", UNCOND)
def test_megakernel_v1_is_v2_rounded_to_bf16(cuda, preset, overrides, n):
    """Both megakernels run the same tiles in the same sum order and differ
    only in the image's epilogue: v1's image is v2's rounded to bf16 (to
    nearest, ties to even, as torch rounds), bit for bit, and every v1
    value is a bf16's."""
    g, z = _seeded_generator(cuda, preset, overrides, 6, n)
    with torch.no_grad():
        got1 = cuda_gen.generator_forward(g, z)
        got2 = cuda_gen2.generator_forward(g, z)
        torch.cuda.synchronize()
    assert torch.equal(got1, got1.to(BF).float())
    assert torch.equal(got1, got2.to(BF).float())


def test_megakernel_v1_takes_a_wide_last_layer(cuda):
    """A last layer of Cout <= 8 whose Cin is more than two 64-channel
    chunks runs the wide tile (Cout padded to 8 in w), its values rounded
    to bf16 in registers and written element by element into the (n, S, S,
    C) image."""
    g, z = _seeded_generator(cuda, "dcgan_cifar10",
                             {"model.ngf": 160, "model.nz": 12}, 4, 3)
    with torch.no_grad():
        head, blocks, (s0, c0) = cuda_gen.fold_generator(g)
        assert blocks[-1][0].shape[2] == 160 and blocks[-1][0].shape[3] == 3
        assert cuda_gen.layer_kinds(s0, c0, [w.shape[3] for w, _, _ in
                                             blocks])[-1] == cuda_gen.WIDE
        got = cuda_gen.generator_forward(g, z)
        ref = cuda_gen.generator_forward_plain(z, head, blocks, s0, c0)
        one = cuda_gen.generator_forward(g, z[:1])
        torch.cuda.synchronize()
    assert got.shape == (3, 32, 32, 3)
    assert_image_close(got, ref)
    assert torch.equal(one, got[:1])


def test_megakernel_v2_takes_a_wide_last_layer(cuda):
    """A last layer of Cout <= 8 whose Cin is more than two 64-channel
    chunks runs the wide tile (Cout padded to 8 in w), written element by
    element into the phased fp32 image."""
    g, z = _seeded_generator(cuda, "dcgan_cifar10",
                             {"model.ngf": 160, "model.nz": 12}, 4, 3)
    with torch.no_grad():
        head, blocks, (s0, c0), zz = cuda_gen2.fold_inputs(g, z)
        assert blocks[-1][0].shape[2] == 160 and blocks[-1][0].shape[3] == 3
        got = cuda_gen2.generator_forward(g, z)
        ref = cuda_gen2.depth_to_space(
            cuda_gen2.generator_forward_plain(zz, head, blocks, s0, c0))
        one = cuda_gen2.generator_forward(g, z[:1])
        torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0, atol=3e-3)
    assert torch.equal(one, got[:1])


def _launches_agree(cuda, mod):
    """20 launches of megakernel ``mod`` (cuda_gen or cuda_gen2) on the
    full-width 64 px generator at batch 64 agree bit for bit."""
    g, z = _seeded_generator(cuda, "dcgan_celeba64", {}, 3, 64)
    with torch.no_grad():
        before = mod.launches
        runs = [mod.generator_forward(g, z) for _ in range(20)]
        torch.cuda.synchronize()
    assert mod.launches == before + 20
    assert bool(torch.isfinite(runs[0]).all())
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


def test_megakernel_v1_gives_the_same_bits_repeatedly(cuda):
    """As v2's test below, for v1's instantiation of the walk."""
    _launches_agree(cuda, cuda_gen)


def test_megakernel_v2_gives_the_same_bits_repeatedly(cuda):
    """A missing proxy fence or grid-barrier ordering shows as a stale tile
    on some runs only: 20 launches must agree bit for bit."""
    _launches_agree(cuda, cuda_gen2)


# (n, h, w, cin, cout): Cin 3 (the narrow path, depth 48) and 16 (narrow,
# depth 256: four A stages), 33 and 32 (the wide path, padded to 64), Cout
# not a multiple of 8 or of the tile width, boxes left part empty (3
# images of 5 x 3 outputs, 1 x 2 x 1), batch 1, and Cin 64 (wide, no copy)
CONV_SHAPES = [(3, 10, 6, 3, 7), (2, 8, 8, 33, 40), (1, 4, 2, 16, 3),
               (1, 16, 16, 64, 128), (5, 6, 6, 32, 24)]
# the discriminator's four layers (ndf 64) at batch 2 to 4: the narrow
# RGB layer and three wide ones, the last split over a cluster of 4
D_SHAPES = [(2, 64, 64, 3, 64), (2, 32, 32, 64, 128), (3, 16, 16, 128, 256),
            (4, 8, 8, 256, 512)]
# the conditional D's first layer (image + label plane, Cin 4: narrow) and
# the 32 px D's three layers (sngan / wgan_gp, ndf 64) at batch 2
NEW_D_SHAPES = [(2, 64, 64, 4, 64), (2, 32, 32, 3, 64), (2, 16, 16, 64, 128),
                (2, 8, 8, 128, 256)]
# and for the conv + BN-statistics kernel: Cin 96 (padded to 128), Cout 136
# (a ragged second 128-wide tile), 3 output grids of 6 x 10 (two per box),
# and the main path's first and last BN layers at batch 2 and 4
# (32x32x64 -> 16x16x128, whose depth splits over a cluster of 2 blocks;
# 8x8x256 -> 4x4x512, over a cluster of 4)
STATS_SHAPES = CONV_SHAPES + [(3, 12, 20, 96, 136), (2, 32, 32, 64, 128),
                              (4, 8, 8, 256, 512)]
# the main path's three BN layers at the flagship's batch (256,
# dcgan_celeba64_fast) and at a grad_accum=2 microbatch of 128 (64)
BATCH_STATS_SHAPES = [(n, h, h, cin, 2 * cin) for n in (256, 64)
                      for h, cin in ((32, 64), (16, 128), (8, 256))]


def _conv_operands(cuda, n, h, w, cin, cout, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = _rand((n, h, w, cin), gen, cuda).to(BF)
    wt = _rand((4, 4, cin, cout), gen, cuda, 0.1).to(BF)
    return gen, x, wt


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "tanh", "none"])
@pytest.mark.parametrize("out_dtype", [torch.float32, BF])
@pytest.mark.parametrize("n,h,w,cin,cout",
                         CONV_SHAPES + D_SHAPES + NEW_D_SHAPES)
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
    assert_close_in(out_dtype, got, ref)


@pytest.mark.parametrize("n,h,w,cin,cout", D_SHAPES)
def test_conv_kernel_gives_the_same_bits_twice(cuda, n, h, w, cin, cout):
    """No atomics, a fixed split-K order: two runs agree bit for bit."""
    gen, x, wt = _conv_operands(cuda, n, h, w, cin, cout, cin + cout)
    a, b = _rand((cout,), gen, cuda), _rand((cout,), gen, cuda)
    runs = [cuda_conv.conv_affine_act(x, wt, a, b, act="none",
                                      out_dtype=torch.float32)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("n,h,w,cin,cout", STATS_SHAPES + BATCH_STATS_SHAPES)
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
    """Operands 2 bytes off 16-byte alignment: the wrappers copy them for
    TMA (wide path) and the narrow path reads them as they are."""
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
    _, x3, w3 = _conv_operands(cuda, n, h, w, 3, cout, 6)
    x3s = torch.empty(x3.numel() + 1, dtype=BF, device=cuda)[1:]
    w3s = torch.empty(w3.numel() + 1, dtype=BF, device=cuda)[1:]
    x3s = x3s.view(x3.shape).copy_(x3)
    w3s = w3s.view(w3.shape).copy_(w3)
    got3 = cuda_conv.conv_affine_act(x3s, w3s, one, zero, act="none",
                                     out_dtype=torch.float32)
    ref3 = cuda_conv.conv_affine_act(x3, w3, one, zero, act="none",
                                     out_dtype=torch.float32)
    torch.cuda.synchronize()
    # the same products summed in the same order: the same bits
    assert torch.equal(got, ref) and torch.equal(y, y_ref)
    assert torch.equal(got3, ref3)


# ---------------------------------------------------------------------------
# fp32 operands (train.precision="fp32"): kernels 1, 4 and 5 by three TF32
# passes where Cin is a multiple of 32, kernel 4 also on its narrow TF32
# tile at Cin <= 16 with Cout <= 128, else the FFMA kernels of
# igemm_f32.cuh
# ---------------------------------------------------------------------------

F32 = torch.float32


@pytest.fixture()
def cuda_f32(cuda):
    """The card with TF32 off in cuDNN too, so that every fp32 reference
    (the plain versions' matmuls, PyTorch's conv gradients) is full fp32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = prev


def assert_f32_kernel_close(got, ref, scale=None):
    """An fp32 kernel against its plain version: the same fp32 products,
    fp32 sums in another order (~sqrt(depth) 2^-24 of the layer's scale at
    depth <= 4096): 1e-5 of the layer's largest |value| (chip_smoke's
    f32_check), ``scale`` where given: the largest before a tanh, which
    squeezes the result's largest towards 1 but passes a difference in its
    argument through at a slope up to 1.  A TF32 product errs ~3e-4 of
    it."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item() if scale is None else scale
    assert err <= 1e-5 * scale, f"max err {err}, scale {scale}"


def _pre_tanh_scale(plain, act, *args, **kw):
    """The layer's largest |value| before the activation, for a tanh."""
    if act != "tanh":
        return None
    return plain(*args, act="none", **kw).abs().max().item()


def _f32_operands(cuda, n, h, w, cin, cout, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = _rand((n, h, w, cin), gen, cuda)
    wt = _rand((4, 4, cin, cout), gen, cuda, 0.1)
    return gen, x, wt


# the main path's layers (batch cut to 2) and edge shapes: Cin 1, 3, 5 and
# 33 (not a multiple of 4: 4-byte copies), Cout 1, 3, 7 and 40 (the narrow
# tile; a ragged 64-wide tile), a row wider than a tile (160), batch 1
CONVT_F32_SHAPES = CONVT_SHAPES + [(2, 3, 160, 5, 1), (1, 6, 6, 1, 12)]
CONV_F32_SHAPES = CONV_SHAPES + D_SHAPES + NEW_D_SHAPES + [
    (2, 6, 10, 1, 1), (1, 2, 2, 5, 9)]


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "none"])
@pytest.mark.parametrize("out_dtype", [F32, BF])
@pytest.mark.parametrize("n,h,w,cin,cout", CONVT_F32_SHAPES)
def test_convt_f32_kernel_matches_plain(cuda_f32, n, h, w, cin, cout, act,
                                        out_dtype):
    gen, x, wt = _f32_operands(cuda_f32, n, h, w, cin, cout, n * 100 + cin)
    a, b = _rand((cout,), gen, cuda_f32), _rand((cout,), gen, cuda_f32)
    before = cuda_convt.launches
    got = cuda_convt.convt_affine_act(x, wt, a, b, act=act, leak=0.1,
                                      out_dtype=out_dtype)
    assert cuda_convt.launches == before + 1
    ref = cuda_convt.convt_affine_act_plain(x, wt, a, b, act=act, leak=0.1,
                                            out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (n, 2 * h, 2 * w, cout)
    if out_dtype == F32:
        assert_f32_kernel_close(got, ref, _pre_tanh_scale(
            cuda_convt.convt_affine_act_plain, act, x, wt, a, b))
    else:
        assert_bf16_close(got, ref)


@pytest.mark.parametrize("act", ["leaky_relu", "tanh"])
@pytest.mark.parametrize("out_dtype", [F32, BF])
@pytest.mark.parametrize("n,h,w,cin,cout", CONV_F32_SHAPES)
def test_conv_f32_kernel_matches_plain(cuda_f32, n, h, w, cin, cout, act,
                                       out_dtype):
    gen, x, wt = _f32_operands(cuda_f32, n, h, w, cin, cout, n * 10 + cin)
    a, b = _rand((cout,), gen, cuda_f32), _rand((cout,), gen, cuda_f32)
    before = cuda_conv.launches
    got = cuda_conv.conv_affine_act(x, wt, a, b, act=act, leak=0.1,
                                    out_dtype=out_dtype)
    assert cuda_conv.launches == before + 1
    ref = cuda_conv.conv_affine_act_plain(x, wt, a, b, act=act, leak=0.1,
                                          out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (n, h // 2, w // 2, cout)
    if out_dtype == F32:
        assert_f32_kernel_close(got, ref, _pre_tanh_scale(
            cuda_conv.conv_affine_act_plain, act, x, wt, a, b))
    else:
        assert_bf16_close(got, ref)


@pytest.mark.parametrize("n,h,w,cin,cout",
                         CONV_SHAPES + [(3, 12, 20, 96, 136),
                                        (2, 6, 10, 1, 1)]
                         + BATCH_STATS_SHAPES)
def test_conv_stats_f32_kernel_matches_plain(cuda_f32, n, h, w, cin, cout):
    _, x, wt = _f32_operands(cuda_f32, n, h, w, cin, cout, n * 10 + cout)
    x = x + 0.5  # an offset mean: E[y^2] - mean^2 cancels
    before = cuda_conv_stats.launches
    y, mean, var = cuda_conv_stats.conv_stats(x, wt)
    assert cuda_conv_stats.launches == before + 1
    yr, mr, vr = cuda_conv_stats.conv_stats_plain(x, wt)
    torch.cuda.synchronize()
    assert y.dtype == F32
    assert_f32_kernel_close(y, yr)
    # the statistics of the fp32 sums on both sides, summed in another
    # order: the mean within 1e-5 of y's largest, the variance within 1e-5
    # of the largest second moment E[y^2] (its cancellation's scale)
    scale = yr.abs().max().item()
    assert (mean - mr).abs().max().item() <= 1e-5 * scale
    assert (var - vr).abs().max().item() <= 1e-5 * (vr + mr * mr).max().item()
    assert bool((var >= 0).all())
    # no atomics: the same bits on a second run
    y2, mean2, var2 = cuda_conv_stats.conv_stats(x, wt)
    assert torch.equal(y, y2) and torch.equal(mean, mean2)
    assert torch.equal(var, var2)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 4, 4, 512, 256),
                                            (2, 32, 32, 64, 3),
                                            (4, 8, 8, 256, 512)])
def test_f32_kernels_give_the_same_bits_twice(cuda_f32, n, h, w, cin, cout):
    """Each thread sums its depth in order, with no atomics: two runs of
    kernels 1 and 4 agree bit for bit."""
    gen, x, wt = _f32_operands(cuda_f32, n, h, w, cin, cout, cin + cout)
    a, b = _rand((cout,), gen, cuda_f32), _rand((cout,), gen, cuda_f32)
    for fn in (cuda_convt.convt_affine_act, cuda_conv.conv_affine_act):
        runs = [fn(x, wt, a, b, act="none") for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])


def test_f32_kernels_take_unaligned_operands(cuda_f32):
    """fp32 operands 4 bytes off 16-byte alignment at Cin 64, on each
    kernel's TF32 route (x copied for TMA, w read as it is by the weight
    split): the same values."""
    n, h, w, cin, cout = 2, 8, 8, 64, 32
    gen, x, wt = _f32_operands(cuda_f32, n, h, w, cin, cout, 9)
    xs = torch.empty(x.numel() + 1, device=cuda_f32)[1:].view(x.shape)
    ws = torch.empty(wt.numel() + 1, device=cuda_f32)[1:].view(wt.shape)
    xs.copy_(x)
    ws.copy_(wt)
    assert xs.data_ptr() % 16 and ws.data_ptr() % 16
    a, b = _rand((cout,), gen, cuda_f32), _rand((cout,), gen, cuda_f32)
    for fn in (cuda_convt.convt_affine_act, cuda_conv.conv_affine_act):
        got, ref = fn(xs, ws, a, b, act="none"), fn(x, wt, a, b, act="none")
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
    got = cuda_conv_stats.conv_stats(xs, ws)
    ref = cuda_conv_stats.conv_stats(x, wt)
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


# the three-pass TF32 route of kernels 1 and 5 (Cin a multiple of 32):
# Cout 3 and 8 (kernel 1's 8-wide tile), 40 (a ragged 64-wide tile) and 136
# (a ragged second 128-wide tile), Cin 32, 64 and 96, batch 1; for kernel
# 1's narrow tile (Cout <= 4, Cin <= 64) a box of 126 rows (14 x 9), boxes
# of 5 images, and the shapes it leaves to the 8-wide tile: a halo too
# large (a 160-wide row) and Cin 128
TF32_CONVT_SHAPES = [(1, 4, 4, 32, 3), (2, 8, 8, 64, 8), (2, 5, 7, 32, 40),
                     (1, 6, 6, 64, 136), (3, 4, 4, 96, 128),
                     (3, 14, 14, 64, 1), (5, 2, 2, 64, 2), (2, 3, 160, 32, 4),
                     (1, 6, 6, 128, 3)]
TF32_STATS_SHAPES = [(1, 8, 8, 32, 3), (2, 8, 8, 64, 8), (2, 10, 6, 32, 40),
                     (1, 8, 8, 64, 136), (3, 16, 16, 96, 256)]


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("out_dtype", [F32, BF])
@pytest.mark.parametrize("n,h,w,cin,cout", TF32_CONVT_SHAPES)
def test_convt_tf32_route_matches_plain(cuda_f32, n, h, w, cin, cout, act,
                                        out_dtype):
    assert f32_route(cin) == "tf32"
    gen, x, wt = _f32_operands(cuda_f32, n, h, w, cin, cout, cin + cout)
    a, b = _rand((cout,), gen, cuda_f32), _rand((cout,), gen, cuda_f32)
    before = cuda_convt.launches
    got = cuda_convt.convt_affine_act(x, wt, a, b, act=act,
                                      out_dtype=out_dtype)
    again = cuda_convt.convt_affine_act(x, wt, a, b, act=act,
                                        out_dtype=out_dtype)
    assert cuda_convt.launches == before + 2
    ref = cuda_convt.convt_affine_act_plain(x, wt, a, b, act=act,
                                            out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (n, 2 * h, 2 * w, cout)
    assert torch.equal(got, again)
    if out_dtype == F32:
        assert_f32_kernel_close(got, ref, _pre_tanh_scale(
            cuda_convt.convt_affine_act_plain, act, x, wt, a, b))
    else:
        assert_bf16_close(got, ref)


@pytest.mark.parametrize("splits", [None, 1, 2, 4])
@pytest.mark.parametrize("n,h,w,cin,cout", TF32_STATS_SHAPES)
def test_conv_stats_tf32_route_matches_plain(cuda_f32, n, h, w, cin, cout,
                                             splits):
    """Kernel 5 on the TF32 route, at its planned depth split and at 1, 2
    and 4 (``_launch(..., splits=)``), against its plain version; two runs
    give the same bits."""
    assert f32_route(cin) == "tf32"
    _, x, wt = _f32_operands(cuda_f32, n, h, w, cin, cout, cin * cout)
    x = x + 0.5  # an offset mean: E[y^2] - mean^2 cancels
    before = cuda_conv_stats.launches
    runs = [cuda_conv_stats._launch(x, wt, splits=splits) for _ in range(2)]
    assert cuda_conv_stats.launches == before + 2
    yr, mr, vr = cuda_conv_stats.conv_stats_plain(x, wt)
    torch.cuda.synchronize()
    (y, mean, var), again = runs
    assert y.dtype == F32 and y.shape == (n, h // 2, w // 2, cout)
    assert_f32_kernel_close(y, yr)
    scale = yr.abs().max().item()
    assert (mean - mr).abs().max().item() <= 1e-5 * scale
    assert (var - vr).abs().max().item() <= 1e-5 * (vr + mr * mr).max().item()
    assert all(torch.equal(u, v) for u, v in zip(runs[0], again))


# (cin, route of kernels 1 and 5, route of kernel 4 at Cout 16): the fp32
# route each Cin takes, decided before the launch
F32_ROUTES = [(64, "tf32", "tf32"), (32, "tf32", "tf32"),
              (96, "tf32", "tf32"), (8, "ffma", "tf32_narrow"),
              (3, "ffma", "tf32_narrow"), (48, "ffma", "ffma"),
              (1, "ffma", "tf32_narrow"), (16, "ffma", "tf32_narrow"),
              (20, "ffma", "ffma")]
ENTRY_SUFFIX = {"tf32": "tf32", "tf32_narrow": "tf32_narrow", "ffma": "f32"}


def test_f32_shapes_take_their_route(cuda_f32, monkeypatch):
    """Each fp32 shape launches its route's entry point and no other:
    three TF32 passes where Cin is a multiple of 32, kernel 4's narrow
    TF32 tile at Cin <= 16, the FFMA mainloop elsewhere
    (``kernel_common.f32_route``, ``cuda_conv.f32_path``)."""
    called = []
    entries = {cuda_convt: ("tg_convt_affine_act_tf32",
                            "tg_convt_affine_act_f32"),
               cuda_conv_stats: ("tg_conv_stats_tf32", "tg_conv_stats_f32"),
               cuda_conv: ("tg_conv_affine_act_tf32",
                           "tg_conv_affine_act_tf32_narrow",
                           "tg_conv_affine_act_f32")}
    for mod, names in entries.items():
        lib = mod._lib()
        for name in names:
            monkeypatch.setattr(lib, name, lambda *a, fn=getattr(lib, name),
                                name=name: called.append(name) or fn(*a))
    for cin, route, path in F32_ROUTES:
        assert f32_route(cin) == route
        assert cuda_conv.f32_path(cin, 16) == path
        gen, x, wt = _f32_operands(cuda_f32, 2, 8, 8, cin, 16, cin)
        one = torch.ones(16, device=cuda_f32)
        called.clear()
        cuda_convt.convt_affine_act(x, wt, one, 0 * one)
        cuda_conv_stats.conv_stats(x, wt)
        cuda_conv.conv_affine_act(x, wt, one, 0 * one)
        torch.cuda.synchronize()
        suffix = ENTRY_SUFFIX[route]
        assert called == [f"tg_convt_affine_act_{suffix}",
                          f"tg_conv_stats_{suffix}",
                          f"tg_conv_affine_act_{ENTRY_SUFFIX[path]}"], (
            cin, called)


def test_tf32_route_launch_failure_raises(cuda_f32, monkeypatch):
    """A launch the TF32 route refuses (here a Cin it does not take, sent
    to it by a patched rule) raises; nothing falls back to the FFMA
    mainloop or the plain version, and no launch is counted."""
    for mod in (cuda_convt, cuda_conv_stats):
        monkeypatch.setattr(mod, "f32_route", lambda cin: "tf32")
    gen, x, wt = _f32_operands(cuda_f32, 2, 8, 8, 8, 16, 5)
    one = torch.ones(16, device=cuda_f32)
    before = (cuda_convt.launches, cuda_conv_stats.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_convt.convt_affine_act(x, wt, one, 0 * one)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_conv_stats.conv_stats(x, wt)
    assert (cuda_convt.launches, cuda_conv_stats.launches) == before


# kernel 4's two TF32 tiles: the eval D's four layers (batch 2-4, the last
# split over a cluster), the conditional D's Cin-4 layer and dcgan_mnist's
# Cin-1 layer; the narrow tile at Cin 1, 3, 4, 5, 8 and 16 (Cin above 4:
# one stage at a time) with Cout 1, 7, 65 (a ragged second chunk), 100
# and 128, odd batches, non-square maps, a 2x2 map in boxes of 128 images
# (the largest window); the wide tile at Cin 32 and 96 with Cout 24, 40
# and 136 (a ragged 64- or 128-wide tile)
TF32_CONV_SHAPES = D_SHAPES + [
    (2, 64, 64, 4, 64), (2, 28, 28, 1, 32), (3, 10, 6, 3, 7),
    (1, 4, 2, 16, 3), (3, 14, 10, 16, 128), (1, 6, 4, 8, 100),
    (2, 2, 2, 1, 1), (3, 6, 10, 4, 65), (1, 2, 2, 5, 9),
    (129, 2, 2, 16, 64), (128, 2, 2, 4, 128), (5, 6, 6, 32, 24),
    (1, 8, 8, 32, 40), (3, 12, 20, 96, 136)]


@pytest.mark.parametrize("act", ["leaky_relu", "relu", "tanh", "none"])
@pytest.mark.parametrize("out_dtype", [F32, BF])
@pytest.mark.parametrize("n,h,w,cin,cout", TF32_CONV_SHAPES)
def test_conv_tf32_routes_match_plain(cuda_f32, n, h, w, cin, cout, act,
                                      out_dtype):
    """Kernel 4 on its TF32 routes against its plain version, every
    activation, fp32 and bf16 out; two runs give the same bits."""
    assert cuda_conv.f32_path(cin, cout) in ("tf32", "tf32_narrow")
    gen, x, wt = _f32_operands(cuda_f32, n, h, w, cin, cout, cin + cout + n)
    a, b = _rand((cout,), gen, cuda_f32), _rand((cout,), gen, cuda_f32)
    before = cuda_conv.launches
    runs = [cuda_conv.conv_affine_act(x, wt, a, b, act=act, leak=0.1,
                                      out_dtype=out_dtype) for _ in range(2)]
    assert cuda_conv.launches == before + 2
    ref = cuda_conv.conv_affine_act_plain(x, wt, a, b, act=act, leak=0.1,
                                          out_dtype=out_dtype)
    torch.cuda.synchronize()
    got = runs[0]
    assert got.dtype == out_dtype and got.shape == (n, h // 2, w // 2, cout)
    assert torch.equal(got, runs[1])
    if out_dtype == F32:
        assert_f32_kernel_close(got, ref, _pre_tanh_scale(
            cuda_conv.conv_affine_act_plain, act, x, wt, a, b, leak=0.1))
    else:
        assert_bf16_close(got, ref)


@pytest.mark.parametrize("splits", [None, 1, 2, 4])
@pytest.mark.parametrize("n,h,w,cin,cout", [(4, 8, 8, 256, 512),
                                            (1, 8, 8, 64, 136),
                                            (2, 10, 6, 32, 40)])
def test_conv_tf32_route_splits_give_the_same_bits(cuda_f32, n, h, w, cin,
                                                   cout, splits):
    """Kernel 4's wide TF32 route at its planned depth split and at 1, 2
    and 4 (``_launch(..., splits=)``): the affine and the activation after
    the cluster's rank-ordered reduction, so two runs give the same bits,
    within the fp32 limit of the plain version."""
    gen, x, wt = _f32_operands(cuda_f32, n, h, w, cin, cout, cin * cout)
    a, b = _rand((cout,), gen, cuda_f32), _rand((cout,), gen, cuda_f32)
    runs = [cuda_conv._launch(x, wt, a, b, "leaky_relu", 0.2, F32,
                              splits=splits) for _ in range(2)]
    ref = cuda_conv.conv_affine_act_plain(x, wt, a, b)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert_f32_kernel_close(runs[0], ref)


@pytest.mark.parametrize("cin,cout", [(3, 64), (16, 128)])
def test_conv_tf32_narrow_takes_unaligned_operands(cuda_f32, cin, cout):
    """fp32 operands 4 bytes off 16-byte alignment, which the narrow tile
    reads as they are (plain loads): the same bits as aligned operands.
    ``test_f32_kernels_take_unaligned_operands`` holds the wide route."""
    gen, x, wt = _f32_operands(cuda_f32, 3, 8, 6, cin, cout, cin)
    xs = torch.empty(x.numel() + 1, device=cuda_f32)[1:].view(x.shape)
    ws = torch.empty(wt.numel() + 1, device=cuda_f32)[1:].view(wt.shape)
    xs.copy_(x)
    ws.copy_(wt)
    assert xs.data_ptr() % 16 and ws.data_ptr() % 16
    a, b = _rand((cout,), gen, cuda_f32), _rand((cout,), gen, cuda_f32)
    got = cuda_conv.conv_affine_act(xs, ws, a, b)
    ref = cuda_conv.conv_affine_act(x, wt, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_conv_tf32_launch_failure_raises(cuda_f32, monkeypatch):
    """A launch a TF32 tile refuses (a Cin it does not take, sent to it by
    a patched rule: 8 to the wide tile, 48 to the narrow one) raises;
    nothing falls back to the FFMA mainloop or the plain version, and no
    launch is counted."""
    for path, cin in (("tf32", 8), ("tf32_narrow", 48)):
        monkeypatch.setattr(cuda_conv, "f32_path",
                            lambda cin, cout, path=path: path)
        gen, x, wt = _f32_operands(cuda_f32, 2, 8, 8, cin, 16, 5)
        one = torch.ones(16, device=cuda_f32)
        before = cuda_conv.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            cuda_conv.conv_affine_act(x, wt, one, 0 * one)
        assert cuda_conv.launches == before


def test_conv_bn_stats_f32_backward_matches_autograd_of_plain(cuda_f32):
    """fp32 operands: the fused op's backward (PyTorch's conv gradients of
    the unfused VJP, in fp32, TF32 off) against autograd through the plain
    composition: the same fp32 function, sums in another order."""
    gen = torch.Generator(device=cuda_f32).manual_seed(7)
    x32 = _rand((4, 16, 16, 64), gen, cuda_f32)
    w32 = _rand((4, 4, 64, 128), gen, cuda_f32, 0.05)
    cw = _rand((128,), gen, cuda_f32)
    gx_ref, gw_ref = _plain_grads(x32, w32, cw)
    xk, wk = x32.clone().requires_grad_(), w32.clone().requires_grad_()
    before = cuda_conv_stats.launches
    out = cuda_conv_stats.conv_bn_stats(xk, wk)
    gx, gw = torch.autograd.grad(_pulled(*out, cw), (xk, wk))
    assert cuda_conv_stats.launches == before + 1
    torch.cuda.synchronize()
    assert out[0].dtype == gx.dtype == gw.dtype == F32
    # fp32 throughout: the forward's sum order (1e-6 relative) carried
    # through tanh and the statistics into the cotangent, and cuDNN's
    # gradient sums in another order than the plain matmuls': 1e-5 of
    # each gradient's scale (a bf16 run errs ~1e-2 of it)
    for got, ref in ((gx, gx_ref), (gw, gw_ref)):
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err


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


def _bn_stats_case(cuda, seed=7):
    """A BN layer's operands (fp32 and their bf16 leaves) and two
    cotangent weights for the pulled losses of the backward tests."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x32 = _rand((4, 16, 16, 64), gen, cuda)
    w32 = _rand((4, 4, 64, 128), gen, cuda, 0.05)
    cws = [_rand((128,), gen, cuda) for _ in range(2)]
    return x32, w32, cws


def _pulled(y, m, v, cw):
    return ((torch.tanh(y.float()) * cw).sum() + (m * cw ** 2).sum()
            + torch.sqrt(v + 1.0).sum())


def _plain_grads(x32, w32, cw):
    xr, wr = x32.clone().requires_grad_(), w32.clone().requires_grad_()
    y = cuda_conv.conv421_plain(xr, wr)
    m = y.mean(dim=(0, 1, 2))
    v = torch.clamp((y * y).mean(dim=(0, 1, 2)) - m * m, min=0.0)
    return torch.autograd.grad(_pulled(y, m, v, cw), (xr, wr))


def _assert_grads_close(got, ref):
    # bf16 operands, cotangent and gradient: a few percent of the scale
    for g, r in zip(got, ref):
        err = (g.float() - r).abs().max().item()
        assert err <= 3e-2 * r.abs().max().item(), err


def test_conv_bn_stats_backward_twice_on_one_graph(cuda):
    """FusedProp's two pulls: two cotangents through one forward's saved
    context (``retain_graph``), each against the plain composition's
    gradients; one kernel launch for both."""
    x32, w32, cws = _bn_stats_case(cuda)
    xb = x32.to(BF).requires_grad_()
    wb = w32.to(BF).requires_grad_()
    before = cuda_conv_stats.launches
    out = cuda_conv_stats.conv_bn_stats(xb, wb)
    first = torch.autograd.grad(_pulled(*out, cws[0]), (xb, wb),
                                retain_graph=True)
    second = torch.autograd.grad(_pulled(*out, cws[1]), (xb, wb))
    assert cuda_conv_stats.launches == before + 1
    torch.cuda.synchronize()
    _assert_grads_close(first, _plain_grads(x32, w32, cws[0]))
    _assert_grads_close(second, _plain_grads(x32, w32, cws[1]))
    assert not torch.equal(first[0], second[0])


def test_conv_bn_stats_backward_under_recomputation(cuda):
    """``train.remat``: under ``torch.utils.checkpoint`` the backward
    relaunches the kernel (the recomputed forward) and gives the stored
    forward's gradients bit for bit (no atomics), the plain composition's
    within the bf16 limit."""
    from torch.utils.checkpoint import checkpoint

    x32, w32, cws = _bn_stats_case(cuda, seed=8)
    grads = {}
    for remat in (False, True):
        xb = x32.to(BF).requires_grad_()
        wb = w32.to(BF).requires_grad_()
        before = cuda_conv_stats.launches

        def f(x, w):
            return _pulled(*cuda_conv_stats.conv_bn_stats(x, w), cws[0])

        loss = (checkpoint(f, xb, wb, use_reentrant=False) if remat
                else f(xb, wb))
        grads[remat] = torch.autograd.grad(loss, (xb, wb))
        assert cuda_conv_stats.launches == before + (2 if remat else 1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))
    _assert_grads_close(grads[True], _plain_grads(x32, w32, cws[0]))


def test_card_checkpoint_restores_on_the_cpu(cuda, tmp_path):
    """A Trainer's checkpoint saved on the card restores into a CPU
    Trainer: the same bits, every tensor on the CPU."""
    from tpugan_torch.train.trainer import Trainer

    cfg = get_preset("dcgan_celeba64").override({
        "data.dataset": "synthetic", "data.synthetic_size": 32,
        "data.batch_size": 8, "model.ngf": 8,
        "model.ndf": 8, "model.nz": 16, "train.fuse_stats": "on",
        "train.ema": 0.9, "optim.schedule": "linear",
        "train.total_steps": 4, "train.sample_every": 0,
        "train.out_dir": str(tmp_path / "out"),
        "train.ckpt_dir": str(tmp_path / "ckpt")})
    card = Trainer(cfg, device=cuda)
    card.train(3)
    cpu = Trainer(cfg, device="cpu")
    assert cpu.restore(cfg.train.ckpt_dir) == 3
    got, want = cpu.state.state_dict(), card.state.state_dict()
    assert got["rng"] == want["rng"]
    for part in ("g", "d", "g_ema"):
        for k, t in want[part].items():
            assert got[part][k].device.type == "cpu"
            assert torch.equal(got[part][k], t.cpu()), f"{part}.{k}"
    for part in ("opt_g", "opt_d"):
        assert got[part]["param_groups"] == want[part]["param_groups"]
        for i, st in want[part]["state"].items():
            for k, t in st.items():
                assert got[part]["state"][i][k].device.type == "cpu"
                assert torch.equal(got[part]["state"][i][k], t.cpu())


def test_conv_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(2, 8, 8, 8, device=cuda)
    w = torch.zeros(4, 4, 8, 8, device=cuda)
    one, zero = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    # fp32 operands run the fp32 kernels; fp16 and mixed dtypes are refused
    before = (cuda_conv.launches, cuda_conv_stats.launches)
    cuda_conv.conv_affine_act(x, w, one, zero)
    cuda_conv_stats.conv_stats(x, w)
    assert (cuda_conv.launches, cuda_conv_stats.launches) == (
        before[0] + 1, before[1] + 1)
    for xd, wd in ((torch.float16, torch.float16), (BF, torch.float32)):
        with pytest.raises(ValueError, match="one dtype, bf16 or fp32"):
            cuda_conv.conv_affine_act(x.to(xd), w.to(wd), one, zero)
        with pytest.raises(ValueError, match="one dtype, bf16 or fp32"):
            cuda_conv_stats.conv_stats(x.to(xd), w.to(wd))
    with pytest.raises(ValueError, match="out_dtype"):
        cuda_conv.conv_affine_act(x.to(BF), w.to(BF), one, zero,
                                  out_dtype=torch.float16)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv.conv_affine_act(x.to(BF), w.to(BF).requires_grad_(), one,
                                  zero)


def _eval_d(cuda, preset, moves=2):
    """(cfg, D) of ``preset`` at full width in bf16 on the card, with
    BatchNorm statistics and spectral norm's u moved by ``moves``
    train-mode forwards."""
    from tpugan_torch.models.registry import build_discriminator

    cfg = get_preset(preset)
    gen = torch.Generator(device=cuda).manual_seed(3)
    d = build_discriminator(cfg.model, "bf16", device=cuda, generator=gen)
    s, n = cfg.model.image_size, 4
    cond = cfg.model.arch == "cdcgan"
    with torch.no_grad():
        d.train()
        for _ in range(moves):
            x = torch.rand((n, s, s, 3), generator=gen, device=cuda) * 2 - 1
            y = torch.arange(n, device=cuda) % max(cfg.model.n_classes, 1)
            d(x, y) if cond else d(x)
    return cfg, d.eval()


@pytest.mark.parametrize("preset,blocks", [("sngan_cifar10", 3),
                                           ("cdcgan_celeba64", 4)])
def test_eval_d_under_pallas_matches_xla(cuda, preset, blocks):
    """The spectrally normalized D (the kernel takes W / sigma in bf16) and
    the conditional D (its first layer: image + label plane, Cin 4, on the
    narrow path) in eval mode, one kernel launch a block, against the
    "xla" impl; spectral norm's u does not move."""
    from tpugan_torch.ops import convs

    cfg, d = _eval_d(cuda, preset)
    s = cfg.model.image_size
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.rand((4, s, s, 3), generator=gen, device=cuda) * 2 - 1)
    args = ((x, torch.tensor([0, 1, 1, 0], device=cuda))
            if cfg.model.arch == "cdcgan" else (x,))
    if cfg.model.arch == "cdcgan":
        x4 = torch.zeros((4, s, s, 4), dtype=BF, device=cuda)
        assert cuda_conv.plan(x4, cfg.model.ndf)[0] == "narrow"
    us = {k: v.clone() for k, v in d.state_dict().items() if k.endswith(".u")}
    before = cuda_conv.launches
    with torch.no_grad():
        convs.set_default_impl("pallas")
        try:
            got = d(*args).float()
        finally:
            convs.set_default_impl("xla")
        ref = d(*args).float()
    torch.cuda.synchronize()
    assert cuda_conv.launches == before + blocks
    assert bool(torch.isfinite(got).all())
    # each block rounds to bf16 at other places (chip_smoke.py phase 6)
    assert bool(((got - ref).abs() <= 3e-2 * (1 + ref.abs())).all()), (
        (got - ref).abs().max().item())
    for k, u in us.items():
        assert torch.equal(d.state_dict()[k], u), k


# -- augmentation and the eval extractors on the card ------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_augment_on_cuda_matches_cpu(cuda, dtype):
    """The full policy from one key, gated at a device p (ADA's): the same
    draws (threefry on the host), so fp32 within 1e-6 (the means' sum
    order) and bf16 within one bf16 ulp of the largest value; the gradient
    flows through on the card."""
    from tpugan_torch.ops import augment
    from tpugan_torch.sample import threefry

    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (16, 64, 64, 3)).astype(np.float32)).to(dtype)
    key = threefry.prng_key(5)
    policy = ("color", "translation", "cutout")
    p = torch.tensor(0.7)
    ref = augment.apply_policy(x, key, policy, p).float()
    xc = x.to(cuda).requires_grad_()
    got = augment.apply_policy(xc, key, policy, p.to(cuda))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7 * ref.abs().max()
    assert (got.float().cpu() - ref).abs().max().item() <= tol
    got.float().square().sum().backward()
    assert bool(torch.isfinite(xc.grad).all())


def test_proxy_extractor_on_cuda_matches_cpu(cuda):
    """The proxy network (weights and fitted head) built on the card
    against the CPU's on the same images, TF32 off: features within 1e-4
    of their scale (fp32 conv sum order on two devices, and a head fit by
    300 GD steps on each)."""
    from tpugan_torch.eval import features

    torch.backends.cudnn.allow_tf32 = False
    x = np.random.default_rng(1).uniform(-1, 1, (64, 64, 64, 3)).astype(
        np.float32)
    fc, pc = features.make_extractor(3, "proxy", device=cuda)(x)
    fr, pr = features.make_extractor(3, "proxy", device="cpu")(x)
    assert np.abs(fc - fr).max() <= 1e-4 * np.abs(fr).max()
    assert np.abs(pc - pr).max() <= 1e-3


def test_inception_on_cuda_matches_cpu(cuda):
    """InceptionV3 with ``init_random`` weights on 4 images at 64 px resized
    to 299, TF32 off: features within 1e-4 of their scale."""
    from tpugan_torch.eval import features, inception

    torch.backends.cudnn.allow_tf32 = False
    params = inception.init_random(0)
    x = np.random.default_rng(2).uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32)
    fc, _ = features.inception_extractor(params, device=cuda)(x)
    fr, _ = features.inception_extractor(params, device="cpu")(x)
    assert np.abs(fc - fr).max() <= 1e-4 * np.abs(fr).max()


def test_convt_op_launches_the_kernel_and_matches_plain(cuda):
    """The registered op itself (as an exported program calls it): one
    launch a call on a CUDA tensor, the plain version on a CPU one."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _rand((2, 8, 8, 128), gen, cuda).to(BF)
    wt = _rand((4, 4, 128, 64), gen, cuda, 0.05).to(BF)
    a, b = _rand((64,), gen, cuda), _rand((64,), gen, cuda)
    before = cuda_convt.launches
    got = torch.ops.tpugan_torch.convt_affine_act(x, wt, a, b, "relu", 0.2,
                                                  BF)
    assert cuda_convt.launches == before + 1
    ref = torch.ops.tpugan_torch.convt_affine_act(
        x.cpu(), wt.cpu(), a.cpu(), b.cpu(), "relu", 0.2, BF)
    assert cuda_convt.launches == before + 1
    assert_bf16_close(got.cpu(), ref)


def _trained_bn_generator(cuda, preset, overrides, seed, batch):
    """(cfg, eval-mode generator, z, y or None): random weights, BN
    statistics from one train-mode forward."""
    cfg = get_preset(preset).override(overrides)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    g = build_generator(cfg.model, device=cuda, generator=gen)
    cond = cfg.model.arch == "cdcgan"
    z = _rand((batch, cfg.model.nz), gen, cuda)
    y = (torch.arange(batch, device=cuda) % cfg.model.n_classes
         if cond else None)
    with torch.no_grad():
        g.train()
        g(z, y) if cond else g(z)
    return cfg, g.eval(), z, y


@pytest.mark.parametrize("preset,overrides", [
    ("dcgan_celeba64", {"model.ngf": 64}),
    ("cdcgan_celeba64", {"model.ngf": 16, "model.nz": 20,
                         "model.embed_dim": 6})])
def test_artifact_runs_kernel_1_on_the_card(cuda, preset, overrides):
    """An artifact exported under "pallas" and loaded on the card launches
    kernel 1 once a GBlock, gives the live module path's bits, runs at
    other batch sizes, and moved to the CPU gives the kernel's plain
    version within the image limit."""
    from tpugan_torch.export import export_generator, load_generator
    from tpugan_torch.ops import convs

    cfg, g, z, y = _trained_bn_generator(
        cuda, preset, {**overrides, "train.kernels": "pallas"}, 4, 5)
    blob = export_generator(cfg, g)
    art = load_generator(blob, device="cuda")
    zn = z.cpu().numpy()
    yn = None if y is None else y.cpu().numpy()
    before = cuda_convt.launches
    got = art.generate(zn, yn)
    assert cuda_convt.launches == before + 4
    with torch.no_grad(), convs.using_impl("pallas"):
        live = (g(z) if y is None else g(z, y)).float().cpu().numpy()
    np.testing.assert_array_equal(got, live)
    on_cpu = load_generator(blob, device="cpu").generate(zn, yn)
    assert_image_close(torch.from_numpy(got), torch.from_numpy(on_cpu))
    for n in (1, 3):
        assert art.generate(zn[:n], None if yn is None
                            else yn[:n]).shape[0] == n


@pytest.mark.parametrize("preset,overrides", [
    ("dcgan_celeba64", {"model.ngf": 32}),
    ("cdcgan_celeba64", {"model.ngf": 16, "model.nz": 20,
                         "model.embed_dim": 6})])
def test_unroll_replays_unroll_1_bits_on_the_card(cuda, preset, overrides):
    """Under "xla" on the card ``unroll`` is a CUDA graph replay: the
    pixels of ``unroll=1`` bit for bit, the tail included."""
    from tpugan_torch.sample.sampler import Sampler

    cfg, g, _, _ = _trained_bn_generator(cuda, preset, overrides, 5, 8)
    s = Sampler(cfg, g)
    want = s.sample(19, seed=3, batch_size=4)
    for _ in range(2):  # the capture, then a replay of the cached graph
        got = s.sample(19, seed=3, batch_size=4, unroll=2)
        np.testing.assert_array_equal(got, want)
    # new weights in new storage: the cached graph is not replayed
    g.load_state_dict({k: v * 0.5 if v.is_floating_point() else v
                       for k, v in g.state_dict().items()}, assign=True)
    want = s.sample(19, seed=3, batch_size=4)
    got = s.sample(19, seed=3, batch_size=4, unroll=2)
    np.testing.assert_array_equal(got, want)


# -- meshes of ranks (tpugan_torch/parallel) on the card --------------------

def test_halo_convs_with_gloo_ranks_on_the_card(cuda):
    """Two gloo ranks sharing the card: the H-sharded conv and ConvT and
    their gradients against the dense ops on the card (the collectives
    take CUDA tensors; fp32, TF32 off: 1e-4 of the largest value)."""
    from _torch_port_workers import run_cases
    from tpugan_torch.parallel import multihost

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    w = {"conv": (rng.standard_normal((4, 4, 8, 16)) * 0.1)
         .astype(np.float32),
         "convt": (rng.standard_normal((4, 4, 8, 4)) * 0.1)
         .astype(np.float32)}
    cases = [("halo_conv", dict(kind=k, dim=1, n=2, x=x, w=w[k],
                                device="cuda")) for k in ("conv", "convt")]
    got = multihost.spawn(run_cases, 2, (cases,), backend="gloo",
                          device="cuda", timeout=300)[0]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        _check_halo(cuda, x, w, got)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _check_halo(cuda, x, w, got):
    from tpugan_torch.ops import convs

    for kind, (out, dx, dw) in zip(("conv", "convt"), got):
        xt = torch.from_numpy(x).to(cuda).requires_grad_()
        wt = torch.from_numpy(w[kind]).to(cuda).requires_grad_()
        op = convs.conv2d if kind == "conv" else convs.conv_transpose2d
        ref = op(xt, wt, stride=2, padding=1)
        torch.tanh(ref).sum().backward()
        for a, b in ((out, ref), (dx, xt.grad), (dw, wt.grad)):
            assert_fp32_close(torch.from_numpy(a), b.detach().cpu())


def test_sharded_sampler_runs_kernel_1_on_each_rank(cuda):
    """ShardedSampler over two gloo ranks on the card under "pallas": each
    rank launches kernel 1 once per GBlock on its half, and the images are
    the one-card module path's within chip_smoke.image_err's limit (kernel
    1's plan depends on the batch: 8 images a rank sum in another order
    than 16)."""
    from _torch_port_workers import numpy_tree, run_cases
    from tpugan_torch.ops import convs
    from tpugan_torch.parallel import multihost
    from tpugan_torch.sample.sampler import seeded_noise

    over = {"model.ngf": 16, "model.nz": 16}
    cfg = get_preset("dcgan_celeba64").override(over)
    g = build_generator(cfg.model, "bf16", device=cuda,
                        generator=torch.Generator(device=cuda)
                        .manual_seed(0)).eval()
    sd = numpy_tree({k: v.cpu() for k, v in g.state_dict().items()})
    cases = [("sharded_sample", dict(preset="dcgan_celeba64",
                                     overrides=over, sd=sd, n=16, seed=3,
                                     kernels="pallas", device="cuda"))]
    got = multihost.spawn(run_cases, 2, (cases,), backend="gloo",
                          device="cuda", timeout=300)[0][0]
    assert got["launches"] == 4  # block0..2 and the final GBlock
    z = torch.from_numpy(seeded_noise(16, 16, 3)).to(cuda)
    with convs.using_impl("pallas"), torch.no_grad():
        want = g(z).float().cpu().numpy()
    err = np.abs(got["images"] - want)
    assert (err <= 2.0 ** -7 * np.abs(want)
            + 1e-2 * np.abs(want).max()).all(), err.max()


def test_one_rank_nccl_trainer_is_the_plain_trainer(cuda, tmp_path):
    """mesh_shape=1 in a one-rank NCCL group: fuse_stats stays on (kernel
    5 runs, 3 a D forward), and two steps end bit for bit where the plain
    Trainer's do (cuDNN deterministic)."""
    import torch.distributed as dist

    from tpugan_torch.ops import cuda_conv_stats
    from tpugan_torch.parallel import multihost
    from tpugan_torch.train.trainer import Trainer

    over = {"data.dataset": "synthetic", "data.synthetic_size": 64,
            "data.batch_size": 16, "model.ngf": 16, "model.ndf": 16,
            "train.fuse_stats": "on", "train.log_every": 1,
            "train.sample_every": 0, "train.ckpt_every": 0}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    multihost.initialize_multihost(f"file://{tmp_path}/store", 1, 0,
                                   device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        runs = []
        for extra in ({}, {"train.mesh_shape": 1}):
            cfg = get_preset("dcgan_celeba64").override({
                **over, **extra,
                "train.out_dir": str(tmp_path / f"o{len(runs)}"),
                "train.ckpt_dir": str(tmp_path / f"c{len(runs)}")})
            cuda_conv_stats.launches = 0
            t = Trainer(cfg, device="cuda")
            t.train(2)
            runs.append((t, cuda_conv_stats.launches))
        (plain, n_plain), (mesh, n_mesh) = runs
        assert mesh.mesh is not None and mesh._fuse_mode == "on"
        assert n_plain == n_mesh == 9 * 2
        a, b = plain.state.state_dict(), mesh.state.state_dict()
        for part in ("g", "d"):
            for k, v in a[part].items():
                assert torch.equal(v, b[part][k]), f"{part}.{k}"
    finally:
        torch.backends.cudnn.deterministic = det
        multihost.shutdown()


def test_resident_fused_step_counts_its_blocking_copies(cuda):
    """Under the profiler a resident FusedProp step draws the batch's
    indices, the hflip bits and the latents on the card, one launch each
    a step, counted as ``device_draws``, with no blocking copy and no wait
    for the device (``utils/tracing.py``); fed the latents by the ``z_d``
    hook, it counts that host array's blocking copy, one a step, each a
    span of its own and the host's one wait for the device in the step."""
    from tpugan_torch.models.registry import build_models
    from tpugan_torch.train.state import create_train_state
    from tpugan_torch.train.steps import build_train_step
    from tpugan_torch.utils import tracing

    k, n, nz = 2, 8, 16
    cfg = get_preset("dcgan_celeba64_fast").override({
        "model.ngf": 8, "model.ndf": 8, "model.nz": nz,
        "data.batch_size": n, "train.steps_per_call": k,
        "train.precision": "fp32", "train.fuse_stats": "off"})
    assert cfg.train.fused_prop and cfg.data.device_resident
    g, d = build_models(cfg.model, cfg.train.precision, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, g, d)
    step = build_train_step(cfg, g, d)
    batch = {"dataset_images": torch.randint(
        0, 256, (4 * n, 64, 64, 3), dtype=torch.uint8, device=cuda)}
    state, _ = step(state, batch)
    flip = int(cfg.data.hflip)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    hook = np.zeros((n, nz), np.float32)
    for fed in (False, True):
        tracing.reset()
        with torch.profiler.profile(activities=acts) as prof:
            step(state, dict(batch, z_d=hook) if fed else batch)
        c = tracing.counters()
        assert c["device_draws"] == k * (1 + flip + (not fed))
        assert c["device_draws_bytes"] == k * n * (
            8 + flip + (0 if fed else 4 * nz))
        copies = k if fed else 0
        assert c.get("h2d_blocking", 0) == copies
        assert c.get("h2d_blocking_bytes", 0) == copies * n * 4 * nz
        # each copy is a span of its own on the host's timeline, and the
        # host waits for it (the profiler also marks a span on the
        # device's); a draw on the card makes neither
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type().name != "CUDA"]
        assert names.count(tracing.PREFIX + "h2d") == copies
        assert names.count("cudaStreamSynchronize") == copies
    tracing.reset()
