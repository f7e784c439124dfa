"""The operations and bytes the roofline and MFU metrics divide by,
against numbers worked by hand for DCGAN-64 (nz 100, ngf = ndf = 64) and
a small conditional DCGAN-128."""

from __future__ import annotations

import pytest

from portbench import flops

MODEL = {"image_size": 64, "channels": 3, "nz": 100, "ngf": 64, "ndf": 64}


def test_layers():
    assert flops.d_layers(MODEL) == [
        ("conv", 64, 3, 64), ("conv", 32, 64, 128), ("conv", 16, 128, 256),
        ("conv", 8, 256, 512), ("dense", 1, 8192, 1)]
    assert flops.g_layers(MODEL) == [
        ("dense", 1, 100, 8192), ("convt", 4, 512, 256),
        ("convt", 8, 256, 128), ("convt", 16, 128, 64), ("convt", 32, 64, 3)]
    assert flops.conv_stats_layers(MODEL) == flops.d_layers(MODEL)[1:4]


def test_wide_d_conv_by_hand():
    # 16 x 16 outputs x 128 channels, each 4 x 4 x 64 multiply-adds
    per_image = 2 * 16 * 16 * 128 * 4 * 4 * 64
    assert per_image == 67_108_864  # 67.1 MFLOP an image
    for layer in flops.d_layers(MODEL)[1:4]:
        assert flops.layer_flops(layer, 1) == per_image
        assert flops.layer_flops(layer, 128) == 8_589_934_592  # 8.59 GFLOP
    for layer in flops.g_layers(MODEL)[1:4]:
        assert flops.layer_flops(layer, 1) == per_image
    # the RGB layers: 32 x 32 x 64 x 16 x 3 multiply-adds
    assert flops.layer_flops(("conv", 64, 3, 64), 1) == 6_291_456
    assert flops.layer_flops(("convt", 32, 64, 3), 1) == 6_291_456


def test_step_flops_by_hand():
    fg = 2 * 100 * 8192 + 3 * 67_108_864 + 6_291_456  # G forward
    fd = 6_291_456 + 3 * 67_108_864 + 2 * 8192  # D forward
    g0, d0 = 2 * 100 * 8192, 6_291_456
    # FusedProp: G fwd; D real fwd + weights; D fake fwd + weights + input;
    # G weights + input (not z)
    fused = fg + (fd + fd + fd - d0) + (fd + 2 * fd) + (2 * fg - g0)
    assert flops.step_flops(MODEL, 1, True) == fused
    assert fused / 1e9 == pytest.approx(1.8656, abs=1e-4)
    # alternating: G fwd; D real and fake, each fwd + weights + input but
    # the image's; G fwd, D fwd + input (frozen), G weights + input
    alt = fg + 2 * (3 * fd - d0) + fg + 2 * fd + (2 * fg - g0)
    assert flops.step_flops(MODEL, 1, False) == alt
    assert alt / 1e9 == pytest.approx(2.4839, abs=1e-4)
    assert flops.step_flops(MODEL, 256, True) == 256 * fused


def test_conditional_step_flops_by_hand():
    # ngf = ndf = 8, nz 16, two classes embedded in 50, 128 x 128 x 3
    cond = {"arch": "cdcgan", "image_size": 128, "channels": 3, "nz": 16,
            "ngf": 8, "ndf": 8, "n_classes": 2, "embed_dim": 50}
    assert flops.g_layers(cond) == [
        ("dense", 1, 66, 2048), ("convt", 4, 128, 64), ("convt", 8, 64, 32),
        ("convt", 16, 32, 16), ("convt", 32, 16, 8), ("convt", 64, 8, 3)]
    assert flops.d_layers(cond) == [
        ("dense", 1, 50, 16384), ("conv", 128, 4, 8), ("conv", 64, 8, 16),
        ("conv", 32, 16, 32), ("conv", 16, 32, 64), ("conv", 8, 64, 128),
        ("dense", 1, 2048, 1)]
    assert flops.conv_stats_layers(cond) == flops.d_layers(cond)[2:6]
    head = 2 * 66 * 2048  # z and the embedding into the head
    convts = 2 * (4 * 4 * 128 * 64 + 8 * 8 * 64 * 32 + 16 * 16 * 32 * 16
                  + 32 * 32 * 16 * 8 + 64 * 64 * 8 * 3) * 16
    proj = 2 * 50 * 16384  # the embedding to the 128 x 128 plane
    conv0 = 2 * 64 * 64 * 16 * 4 * 8  # the image and the plane
    convs = 2 * (32 * 32 * 16 * 8 * 16 + 16 * 16 * 16 * 16 * 32
                 + 8 * 8 * 16 * 32 * 64 + 4 * 4 * 16 * 64 * 128)
    tail = 2 * 2048
    fg, fd = head + convts, proj + conv0 + convs + tail
    # FusedProp: G fwd, weights, input (the embedding trains, so the head's
    # input too); D on the reals and on the fakes, each fwd, weights and
    # input (D's embedding trains through proj; the fakes' image)
    fused = 3 * fg + 3 * fd + 3 * fd
    assert flops.step_flops(cond, 1, True) == fused
    # alternating: G fwd; D real and fake, each fwd, weights and input
    # (D's embedding); G fwd, weights, input; D frozen: fwd and the input
    # gradient of every layer but proj, whose input does not train
    alt = fg + 2 * 3 * fd + 3 * fg + (2 * fd - proj)
    assert flops.step_flops(cond, 1, False) == alt
    assert flops.step_flops(cond, 128, False) == 128 * alt
    # the unconditional counts do not see the embedding's width
    plain = dict(cond, arch="dcgan", n_classes=0, embed_dim=0)
    assert flops.g_layers(plain)[0] == ("dense", 1, 16, 2048)
    assert flops.d_layers(plain)[0] == ("conv", 128, 3, 8)


def test_kernel5_work_counted_once():
    f, b = flops.conv_stats_work(128, 32, 64, 128, "bf16")
    assert f == 8_589_934_592
    x, w = 128 * 32 * 32 * 64 * 2, 16 * 64 * 128 * 2
    y, stats = 128 * 16 * 16 * 128 * 2, 2 * 128 * 4
    assert b == x + w + y + stats
    f32, b32 = flops.conv_stats_work(128, 32, 64, 128, "fp32")
    assert f32 == f and b32 == 2 * (x + w + y) + stats
    # bf16 at 989 TFLOP/s: operations bound (8.69 us against 7.5 us)
    assert flops.least_seconds(f, b, "bf16") == pytest.approx(f / 989e12)
    # fp32 at TF32's 495 TFLOP/s whatever the route: 17.4 us
    assert flops.least_seconds(f32, b32, "fp32") == pytest.approx(
        8_589_934_592 / 495e12)
    # a bytes-bound case: the bound follows the bytes
    fb, bb = flops.conv_stats_work(128, 64, 3, 64, "bf16")
    assert flops.least_seconds(fb, bb, "bf16") == pytest.approx(bb / 3.35e12)
