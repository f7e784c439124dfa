"""The host-side plans of the Hopper conv kernels, on the CPU: the box
tiling of a grid and the depth split of the conv + BN-statistics kernel
(the rule that ``make_box`` in ``csrc/igemm_sm90.cuh`` and ``split_k`` in
``csrc/cuda_conv_stats.cu`` implement, restated here as the reference that
``test_library_plan_follows_the_rule`` holds the library's plan to on the
card), and the operand padding the wrappers apply (``kernel_operands``),
each against the plain version."""

import numpy as np
import pytest
import torch

from tpugan_torch.ops import cuda_conv_stats, cuda_convt
from tpugan_torch.ops.kernel_common import aligned, pad_dim

# kBM of csrc/igemm_sm90.cuh, and an H100 SXM's multiprocessors
TILE_ROWS = 128
H100_SMS = 132

# (n, h, w) grids: the D's BN layers' outputs at batch 128, the G's ConvT
# inputs at batch 256, and ragged ones
GRIDS = [(128, 16, 16), (128, 8, 8), (128, 4, 4), (256, 4, 4), (256, 8, 8),
         (256, 16, 16), (256, 32, 32), (3, 5, 3), (1, 2, 300), (7, 100, 1),
         (5, 6, 10), (2, 1, 1)]

# (n, h, w, cin, cout) conv inputs and the depth split an H100 gets
SPLITS = [
    ((128, 32, 32, 64, 128), 1),   # 256 tiles: the card is full
    ((128, 16, 16, 128, 256), 1),  # 128 tiles: one a SM
    ((128, 8, 8, 256, 512), 2),    # 64 tiles of 64 stages
    ((4, 8, 8, 256, 512), 4),      # 4 tiles
    ((1, 4, 4, 64, 8), 2),         # 16 stages: two blocks of 8
    ((1, 2, 2, 64, 8), 2),
]


def tile_box(n, h, w):
    """(bn, bh, bw, tiles): an (n, h, w) grid in boxes of bn images x bh x
    bw positions, at most TILE_ROWS rows."""
    bw = min(w, TILE_ROWS)
    bh = min(h, TILE_ROWS // bw)
    bn = min(n, TILE_ROWS // (bw * bh))
    return bn, bh, bw, -(-n // bn) * -(-h // bh) * -(-w // bw)


def split_k(blocks, steps, sms):
    """Blocks sharing one tile's depth of ``steps`` stages: doubled while
    the doubled launch has at most one block a SM, each keeps at least 8
    stages, at most 4 share a tile."""
    splits = 1
    while (2 * blocks * splits <= sms and splits < 4
           and steps % (2 * splits) == 0 and steps // (2 * splits) >= 8):
        splits *= 2
    return splits


def plan(n, h, w, cin, cout, sms):
    """(tiles_m, splits) of a conv + BN-statistics launch: 128-wide tiles
    from Cout 128 up, else 64."""
    tiles_m = tile_box(n, h // 2, w // 2)[3]
    tiles_n = -(-cout // (128 if cout >= 128 else 64))
    return tiles_m, split_k(tiles_m * tiles_n, 16 * cin // 64, sms)


def _tiles(n, h, w):
    """Every tile's positions, walked as the kernel does (Box::origin and
    Box::at)."""
    bn, bh, bw, tiles = tile_box(n, h, w)
    tn, th, tw = -(-n // bn), -(-h // bh), -(-w // bw)
    assert tiles == tn * th * tw
    for t in range(tiles):
        a, rem = divmod(t, th * tw)
        b, c = divmod(rem, tw)
        n0, i0, j0 = a * bn, b * bh, c * bw
        rows = []
        for r in range(TILE_ROWS):
            img, rr = divmod(r, bh * bw)
            i, j = divmod(rr, bw)
            img, i, j = n0 + img, i0 + i, j0 + j
            if r < bn * bh * bw and img < n and i < h and j < w:
                rows.append((img, i, j))
        yield (bn, bh, bw), rows


@pytest.mark.parametrize("n,h,w", GRIDS)
def test_tile_box_covers_the_grid_once(n, h, w):
    seen = np.zeros((n, h, w), np.int32)
    for (bn, bh, bw), rows in _tiles(n, h, w):
        assert bn * bh * bw <= TILE_ROWS
        assert bw <= 256 and bh <= 256 and bn <= 256  # TMA box limits
        for p in rows:
            seen[p] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n,h,w", GRIDS[:7])
def test_main_path_boxes_are_full(n, h, w):
    """At the main path's grids every tile has 128 real rows."""
    for _, rows in _tiles(n, h, w):
        assert len(rows) == TILE_ROWS


@pytest.mark.parametrize("shape,splits", SPLITS)
def test_split_k_plan(shape, splits):
    n, h, w, cin, cout = shape
    tiles_m, got = plan(n, h, w, cin, cout, H100_SMS)
    assert tiles_m == tile_box(n, h // 2, w // 2)[3]
    assert got == splits
    steps = 16 * cin // 64
    assert steps % got == 0 and steps // got >= 8 or got == 1


def test_split_k_keeps_eight_stages_a_block():
    for sms in (H100_SMS, 114):
        for blocks in (1, 7, 64, 131, 132, 500):
            for steps in (8, 16, 24, 32, 48, 64, 256):
                s = split_k(blocks, steps, sms)
                assert s in (1, 2, 4) and steps % s == 0
                assert s == 1 or steps // s >= 8
                assert s == 1 or blocks * s <= sms


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s for s, _ in SPLITS]
                         + [(n, 2 * h, 2 * w, 64, 136) for n, h, w in GRIDS])
def test_library_plan_follows_the_rule(shape):
    """The plan ``cuda_conv_stats`` takes from the library (make_box, the
    tile width, split_k at the card's SM count) is the rule above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, h, w, cin, cout = shape
    x = torch.empty((1, 1, 1, 1), device="cuda").expand(n, h, w, cin)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cuda_conv_stats.plan(x, cout) == plan(n, h, w, cin, cout, sms)


def _operands(rng, n, h, w, cin, cout):
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((4, 4, cin, cout)) * 0.1).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wt)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 6, 4, 3, 7), (1, 4, 4, 33, 40),
                                            (2, 8, 8, 64, 128)])
def test_conv_stats_operand_padding_keeps_the_result(n, h, w, cin, cout):
    x, wt = _operands(np.random.default_rng(cin), n, h, w, cin, cout)
    xp, wp, ldb = cuda_conv_stats.kernel_operands(x, wt)
    assert xp.shape[3] % 64 == 0 and wp.shape[2] == xp.shape[3]
    assert ldb % 8 == 0 and wp.shape[3] == ldb >= cout
    if cin % 64 == 0 and cout % 8 == 0:  # the main path's shapes: no copy
        assert xp is x and wp is wt
    got = cuda_conv_stats.conv_stats_plain(xp, wp[..., :cout])
    ref = cuda_conv_stats.conv_stats_plain(x, wt)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,h,w,cin,cout,narrow", [
    (2, 5, 5, 20, 7, True), (1, 4, 4, 33, 40, False),
    (2, 4, 4, 64, 3, True), (1, 2, 2, 520, 3, False),
    (2, 4, 4, 512, 256, False)])
def test_convt_operand_padding_keeps_the_result(n, h, w, cin, cout, narrow):
    x, wt = _operands(np.random.default_rng(cin), n, h, w, cin, cout)
    a = torch.linspace(0.5, 1.5, cout)
    b = torch.linspace(-0.1, 0.1, cout)
    xp, wp, ldb = cuda_convt.kernel_operands(x, wt)
    assert xp.shape[3] % 8 == 0 and wp.shape[2] == xp.shape[3]
    if narrow:  # the kernel for few channels reads w as it is
        assert ldb == cout == wp.shape[3]
    else:
        assert ldb % 8 == 0 and wp.shape[3] == ldb >= cout
    if cin % 8 == 0 and (narrow or cout % 8 == 0):
        assert xp is x and wp is wt
    got = cuda_convt.convt_affine_act_plain(xp, wp[..., :cout], a, b,
                                            act="tanh")
    ref = cuda_convt.convt_affine_act_plain(x, wt, a, b, act="tanh")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_aligned_copies_only_what_is_off_alignment():
    base = torch.arange(40, dtype=torch.bfloat16)
    assert aligned(base) is base
    off = base[1:33]
    assert off.data_ptr() % 16 != 0
    got = aligned(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)


def test_pad_dim_pads_with_zeros_at_the_end():
    t = torch.ones(2, 3, 4)
    p = pad_dim(t, 1, 5)
    assert p.shape == (2, 5, 4) and torch.equal(p[:, :3], t)
    assert not p[:, 3:].any()
    assert pad_dim(t, 2, 4) is t
