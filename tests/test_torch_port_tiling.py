"""The host-side plans of the Hopper kernels, on the CPU: the box tiling of
a grid and the depth split of the conv kernels (the rule that ``make_box``
in ``csrc/igemm_sm90.cuh`` and ``conv_split_k`` in ``csrc/conv_sm90.cuh``
implement), the eval-mode conv's narrow / wide / pad rule, and the
persistent generator kernels' walk (layer -> tiles -> blocks, ``gen_plan``
in ``csrc/gen_sm90.cuh``) with both megakernels' image placement, restated
here as the references that the ``cuda``-marked tests hold the libraries'
plans to on the card; and the operand padding the wrappers apply (``kernel_operands``), each
against the plain version."""

import numpy as np
import pytest
import torch

from tpugan_torch.ops import (cuda_conv, cuda_conv_stats, cuda_convt, cuda_gen,
                              cuda_gen2)
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


def split_k(blocks, steps, sms, most=4):
    """Blocks sharing one tile's depth of ``steps`` stages: doubled while
    the doubled launch has at most one block a SM, each keeps at least 8
    stages, at most ``most`` (4) share a tile."""
    splits = 1
    while (2 * blocks * splits <= sms and splits < most
           and steps % (2 * splits) == 0 and steps // (2 * splits) >= 8):
        splits *= 2
    return splits


def plan(n, h, w, cin, cout, sms):
    """(tiles_m, splits) of a conv + BN-statistics launch: 128-wide tiles
    from Cout 128 up, else 64."""
    tiles_m = tile_box(n, h // 2, w // 2)[3]
    tiles_n = -(-cout // (128 if cout >= 128 else 64))
    return tiles_m, split_k(tiles_m * tiles_n, 16 * cin // 64, sms)


# the three-pass TF32 route of kernel 5 on fp32 operands: the same plan at
# 32 channels a stage (twice the stages), at most 2 blocks a tile, 64-wide
# tiles where 128-wide ones split in 2 would fill at most half the card;
# the depth split and the tile width it gets
SPLITS_TF32 = [
    ((128, 32, 32, 64, 128), 1, 128),   # 256 tiles
    ((128, 16, 16, 128, 256), 1, 128),  # 128 tiles
    ((128, 8, 8, 256, 512), 2, 128),    # 64 tiles of 128 stages
    ((64, 32, 32, 64, 128), 1, 128),    # grad_accum=2's microbatch
    ((64, 16, 16, 128, 256), 2, 128),   # 64 tiles
    ((64, 8, 8, 256, 512), 2, 64),      # 32 tiles 128 wide: 64 at 64
    ((1, 4, 4, 32, 8), 2, 64),          # 16 stages: two blocks of 8
]


def plan_tf32(n, h, w, cin, cout, sms):
    """(tiles_m, splits, tile width) of the TF32 route: 16 Cin / 32
    stages, at most 2 blocks a tile, 64-wide tiles where 128-wide ones
    split in 2 would fill at most half the card."""
    tiles_m = tile_box(n, h // 2, w // 2)[3]
    tn = 128 if cout >= 128 else 64
    if tn == 128 and 4 * tiles_m * -(-cout // 128) <= sms:
        tn = 64
    return (tiles_m, split_k(tiles_m * -(-cout // tn), 16 * cin // 32, sms,
                             most=2), tn)


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


@pytest.mark.parametrize("shape,splits,width", SPLITS_TF32)
def test_split_k_plan_tf32(shape, splits, width):
    n, h, w, cin, cout = shape
    tiles_m, got, tn = plan_tf32(n, h, w, cin, cout, H100_SMS)
    assert tiles_m == tile_box(n, h // 2, w // 2)[3]
    assert (got, tn) == (splits, width)
    steps = 16 * cin // 32
    assert steps % got == 0 and steps // got >= 8 or got == 1
    assert tiles_m * -(-cout // tn) * got <= H100_SMS or got == 1


def test_split_k_keeps_eight_stages_a_block():
    for sms in (H100_SMS, 114):
        for blocks in (1, 7, 64, 131, 132, 500):
            for steps in (8, 16, 24, 32, 48, 64, 256):
                s = split_k(blocks, steps, sms)
                assert s in (1, 2, 4) and steps % s == 0
                assert s == 1 or steps // s >= 8
                assert s == 1 or blocks * s <= sms


def conv_path(cin, cout):
    """The eval-mode conv's path: "narrow" (Cin <= 16 with Cout <= 128, read
    as given) or "wide" (Cin padded to a multiple of 64)."""
    return "narrow" if cin <= 16 and cout <= 128 else "wide"


def conv_plan(n, h, w, cin, cout, sms):
    """(path, tiles, splits) of an eval-mode conv layer on an input of
    ``cin`` channels: the wide path's plan is the conv + BN-statistics
    kernel's on Cin padded to a multiple of 64; the narrow path walks the
    same boxes unsplit."""
    path = conv_path(cin, cout)
    if path == "wide":
        return (path, *plan(n, h, w, -(-cin // 64) * 64, cout, sms))
    return path, tile_box(n, h // 2, w // 2)[3], 1


# (cin, cout, path, cin the kernel takes): the D's layers (ndf 64, and the
# first at ndf 128), the card tests' shapes (Cin 3, 33, 16, 32, 64), and
# the narrow path's edges
CONV_RULES = [(3, 64, "narrow", 3), (64, 128, "wide", 64),
              (128, 256, "wide", 128), (256, 512, "wide", 256),
              (3, 128, "narrow", 3), (33, 40, "wide", 64),
              (16, 3, "narrow", 16), (32, 24, "wide", 64), (3, 7, "narrow", 3),
              (17, 8, "wide", 64), (3, 129, "wide", 64), (1, 1, "narrow", 1)]


@pytest.mark.parametrize("cin,cout,path,cin_k", CONV_RULES)
def test_conv_path_rule(cin, cout, path, cin_k):
    assert conv_path(cin, cout) == path
    x, wt = _operands(np.random.default_rng(cin), 1, 4, 4, cin, cout)
    xk, wk, ldb = cuda_conv.kernel_operands(x, wt, path)
    assert xk.shape[3] == wk.shape[2] == cin_k
    if path == "narrow":  # read as given: no padding, no copy
        assert xk is x and wk is wt and ldb == cout
    else:
        assert ldb % 8 == 0 and wk.shape[3] == ldb >= cout


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 6, 4, 3, 7), (1, 4, 4, 33, 40),
                                            (2, 8, 8, 16, 3),
                                            (2, 8, 8, 64, 128)])
def test_conv_operand_padding_keeps_the_result(n, h, w, cin, cout):
    x, wt = _operands(np.random.default_rng(cin + 1), n, h, w, cin, cout)
    a = torch.linspace(0.5, 1.5, cout)
    b = torch.linspace(-0.1, 0.1, cout)
    xp, wp, _ = cuda_conv.kernel_operands(x, wt, conv_path(cin, cout))
    got = cuda_conv.conv_affine_act_plain(xp, wp[..., :cout], a, b)
    ref = cuda_conv.conv_affine_act_plain(x, wt, a, b)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


# generators as (n, ldz, s0, c0, ConvT couts): 64 px at batch 256 (the
# serving path) and at ragged batches, 128 px at batch 16, 28 px (7 x 7
# base), the conditional test generator at ngf 8 (an inner narrow layer)
GENS = {
    "64px_b256": (256, 104, 4, 512, [256, 128, 64, 3]),
    "64px_b1": (1, 104, 4, 512, [256, 128, 64, 3]),
    "64px_b37": (37, 104, 4, 512, [256, 128, 64, 3]),
    "128px_b16": (16, 104, 4, 1024, [512, 256, 128, 64, 3]),
    "28px_b5": (5, 104, 7, 64, [32, 1]),
    "28px_b130": (130, 104, 7, 48, [24, 1]),
    "cond64_ngf8_b7": (7, 32, 4, 64, [32, 16, 8, 3]),
    "wide_last_b3": (3, 8, 4, 64, [192, 3]),
}


def gen2_plan(n, ldz, s0, c0, couts, resident):
    """The megakernels' walk: (grid, [(kind, bn, tiles, steps)]) for the head
    (kind 0: rows are images, 128 a tile, 64 or 128 columns) and each ConvT
    layer (kind 1, wide: 4 phases x boxes x column tiles, 4 taps x 64-deep
    chunks a tile; kind 2, narrow, Cout <= 8 and Cin <= 128: one box a tile,
    9 windows x chunks).  The grid is the resident blocks, or the most
    tiles of any layer where that is fewer."""
    n_head = s0 * s0 * c0
    bn = 128 if n_head >= 128 else 64
    layers = [(0, bn, -(-n // 128) * -(-n_head // bn), -(-ldz // 64))]
    hs, cin = s0, c0
    for cout in couts:
        kc, tiles = -(-cin // 64), tile_box(n, hs, hs)[3]
        if cout <= 8 and kc <= 2:
            layers.append((2, 8, tiles, 9 * kc))
        else:
            bn = 128 if cout >= 128 else 64
            layers.append((1, bn, 4 * tiles * -(-cout // bn), 4 * kc))
        hs, cin = 2 * hs, cout
    return min(resident, max(layer[2] for layer in layers)), layers


def _convt_writes(n, hs, layer, cout, grid, visits):
    """The outputs of a ConvT layer on an (n, hs, hs) input, tile by tile as
    the blocks walk them (tile t to block t mod grid): yields index arrays
    (img, H, W, channel) that broadcast to the tile's elements, and counts
    each tile's visits."""
    kind, bn, tiles, _ = layer
    tiles_n = -(-cout // bn) if kind == 1 else 1
    boxes = [np.array(rows, np.int64).reshape(-1, 3)
             for _, rows in _tiles(n, hs, hs)]
    for blk in range(grid):
        for t in range(blk, tiles, grid):
            visits[t] += 1
            if kind == 2:
                phases, cols, box = range(4), np.arange(cout), t
            else:
                box, rem = divmod(t, 4 * tiles_n)
                ph, tn = divmod(rem, tiles_n)
                phases = [ph]
                cols = np.arange(tn * bn, min(cout, tn * bn + bn))
            img, i, j = (boxes[box][:, k, None] for k in range(3))
            for ph in phases:
                di, dj = divmod(ph, 2)
                yield img, 2 * i + di, 2 * j + dj, cols[None, :]


def _gen2_walk(n, s0, c0, couts, grid, layers):
    """Every output element of every layer, as the blocks' tiles cover
    them (tile t of a layer to block t mod grid); returns per layer the
    count of visits of each element, and of each tile."""
    out = []
    n_head = s0 * s0 * c0
    visits = [np.zeros(layer[2], np.int32) for layer in layers]
    cover = np.zeros((n, n_head), np.int32)
    kind, bn, tiles = layers[0][:3]
    tiles_n = -(-n_head // bn)
    for blk in range(grid):
        for t in range(blk, tiles, grid):
            visits[0][t] += 1
            tm, tn = divmod(t, tiles_n)
            rows = range(tm * 128, min(n, tm * 128 + 128))
            cols = range(tn * bn, min(n_head, tn * bn + bn))
            cover[np.ix_(list(rows), list(cols))] += 1
    out.append(cover)
    hs = s0
    for li, (layer, cout) in enumerate(zip(layers[1:], couts)):
        cover = np.zeros((n, 2 * hs, 2 * hs, cout), np.int32)
        for index in _convt_writes(n, hs, layer, cout, grid, visits[li + 1]):
            np.add.at(cover, index, 1)
        out.append(cover)
        hs *= 2
    return out, visits


def image_offset(layout, n, s0, log2p, c, img, h, w):
    """The element offset of image pixel (h, w) of image img, c channels,
    as the last layer's epilogue places it (``out_pixel`` in
    ``csrc/gen_sm90.cuh``): "phased", v2's (P, P, n, s0, s0, c) with P =
    2^log2p and h = b P + o; "nhwc", v1's (n, S, S, c), S = s0 P."""
    if layout == "nhwc":
        size = s0 << log2p
        return ((img * size + h) * size + w) * c
    p = (1 << log2p) - 1
    ph = ((h & p) << log2p) + (w & p)
    return (((ph * n + img) * s0 + (h >> log2p)) * s0 + (w >> log2p)) * c


@pytest.mark.parametrize("case", sorted(GENS))
def test_gen2_walk_covers_every_output_once(case):
    n, ldz, s0, c0, couts = GENS[case]
    for resident in (2 * H100_SMS, 7):
        grid, layers = gen2_plan(n, ldz, s0, c0, couts, resident)
        assert 1 <= grid <= resident
        covers, visits = _gen2_walk(n, s0, c0, couts, grid, layers)
        for v in visits:
            assert (v == 1).all()  # every tile of every layer once
        for c in covers:
            assert (c == 1).all()  # every output element once


@pytest.mark.parametrize("layout", ["phased", "nhwc"])
@pytest.mark.parametrize("case", sorted(GENS))
def test_image_placement_writes_every_element_once(case, layout):
    """The last layer's tiles, placed by either megakernel's image layout,
    write every element of the image once: v2's phased (P, P, n, s0, s0,
    C) and v1's (n, S, S, C) alike."""
    n, ldz, s0, c0, couts = GENS[case]
    grid, layers = gen2_plan(n, ldz, s0, c0, couts, 2 * H100_SMS)
    nl, cout = len(couts), couts[-1]
    hs = s0 << (nl - 1)
    count = np.zeros(n * (2 * hs) ** 2 * cout, np.int64)
    visits = np.zeros(layers[-1][2], np.int32)
    for img, h, w, ch in _convt_writes(n, hs, layers[-1], cout, grid, visits):
        off = image_offset(layout, n, s0, nl, cout, img, h, w) + ch
        np.add.at(count, off.ravel(), 1)
    assert (visits == 1).all()
    assert (count == 1).all()


def test_gen2_main_path_fills_the_card():
    """At batch 256, 64 px, the grid is 2 blocks a SM and no layer splits
    its depth."""
    grid, layers = gen2_plan(*GENS["64px_b256"], 2 * H100_SMS)
    assert grid == 2 * H100_SMS
    kinds, bns, tiles, steps = zip(*layers)
    assert kinds == (0, 1, 1, 1, 2)
    assert bns == (128, 128, 128, 64, 8)
    assert tiles == (128, 256, 512, 2048, 2048)
    assert steps == (2, 32, 16, 8, 9)


def _gen2_operands(rng, nz, s0, c0, chans, cout_last):
    z = torch.from_numpy(rng.standard_normal((3, nz)).astype(np.float32))
    n_head = s0 * s0 * c0
    head = (torch.from_numpy(
        (rng.standard_normal((nz, n_head)) * 0.2).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.5, 1.5, n_head).astype(np.float32)),
        torch.from_numpy(rng.uniform(-0.1, 0.1, n_head).astype(np.float32)))
    blocks, cin = [], c0
    for cout in [*chans, cout_last]:
        blocks.append((
            torch.from_numpy((rng.standard_normal((4, 4, cin, cout)) * 0.1)
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)),
            torch.from_numpy(rng.uniform(-0.1, 0.1, cout).astype(np.float32))))
        cin = cout
    return z, head, blocks


@pytest.mark.parametrize("plain", [cuda_gen.generator_forward_plain,
                                   cuda_gen2.generator_forward_plain],
                         ids=["v1", "v2"])
@pytest.mark.parametrize("nz,s0,c0,chans,cout_last,copies", [
    (100, 4, 64, [32, 16], 3, ["z"]),          # the full-width shapes' rule
    (20, 4, 12, [10, 5], 3, ["z", "c0", "inner"]),
    (24, 7, 16, [8], 1, []),
    (16, 2, 200, [], 3, ["last"]),            # Cin 200: a wide last layer
])
def test_gen2_operand_padding_keeps_the_result(nz, s0, c0, chans, cout_last,
                                               copies, plain):
    """Both megakernels take these operands: each plain version gives the
    same image on the padded operands as on the folded generator's."""
    z, head, blocks = _gen2_operands(np.random.default_rng(nz + c0), nz, s0,
                                     c0, chans, cout_last)
    couts = [*chans, cout_last]
    kinds = [layer[0] for layer in gen2_plan(3, -(-nz // 8) * 8, s0, c0,
                                             couts, 1)[1][1:]]
    zb, hb, bb, c0p = cuda_gen.kernel_operands(z, head, blocks, s0, c0,
                                               kinds)
    assert zb.shape[1] % 8 == 0 and c0p % 8 == 0 and c0p >= c0
    assert ("z" in copies) == (zb.shape[1] != nz)
    assert ("c0" in copies) == (c0p != c0)
    for i, (w, a, b, ldb) in enumerate(bb):
        cin = w.shape[2]
        assert cin == (c0p if i == 0 else bb[i - 1][3])
        if i < len(bb) - 1:
            assert ldb % 8 == 0 and w.shape[3] == a.shape[0] == ldb
            assert ("inner" in copies) == (ldb != blocks[i][0].shape[3])
        else:
            assert a.shape[0] == cout_last
            assert ("last" in copies) == (ldb != cout_last)
    # the kernel meets z's zero columns with TMA's zero fill of wh's rows
    wh = pad_dim(hb[0].float(), 0, zb.shape[1])
    got = plain(zb.float(), (wh, hb[1], hb[2]),
                [(w.float()[..., :a.shape[0]], a, b) for w, a, b, _ in bb],
                s0, c0p)
    ref = plain(z.to(torch.bfloat16).float(), head, blocks, s0, c0)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s for s, _, _ in SPLITS_TF32]
                         + [(n, 2 * h, 2 * w, 32, 136) for n, h, w in GRIDS])
def test_library_tf32_plan_follows_the_rule(shape):
    """The plan of kernel 5's TF32 route from the library is
    ``plan_tf32``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, h, w, cin, cout = shape
    x = torch.empty((1, 1, 1, 1), device="cuda").expand(n, h, w, cin)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cuda_conv_stats.plan_tf32(x, cout) == plan_tf32(n, h, w, cin, cout,
                                                           sms)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s for s, _, _ in SPLITS_TF32]
                         + [(n, 2 * h, 2 * w, 96, 40) for n, h, w in GRIDS])
def test_conv_library_tf32_plan_follows_the_rule(shape):
    """Kernel 4's TF32 route plans as kernel 5's (``plan_tf32``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, h, w, cin, cout = shape
    x = torch.empty((1, 1, 1, 1), device="cuda").expand(n, h, w, cin)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cuda_conv.plan_tf32(x, cout) == plan_tf32(n, h, w, cin, cout, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [s for s, _ in SPLITS]
                         + [(128, 64, 64, 3, 64), (3, 10, 6, 3, 7),
                            (1, 4, 2, 16, 3), (7, 200, 2, 8, 128),
                            (1, 4, 4, 33, 40), (2, 8, 8, 3, 129),
                            (2, 8, 8, 17, 8)])
def test_conv_library_plan_follows_the_rule(shape):
    """The eval-mode conv's plan from the library (its path by Cin and
    Cout, the wide path's split at the card's SM count) is
    ``conv_plan``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, h, w, cin, cout = shape
    x = torch.empty((1, 1, 1, 1), device="cuda").expand(n, h, w, cin)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert cuda_conv.plan(x, cout) == conv_plan(n, h, w, cin, cout, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("lib", [cuda_gen.V1, cuda_gen.V2])
@pytest.mark.parametrize("case", sorted(GENS))
def test_gen2_library_plan_follows_the_rule(case, lib):
    """Each megakernel's walk from its library (``tg_gen_plan``,
    ``tg_gen2_plan``) is ``gen2_plan``, and the card holds 2 of its blocks a
    SM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, ldz, s0, c0, couts = GENS[case]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = cuda_gen.resident(torch.device("cuda", 0), lib)
    assert resident == 2 * sms
    grid, layers = cuda_gen.plan(n, ldz, s0, c0, couts, resident, lib)
    assert (grid, layers) == gen2_plan(n, ldz, s0, c0, couts, resident)
    assert cuda_gen.layer_kinds(s0, c0, couts, lib) == tuple(
        layer[0] for layer in layers[1:])


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
