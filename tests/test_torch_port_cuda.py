"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (decided inside
the ``cuda`` fixture, never at import).  On a machine with an H100:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q

Edge shapes the main path never gives (Cin not a multiple of the 32-deep
staging step, Cout not a multiple of 16, ragged row tiles, the 7x7 base,
batches that do not fill a block) are here; ``chip_smoke.py`` holds the
kernels at the main path's own shapes.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from tpugan_torch.configs import get_preset
from tpugan_torch.models.registry import build_generator
from tpugan_torch.ops import cuda_convt, cuda_gen, cuda_gen2

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


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "tanh", "none"])
@pytest.mark.parametrize("out_dtype", [torch.float32, BF])
@pytest.mark.parametrize("n,h,w,cin,cout", [(3, 5, 5, 20, 7), (2, 4, 4, 64, 16),
                                            (1, 7, 7, 33, 40),
                                            (5, 8, 8, 16, 3)])
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
    # same bf16 products; fp32 sums in another order (~1e-6 relative), and
    # for a bf16 output one flipped rounding (2^-8 relative)
    tol = 1e-2 if out_dtype == BF else 1e-4
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


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
