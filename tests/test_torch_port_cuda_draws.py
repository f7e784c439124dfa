"""The threefry kernel (``ops/cuda_threefry.py``) against
``sample/threefry.py`` and JAX's saved draw, and the train step that draws
with it, on the card.

Marked ``cuda``: they skip where no CUDA device is present (decided inside
the ``cuda`` fixture, never at import).  On a machine with an H100:

    python -m pytest tests/test_torch_port_cuda_draws.py -m cuda -q

Bernoulli and randint draws are the host's bits.  ``normal`` rounds log1p
once from double: it is compared with threefry.py's formula on that log1p
(``normal_exact_log1p``) to one ulp (the card's and the host's double
log1p may round to float32 apart where the value lies within a double ulp
of a float32 midpoint), with threefry.py's own draw to three (numpy's
float32 log1p is itself an ulp off on some inputs, SIMD builds, and an ulp
of log1p moves the normal by at most three ulps over every uniform it can
take), and with JAX's draw on the CPU (``tests/data/jax_normal_draw.npy``)
to three: XLA takes its own float32 log1p and fuses the polynomial's
multiply-adds, and lies within three ulps of both formulas over every
uniform (``tests/test_torch_port_draws.py``).  This file imports no JAX.
"""

import statistics

import numpy as np
import pytest
import torch

from tpugan_torch.configs import get_preset
from tpugan_torch.models.registry import build_models
from tpugan_torch.ops import cuda_threefry
from tpugan_torch.sample import threefry
from tpugan_torch.train.state import create_train_state
from tpugan_torch.train.steps import build_train_step
from tpugan_torch.utils import tracing
from test_torch_port_draws import (JAX_DRAW, JAX_KEY, normal_exact_log1p,
                                   ulps)

pytestmark = pytest.mark.cuda

KEYS = [np.array([0, 0], np.uint32),
        np.array([0, 42], np.uint32),
        np.array([0xFFFFFFFF, 0x80000001], np.uint32),
        np.array([0x9E3779B9, 0xDEADBEEF], np.uint32)]
# a few elements, sizes that do not fill a 256-thread block, the flagship's
# latents and hflip bits, and more than the kernel's 4,096 blocks hold
SHAPES = [(1,), (7, 3), (1000,), (1024, 100), (1024, 1, 1, 1),
          (512, 1, 1, 1), (1100, 1000)]


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _host(t):
    torch.cuda.synchronize()
    return t.cpu().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]:x}_{k[1]:x}")
def test_bernoulli_and_randint_draws_are_threefrys_bits(cuda, key, shape):
    for p in (0.5, 0.3, 1e-3):
        got = _host(cuda_threefry.bernoulli(key, p, shape, cuda))
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, threefry.bernoulli(key, p, shape))
    for lo, hi in ((0, 202599), (0, 2), (-4, 1000), (5, 5)):
        got = _host(cuda_threefry.randint(key, lo, hi, shape, cuda))
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, threefry.randint(key, lo, hi,
                                                            shape))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("key", KEYS, ids=lambda k: f"{k[0]:x}_{k[1]:x}")
def test_normal_is_threefrys_within_an_ulp_of_log1p(cuda, key, shape):
    got = _host(cuda_threefry.normal(key, shape, cuda))
    assert got.dtype == np.float32 and got.shape == shape
    assert ulps(got, normal_exact_log1p(key, shape)).max() <= 1
    assert ulps(got, threefry.normal(key, shape)).max() <= 3


def test_normal_is_jaxs_within_three_ulps(cuda):
    want = np.load(JAX_DRAW)
    got = _host(cuda_threefry.normal(JAX_KEY, want.shape, cuda))
    assert ulps(got, want).max() <= 3


def test_draws_launch_once_each_without_a_copy_or_a_wait(cuda):
    key = KEYS[3]
    cuda_threefry.normal(key, (8, 4), cuda)  # built and loaded
    torch.cuda.synchronize()
    before = cuda_threefry.launches
    tracing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = [cuda_threefry.normal(key, (1024, 100), cuda),
               cuda_threefry.bernoulli(key, 0.5, (1024, 1, 1, 1), cuda),
               cuda_threefry.randint(key, 0, 202599, (1024,), cuda)]
        torch.cuda.synchronize()
    assert cuda_threefry.launches - before == 3
    assert tracing.counters() == {"device_draws": 3,
                                  "device_draws_bytes": 1024 * (400 + 1 + 8)}
    events = prof.profiler.kineto_results.events()
    host = [e.name() for e in events if e.device_type().name != "CUDA"]
    kernels = [e.name() for e in events if e.device_type().name == "CUDA"]
    assert sum("threefry_draw_kernel" in k for k in kernels) == 3, kernels
    assert not [n for n in host if n in ("cudaStreamSynchronize",
                                         "cudaMemcpy", "cudaMemcpyAsync")]
    assert all(t.device == cuda for t in out)
    tracing.reset()


def test_draw_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="one key"):
        cuda_threefry.normal(np.zeros((2, 2), np.uint32), (4,), cuda)
    with pytest.raises(ValueError, match="int32"):
        cuda_threefry.randint(KEYS[1], 0, 2 ** 33, (4,), cuda)
    assert cuda_threefry.normal(KEYS[1], (0, 3), cuda).shape == (0, 3)


# Steps run, and what they may differ by.  The two runs differ only in the
# latents' few ulps (3 at most, on ~1% of the elements).  Step 1's losses
# before any update and the first gradients of the leaves that precede any
# update are held to the fp32 cell's limits on the program against its
# plain reference (``loss1_gap``, ``grad1_med_gap`` in
# portbench/workloads/train.fp32.b512.json; these runs read ~1e-7 on
# both).  Later losses follow Adam's first update, whose lr x sign(g) moves
# the elements whose gradient is round-off apart (~1e-5 apart): a wrong draw
# moves them by percents.
STEPS = 3
LOSS1, GRAD1_MEDIAN, LOSSES = 2e-6, 4e-5, 1e-3


def _first_steps_two_ways(cuda, preset, over):
    """Each run's losses over ``STEPS`` steps and each leaf's first
    gradient (Adam's first moment after step 1, over 1 - beta1), from one
    seeded state: drawing on the card, then fed the host's draws by the
    hooks.  cuDNN deterministic, and TF32 off as the fp32 cell runs (a TF32
    conv rounds its inputs to 10 bits, so an ulp of z could move a product
    by 2^-11)."""
    cfg = get_preset(preset).override({
        "model.ngf": 16, "model.ndf": 16, "model.nz": 32,
        "data.batch_size": 16, "train.precision": "fp32",
        "train.fuse_stats": "on", **over})
    n, s, nz = cfg.data.batch_size, cfg.model.image_size, cfg.model.nz
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (n, s, s, 3),
                                           dtype=np.uint8)).to(cuda)
    labels = torch.from_numpy(rng.integers(0, max(cfg.model.n_classes, 1),
                                           (n,))).to(cuda)
    runs = []
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for hooked in (False, True):
            g, d = build_models(cfg.model, cfg.train.precision, device=cuda,
                                generator=torch.Generator().manual_seed(0))
            state = create_train_state(cfg, g, d)
            step = build_train_step(cfg, g, d)
            losses, grad1 = [], {}
            for i in range(STEPS):
                batch = {"image": images, "label": labels}
                if hooked:
                    (_, k_zd, k_zg, _, k_yd, k_yg, _,
                     _) = threefry.split(state.rng, 8)
                    batch["z_d"] = threefry.normal(k_zd, (n, nz))
                    batch["z_g"] = threefry.normal(k_zg, (n, nz))
                    if cfg.model.arch == "cdcgan":
                        c = cfg.model.n_classes
                        batch["y_fake_d"] = threefry.randint(k_yd, 0, c, (n,))
                        batch["y_fake_g"] = threefry.randint(k_yg, 0, c, (n,))
                state, metrics = step(state, batch)
                losses.append([float(metrics[k]) for k in ("loss_d",
                                                           "loss_g")])
                if i == 0:
                    for part, m, opt in (("g", g, state.opt_g),
                                         ("d", d, state.opt_d)):
                        for name, p in m.named_parameters():
                            grad1[f"{part}.{name}"] = (
                                opt.state[p]["exp_avg"].float()
                                / (1 - cfg.optim.beta1)).cpu()
            runs.append((losses, grad1))
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return cfg, runs


@pytest.mark.parametrize("preset,over", [
    ("dcgan_celeba64", {}),
    ("dcgan_celeba64_fast", {"data.device_resident": False,
                             "train.steps_per_call": 1}),
    ("cdcgan_celeba64", {}),
], ids=["alternating", "fused", "cdcgan"])
def test_step_drawing_on_the_card_is_the_step_fed_the_host_draws(
        cuda, preset, over):
    cfg, ((card_loss, card_g1), (host_loss, host_g1)) = _first_steps_two_ways(
        cuda, preset, over)
    fused = cfg.train.fused_prop

    def rel(a, b):
        return abs(a - b) / abs(b)

    # before any update: both losses of a FusedProp step, D's of an
    # alternating one (its G loss follows D's update), and those leaves
    n = 2 if fused else 1
    loss1 = max(rel(a, b) for a, b in zip(card_loss[0][:n],
                                          host_loss[0][:n]))
    assert loss1 <= LOSS1, (card_loss[0], host_loss[0])
    assert max(rel(a, b) for ca, ha in zip(card_loss, host_loss)
               for a, b in zip(ca, ha)) <= LOSSES, (card_loss, host_loss)
    before = [k for k in host_g1 if fused or k.startswith("d.")]
    norms = {k: float(host_g1[k].norm()) for k in before}
    med = statistics.median(norms.values())
    gaps = [float((card_g1[k] - host_g1[k]).norm()) / max(norms[k], med)
            for k in before]
    assert statistics.median(gaps) <= GRAD1_MEDIAN, sorted(gaps)[-5:]


def test_traced_step_draws_on_the_card_and_makes_no_blocking_copy(cuda):
    cfg = get_preset("dcgan_celeba64_fast").override({
        "model.ngf": 8, "model.ndf": 8, "model.nz": 16,
        "data.batch_size": 8, "train.steps_per_call": 1,
        "train.precision": "fp32", "train.fuse_stats": "off"})
    g, d = build_models(cfg.model, cfg.train.precision, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, g, d)
    step = build_train_step(cfg, g, d)
    batch = {"dataset_images": torch.randint(
        0, 256, (32, 64, 64, 3), dtype=torch.uint8, device=cuda)}
    state, _ = step(state, batch)
    tracing.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        step(state, batch)
    c = tracing.counters()
    assert c.get("device_draws") == 3, c  # the indices, hflip bits, z_d
    assert "h2d_blocking" not in c, c
    tracing.reset()
