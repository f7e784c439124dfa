"""The port's train step against ``tpugan.train.build_train_step``, from
one ``TrainState`` carried across (``ckpt/from_jax.load_jax_train_state``),
in fp32 on the same uint8 batches: the logged losses at each of three steps,
and the parameters and BatchNorm running statistics after one and after
three steps, with fuse_stats on and off; then the step options (FusedProp,
grad_accum, remat, steps_per_call) the same way.

Tolerances: each step's gradients differ from JAX's by fp32 sum order only
(~1e-6 relative).  Adam and RMSprop divide a gradient by its own running
RMS, so every parameter moves by up to about lr per step whatever the size
of its gradient: parameters are held absolutely, to lr / 20 (lr = 2e-4, and
5e-5 for the RMSprop row), far below one step's move, so a wrong update
shows, while sum-order noise (under 1e-6 here) does not.  A near-zero
gradient whose sign flipped between the two would move its parameter by
about 2 lr and fail the check.  The losses and BatchNorm statistics move
with the parameters: 1e-4 relative plus 1e-4 absolute, after three steps.

The conditional case has such gradients by construction: the label
embedding enters G's head and D's label projection as two distinct rows (one
per class), so those weights' gradients are rank-2 sums e[0] A0 + e[1] A1
that cancel to within fp32 sum-order noise of zero (dg ~ 1e-6 of the
gradient's scale) at a few of their 250,000 entries.  Adam moves an entry
by lr g / (|g| + eps), which a gradient error dg changes by at most
lr dg / eps: a whole lr at the preset's eps of 1e-8, lr / 100 at 1e-4.  That
case runs with eps = 1e-4; the other entries' gradients (median ~3e-2) still
move their parameters by ~lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (assert_metrics_close, assert_state_close,
                                module_arrays, port_states_equal,
                                run_twin_steps, to_numpy, twin_train_states)
from tpugan import ops as jax_ops
from tpugan.data.datasets import make_synthetic
from tpugan.train.steps import build_train_step
from tpugan_torch.ckpt.from_jax import flatten
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.train.steps import build_train_step as port_step

CASES = [
    # 64 px, BN in both nets, hflip on (the chip's configuration, cut)
    ("dcgan_celeba64", {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
                        "data.batch_size": 6}),
    # 32 px schedules
    ("dcgan_cifar10", {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
                       "data.batch_size": 6}),
    # RMSprop, weight clipping, and a G update every second call
    ("wgan_cifar10", {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
                      "data.batch_size": 6, "loss.n_critic": 2}),
    # hinge loss, spectral norm in every DBlock and the tail (its u moves
    # in three train-mode D forwards a step), no BN in D
    ("sngan_cifar10", {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
                       "data.batch_size": 6}),
    # the gradient penalty (a double backward through D in eval mode, alpha
    # from the step's k_gp), Adam(1e-4, 0.5/0.9), a G update every second
    # call
    ("wgan_gp_cifar10", {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
                         "data.batch_size": 6, "loss.n_critic": 2}),
    # the conditional pair: real labels from the batch, fake labels drawn
    # from k_yd / k_yg, the label plane as D's fourth input channel, with
    # Adam's eps at 1e-4 (module doc)
    ("cdcgan_celeba64", {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
                         "data.batch_size": 6, "optim.eps": 1e-4}),
]


@pytest.fixture
def fuse():
    yield
    jax_ops.set_fuse_stats("off")


def _compare_state(jstate, pstate, atol):
    for mod, params, st in ((pstate.g, jstate.params_g, jstate.state_g),
                            (pstate.d, jstate.params_d, jstate.state_d)):
        arrays = module_arrays(mod)
        for k, v in flatten(to_numpy(params)).items():
            np.testing.assert_allclose(arrays[k], v, rtol=0, atol=atol,
                                       err_msg=k)
        for k, v in flatten(to_numpy(st)).items():
            np.testing.assert_allclose(arrays[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    assert pstate.step == int(jstate.step)
    np.testing.assert_array_equal(pstate.rng, np.asarray(jstate.rng))


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("preset,overrides", CASES, ids=[c[0] for c in CASES])
def test_three_steps_match_jax(fuse, preset, overrides, mode):
    _three_steps(preset, overrides, mode, state_after=(0, 2))


@pytest.mark.parametrize("mode", ["on", "off"])
def test_cdcgan128_steps_match_jax(fuse, mode):
    """cdcgan_celeba128 at ndf = ngf = 4: the losses of three steps and the
    state after the first.  By the third step the two packages' gradients
    part by more than sum order in a few entries: a ReLU or LeakyReLU
    input within fp32 noise of its kink takes the other slope in one of
    them, so the state after three steps is not a well-posed comparison at
    this size."""
    _three_steps("cdcgan_celeba128",
                 {"model.ngf": 4, "model.ndf": 4, "model.nz": 12,
                  "data.batch_size": 4, "optim.eps": 1e-4}, mode,
                 state_after=(0,))


def _three_steps(preset, overrides, mode, state_after):
    overrides = {**overrides, "train.precision": "fp32",
                 "train.fuse_stats": mode}
    cfg, g, d, jstate, pcfg, pstate = twin_train_states(preset, overrides)
    jax_ops.set_fuse_stats(mode)
    jstep = build_train_step(cfg, g, d)
    pstep = port_step(pcfg, pstate.g, pstate.d)
    bsz = cfg.data.batch_size
    data = make_synthetic(cfg.model.image_size, cfg.model.channels, 3 * bsz,
                          seed=5, n_classes=max(cfg.model.n_classes, 0))
    lr = max(cfg.optim.lr_g, cfg.optim.lr_d)
    for i in range(3):
        part = slice(i * bsz, (i + 1) * bsz)
        batch = {"image": data["images"][part]}
        if cfg.model.arch == "cdcgan":
            batch["label"] = data["labels"][part]
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        pstate, pm = pstep(pstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for k, v in jm.items():
            np.testing.assert_allclose(pm[k].item(), float(v), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {k}")
        if i in state_after:
            _compare_state(jax.device_get(jstate), pstate, atol=lr / 20)


def test_parity_hooks_replace_the_draws():
    """The batch entries z_d, z_g, y_fake_d, y_fake_g and gp_alpha replace
    the step's own draws, in both packages alike (a conditional model under
    the gradient penalty takes all five)."""
    over = {"model.ngf": 4, "model.ndf": 4, "model.nz": 8,
            "data.batch_size": 4, "train.precision": "fp32",
            "loss.kind": "wgan_gp", "loss.n_critic": 1}
    cfg, g, d, jstate, pcfg, pstate = twin_train_states("cdcgan_celeba64",
                                                        over)
    rng = np.random.default_rng(8)
    data = make_synthetic(64, 3, 4, seed=6, n_classes=2)
    hooks = {"z_d": rng.standard_normal((4, 8)).astype(np.float32),
             "z_g": rng.standard_normal((4, 8)).astype(np.float32),
             "y_fake_d": np.array([1, 1, 0, 1], np.int32),
             "y_fake_g": np.array([0, 0, 1, 0], np.int32),
             "gp_alpha": np.array([0.1, 0.5, 0.9, 0.3], np.float32)}
    batch = {"image": data["images"], "label": data["labels"], **hooks}
    _, jm = build_train_step(cfg, g, d)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    pstep = port_step(pcfg, pstate.g, pstate.d)
    _, pm = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(jm["gp"]) > 0
    for k, v in jm.items():
        np.testing.assert_allclose(pm[k].item(), float(v), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # without the hooks the step draws other latents, labels and alpha
    *_, pcfg2, pstate2 = twin_train_states("cdcgan_celeba64", over)
    _, drawn = port_step(pcfg2, pstate2.g, pstate2.d)(pstate2, {
        "image": torch.from_numpy(data["images"]),
        "label": torch.from_numpy(data["labels"])})
    assert drawn["gp"].item() != pm["gp"].item()


# -- the step options: FusedProp, grad_accum, remat, steps_per_call --------

TINY = {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
        "data.batch_size": 6, "train.precision": "fp32"}

FUSED = [
    ("dcgan_celeba64", {"train.fuse_stats": "on"}),
    ("dcgan_celeba64", {"train.fuse_stats": "off"}),
    ("sngan_cifar10", {}),
    ("cdcgan_celeba64", {"optim.eps": 1e-4}),
]


@pytest.mark.parametrize("preset,over", FUSED,
                         ids=["dcgan_celeba64_fuse_on",
                              "dcgan_celeba64_fuse_off", "sngan_cifar10",
                              "cdcgan_celeba64"])
def test_fused_prop_matches_jax(preset, over):
    """FusedProp: one G forward, D on the fake once, two pulls from that
    graph, both updates from the pre-update D; three calls."""
    over = {**TINY, **over, "train.fused_prop": True, "loss.n_critic": 1}
    jstate, pstate, jms, pms = run_twin_steps(preset, over, calls=3)
    assert_metrics_close(jms, pms)
    assert_state_close(jstate, pstate, atol=2e-4 / 20)


@pytest.mark.parametrize("over,match", [
    ({"loss.kind": "wgan_gp"}, "fused_prop requires"),
    ({"loss.n_critic": 2}, "fused_prop requires"),
    ({"train.grad_accum": 2}, "grad_accum requires fused_prop off"),
])
def test_fused_prop_guards_raise(over, match):
    cfg = port_preset("dcgan_cifar10").override(
        {**TINY, "train.fused_prop": True, **over})
    with pytest.raises(ValueError, match=match):
        port_step(cfg, None, None)


@pytest.mark.parametrize("preset,over", [
    # the penalty on each microbatch with its split(k_gp, 2) key
    ("wgan_gp_cifar10", {"loss.n_critic": 2}),
    # BN statistics threading through microbatches of three images: with
    # Adam's eps at 1e-4 (module doc), as a few G gradients of this case
    # sit within sum-order noise of zero
    ("dcgan_celeba64", {"train.fuse_stats": "on", "optim.eps": 1e-4}),
], ids=["wgan_gp_cifar10", "dcgan_celeba64"])
def test_grad_accum_matches_jax(preset, over):
    over = {**TINY, **over, "train.grad_accum": 2}
    jstate, pstate, jms, pms = run_twin_steps(preset, over, calls=3)
    assert_metrics_close(jms, pms)
    assert_state_close(jstate, pstate, atol=2e-4 / 20)


@pytest.mark.parametrize("over,match", [
    ({"train.grad_accum": 0}, "must be >= 1"),
    ({"train.grad_accum": 4}, "not divisible"),
])
def test_grad_accum_guards_raise(over, match):
    cfg = port_preset("dcgan_cifar10").override({**TINY, **over})
    with pytest.raises(ValueError, match=match):
        port_step(cfg, None, None)


@pytest.mark.parametrize("preset,over", [
    ("dcgan_cifar10", {}),
    ("sngan_cifar10", {}),
    # after two calls one G gradient of this case sits within fp32
    # sum-order noise of zero, in the plain steps too (each package's remat
    # step is its plain step bit for bit): Adam's eps at 1e-4 (module doc)
    ("dcgan_celeba64", {"train.fuse_stats": "on", "optim.eps": 1e-4}),
], ids=["dcgan_cifar10", "sngan_cifar10", "dcgan_celeba64_fuse_on"])
def test_remat_matches_jax_and_the_plain_step(preset, over):
    """``train.remat``: JAX's remat step within the usual tolerance, and
    the port's own plain step bit for bit, BatchNorm statistics and
    spectral norm's u included: the recomputation sees the buffers the
    first forward saw and leaves them as it found them."""
    over = {**TINY, **over}
    jstate, rstate, jms, pms = run_twin_steps(
        preset, {**over, "train.remat": True}, calls=2)
    assert_metrics_close(jms, pms)
    assert_state_close(jstate, rstate, atol=2e-4 / 20)
    _, plain, _, plain_ms = run_twin_steps(preset, over, calls=2)
    assert plain_ms == pms
    for mod in ("g", "d"):
        ref = module_arrays(getattr(plain, mod))
        for k, v in module_arrays(getattr(rstate, mod)).items():
            np.testing.assert_array_equal(v, ref[k], err_msg=f"{mod}.{k}")


def test_steps_per_call_is_k_single_calls_and_jaxs_scan():
    """K = 3 steps a call on stacked host batches: bit for bit three single
    calls of the port's step, and the JAX scan's state and last metrics."""
    over = {**TINY, "train.steps_per_call": 3, "train.total_steps": 6}
    jstate, pstate, jms, pms = run_twin_steps("dcgan_cifar10", over,
                                              calls=2)
    assert_metrics_close(jms, pms)
    assert_state_close(jstate, pstate, atol=2e-4 / 20)
    *_, pcfg, single = twin_train_states("dcgan_cifar10", {
        **over, "train.steps_per_call": 1})
    step1 = port_step(pcfg, single.g, single.d)
    data = make_synthetic(32, 3, 36, seed=5)
    for i in range(6):
        single, m = step1(single, {"image": torch.from_numpy(
            data["images"][6 * i:6 * (i + 1)])})
    assert {k: v.item() for k, v in m.items()} == pms[-1]
    port_states_equal(single, pstate)


# -- augmentation (train.augment) and ADA (train.ada_target) ----------------

AUG = {"train.augment": "color,translation,cutout"}


@pytest.mark.parametrize("preset,over", [
    # alternating: fresh draws for reals and fakes, G's loss through the
    # policy, with hflip and the conv + BN-statistics path
    ("dcgan_celeba64", {"train.fuse_stats": "on"}),
    # one draw on the fake shared by both pulls; Adam's eps at 1e-4 (module
    # doc: one D gradient of this case sits within sum-order noise of zero)
    ("dcgan_celeba64", {"train.fused_prop": True, "optim.eps": 1e-4}),
    # split(k_aug, 2) per microbatch; Adam's eps at 1e-4 as in
    # test_grad_accum_matches_jax
    ("dcgan_celeba64", {"train.grad_accum": 2, "optim.eps": 1e-4}),
    # the penalty's interpolates between the augmented pair
    ("wgan_gp_cifar10", {"loss.n_critic": 2}),
], ids=["alternating", "fused_prop", "grad_accum", "wgan_gp"])
def test_augment_steps_match_jax(preset, over):
    """Three steps under the full policy from one carried state: the
    state's key splits into 10, the policy's draws are JAX's, and the
    zeros that cutout and translation make reach LeakyReLU's kink, where
    both packages take slope 1."""
    jstate, pstate, jms, pms = run_twin_steps(
        preset, {**TINY, **AUG, **over}, calls=3)
    assert_metrics_close(jms, pms)
    assert_state_close(jstate, pstate, atol=2e-4 / 20)


@pytest.mark.parametrize("preset,over", [
    ("cdcgan_celeba64", {"optim.eps": 1e-4}),
    ("dcgan_celeba64", {"train.fused_prop": True, "optim.eps": 1e-4}),
], ids=["cdcgan_celeba64", "fused_prop"])
def test_ada_steps_match_jax(preset, over):
    """ADA from p = 0.5 (carried in the JAX state) with p moving 0.1 a step
    (batch 6, ada_kimg 0.06): each op gated per sample on the device's p,
    r_t folded at ada_rt_alpha(6).  ``ada_p`` and ``ada_rt_batch`` are held
    exactly: rt_batch is a mean of signs, exact unless a real logit's sign
    differed between the packages, which then fails here; ``ada_rt``
    within an ulp (XLA may contract its blend into a fused multiply-add).
    The conditional case at Adam's eps of 1e-4 (module doc)."""
    over = {**TINY, **AUG, **over, "train.ada_target": 0.6,
            "train.ada_kimg": 0.06}
    jstate, pstate, jms, pms = run_twin_steps(preset, over, calls=3,
                                              ada_p=np.float32(0.5),
                                              ada_rt=np.float32(0.0))
    assert_metrics_close(jms, pms)
    assert_state_close(jstate, pstate, atol=2e-4 / 20)
    for jm, pm in zip(jms, pms):
        assert pm["ada_p"] == jm["ada_p"]
        assert pm["ada_rt_batch"] == jm["ada_rt_batch"]
        np.testing.assert_allclose(pm["ada_rt"], jm["ada_rt"], rtol=2.4e-7,
                                   atol=1e-9)
    ps = [m["ada_p"] for m in pms]
    assert all(0.0 <= p <= 1.0 for p in ps) and ps[0] != 0.5
    assert len(set(ps)) == 3  # p moved at every step


@pytest.mark.parametrize("over,match", [
    ({"train.ada_target": 0.6}, "requires train.augment"),
    ({**AUG, "train.ada_target": 0.6, "loss.kind": "lsgan"},
     "zero-calibrated"),
    ({"train.augment": "color,blur"}, "unknown augment op"),
])
def test_augment_guards_raise(over, match):
    cfg = port_preset("dcgan_cifar10").override({**TINY, **over})
    with pytest.raises(ValueError, match=match):
        port_step(cfg, None, None)
