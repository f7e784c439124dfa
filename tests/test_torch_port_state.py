"""The port's training state against ``tpugan.train.state`` and the JAX
step: the linear LR schedule (to float32 exactness, in D's and in G's count
domain), the EMA of G, the device-resident batch (``threefry.permutation``
and ``epoch_indices`` bit for bit, resident steps with both samplings), and
``ckpt/from_jax`` carrying the EMA, the schedule's count and ADA's state.

Tolerances are ``tests/test_torch_port_train_step.py``'s: losses 1e-4
relative plus 1e-4 absolute, parameters within lr / 20, BatchNorm
statistics 1e-4; the EMA of G within 1e-6 absolute (it moves by
(1 - decay) of a parameter's step a call, so it holds the parameters' fp32
sum-order agreement, ~1e-7 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (assert_metrics_close, assert_state_close,
                                module_arrays, run_twin_steps, to_numpy,
                                twin_train_states)
from tpugan.configs import get_preset
from tpugan.models import build_models as jax_models
from tpugan.train.state import create_train_state as jax_train_state
from tpugan.train.state import lr_schedule as jax_lr_schedule
from tpugan.train.steps import build_train_step
from tpugan.train.steps import epoch_indices as jax_epoch_indices
from tpugan_torch.ckpt.from_jax import flatten, load_jax_train_state
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.models.registry import build_models
from tpugan_torch.sample import threefry
from tpugan_torch.train.state import (create_train_state, lr_schedule,
                                      update_count)
from tpugan_torch.train.steps import build_train_step as port_step
from tpugan_torch.train.steps import data_root, epoch_indices
from tpugan_torch.train.trainer import Trainer

TINY = {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
        "data.batch_size": 6, "train.precision": "fp32"}


# -- the linear LR schedule ----------------------------------------------

@pytest.mark.parametrize("total,frac,every", [
    (8, 0.5, 1), (20, 0.5, 5), (10_000, 0.5, 1), (7, 0.3, 2), (1, 0.5, 1),
    (3, 0.0, 1)])
def test_linear_schedule_is_optaxs_in_float32(total, frac, every):
    """At every count from 0 past the end, the LR is optax's
    ``linear_schedule`` value bit for bit (D: every 1; G: every n_critic)."""
    over = {"optim.schedule": "linear", "train.total_steps": total,
            "optim.decay_start_frac": frac}
    ref = jax_lr_schedule(get_preset("dcgan_mnist").override(over), 2e-4,
                          every)
    got = lr_schedule(port_preset("dcgan_mnist").override(over), 2e-4, every)
    counts = list(range(0, min(total, 300) + 3)) + [total // every,
                                                    total // every + 1]
    for c in counts:
        want = np.float32(ref(jnp.int32(c)))
        assert got(c).dtype == np.float32
        assert got(c) == want, (c, got(c), want)
    assert got(10 ** 6) == 0.0
    assert lr_schedule(port_preset("dcgan_mnist"), 2e-4) is None


def _param_deltas(preset, over, steps, g_every=1):
    """The largest |update| of G's parameters at each of the port's G
    updates (every ``g_every``-th call)."""
    cfg = port_preset(preset).override({
        "data.batch_size": 8, "model.ngf": 8, "model.ndf": 8, "model.nz": 8,
        "train.precision": "fp32", **over})
    g, d = build_models(cfg.model, "fp32", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, g, d)
    step = port_step(cfg, g, d)
    s = cfg.model.image_size
    data = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(8, s, s, cfg.model.channels)).astype(np.uint8))
    deltas = []
    for i in range(steps):
        prev = [p.detach().clone() for p in g.parameters()]
        state, _ = step(state, {"image": data})
        if i % g_every == g_every - 1:
            deltas.append(max((p - q).abs().max().item()
                              for p, q in zip(g.parameters(), prev)))
    return deltas, state


def test_linear_lr_schedule_decays_to_zero():
    """tests/test_train_step.py's check on the port: updates shrink over
    the run under "linear" and not under "constant", and after the run
    each optimizer's LR is the schedule's at its own count."""
    lin, state = _param_deltas("dcgan_mnist", {
        "train.total_steps": 8, "optim.schedule": "linear"}, 8)
    const, _ = _param_deltas("dcgan_mnist", {
        "train.total_steps": 8, "optim.schedule": "constant"}, 8)
    assert lin[-1] < 0.5 * lin[4], lin
    assert lin[-1] < 0.6 * const[-1], (lin[-1], const[-1])
    assert const[-1] > 0.5 * const[4], const
    assert update_count(state.opt_d) == update_count(state.opt_g) == 8
    # the LR of the last update: count 7 of 8, decay from 4: a quarter
    assert state.opt_d.param_groups[0]["lr"] == float(np.float32(2e-4)
                                                      * np.float32(0.25))


def test_linear_lr_schedule_decays_g_under_n_critic():
    """G's count advances once every n_critic calls; its schedule runs in
    that domain (total // n_critic), so its last update is visibly smaller
    than its first (tests/test_train_step.py's check)."""
    over = {"train.total_steps": 20, "loss.kind": "wgan",
            "loss.n_critic": 5}
    lin, state = _param_deltas("dcgan_mnist", {
        **over, "optim.schedule": "linear"}, 20, g_every=5)
    const, _ = _param_deltas("dcgan_mnist", {
        **over, "optim.schedule": "constant"}, 20, g_every=5)
    assert len(lin) == 4
    assert lin[-1] < 0.75 * lin[0], lin
    assert const[-1] > 0.75 * const[0], const
    assert update_count(state.opt_g) == 4
    assert update_count(state.opt_d) == 20


@pytest.mark.parametrize("preset,over", [
    ("dcgan_cifar10", {"train.total_steps": 6}),
    ("wgan_cifar10", {"train.total_steps": 8, "loss.n_critic": 2}),
], ids=["adam", "rmsprop_n_critic2"])
def test_linear_schedule_steps_match_jax(preset, over):
    """Four calls under "linear" from one carried state: losses and state
    as the JAX step's (the decay starts inside the run)."""
    over = {**TINY, **over, "optim.schedule": "linear"}
    jstate, pstate, jms, pms = run_twin_steps(preset, over, calls=4)
    assert_metrics_close(jms, pms)
    cfg = port_preset(preset).override(over)
    lr = max(cfg.optim.lr_g, cfg.optim.lr_d)
    assert_state_close(jstate, pstate, atol=lr / 20)


# -- the EMA of G -----------------------------------------------------------

@pytest.mark.parametrize("preset,over", [
    ("dcgan_celeba64", {}),
    ("wgan_cifar10", {"loss.n_critic": 2}),
    ("dcgan_celeba64", {"train.fused_prop": True, "loss.n_critic": 1}),
], ids=["alternating", "alternating_n_critic2", "fused"])
def test_ema_matches_jax(preset, over):
    """Three calls with ema 0.9: the port's ``g_ema`` is JAX's
    ``params_g_ema`` within 1e-6 (updated after each G update: every call,
    every second under n_critic 2, every call under FusedProp)."""
    over = {**TINY, **over, "train.ema": 0.9}
    jstate, pstate, jms, pms = run_twin_steps(preset, over, calls=3)
    assert_metrics_close(jms, pms)
    arrays = module_arrays(pstate.g_ema)
    ema = flatten(to_numpy(jstate.params_g_ema))
    assert sorted(ema) == sorted(dict(pstate.g_ema.named_parameters()))
    for k, v in ema.items():
        np.testing.assert_allclose(arrays[k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
    # it moved off G's initial weights, and is not G's current weights
    g_now = module_arrays(pstate.g)
    assert any(not np.array_equal(arrays[k], g_now[k]) for k in ema)


def test_ema_module_samples_with_gs_live_buffers(tmp_path):
    """The EMA copy takes no gradient, and the trainer's sampler runs it
    with G's BatchNorm statistics of the moment."""
    cfg = port_preset("dcgan_cifar10").override({
        **TINY, "data.dataset": "synthetic", "data.synthetic_size": 12,
        "train.ema": 0.5,
        "train.out_dir": str(tmp_path), "train.ckpt_dir": str(tmp_path),
        "train.sample_every": 0})
    tr = Trainer(cfg, device="cpu")
    assert all(not p.requires_grad for p in tr.state.g_ema.parameters())
    tr.train(2)
    g_bufs = dict(tr.g.named_buffers())
    stale = dict(tr.state.g_ema.named_buffers())
    assert any(not torch.equal(stale[k], g_bufs[k]) for k in g_bufs)
    mod = tr.sampler().g
    assert mod is tr.state.g_ema
    for k, b in mod.named_buffers():
        assert torch.equal(b, g_bufs[k]), k
    ema_p = dict(mod.named_parameters())
    assert any(not torch.equal(ema_p[k], p)
               for k, p in tr.g.named_parameters())


# -- device-resident data ----------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 1000, 5000])
def test_permutation_is_jaxs(n):
    """JAX sorts by fresh random bits, stably, in ceil(3 ln n / ln(2^32 -
    1)) rounds: none at n = 1, one to n = 1625, two at 5000."""
    for seed, data in ((0, 3), (7, 0xDA7A)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        key = threefry.fold_in(threefry.prng_key(seed), data)
        ref = np.asarray(jax.random.permutation(jkey, n))
        got = threefry.permutation(key, n)
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,bsz,steps", [
    (7, 3, range(6)),         # batches straddle epochs 0/1, 1/2, ...
    (1000, 64, (0, 15, 16)),  # step 15 straddles the first epoch's end
    (12, 12, (0, 1, 5)),      # a batch the size of the dataset
])
def test_epoch_indices_are_jaxs(n, bsz, steps):
    jroot = jax.random.fold_in(jax.random.PRNGKey(4), 0xDA7A)
    for s in steps:
        ref = np.asarray(jax_epoch_indices(jroot, jnp.int32(s), bsz, n))
        got = epoch_indices(data_root(4), s, bsz, n)
        np.testing.assert_array_equal(got, ref, err_msg=f"step {s}")
    with pytest.raises(ValueError, match="straddle"):
        epoch_indices(data_root(4), 0, n + 1, n)


def test_replacement_indices_are_jaxs():
    key = threefry.split(threefry.prng_key(3), 8)[7]
    jkey = jax.random.split(jax.random.PRNGKey(3), 8)[7]
    for n, bsz in ((64, 8), (5120, 256)):
        ref = np.asarray(jax.random.randint(jkey, (bsz,), 0, n))
        np.testing.assert_array_equal(threefry.randint(key, 0, n, (bsz,)),
                                      ref)


@pytest.mark.parametrize("preset,over", [
    ("dcgan_cifar10", {}),
    ("cdcgan_celeba64", {"data.sampling": "epoch", "optim.eps": 1e-4}),
], ids=["replacement", "epoch_conditional"])
def test_resident_steps_match_jax(preset, over):
    """Three calls on a resident 20-image dataset: the same gathered
    batches (and labels) as the JAX step's, so the same losses and state
    (the conditional case with Adam's eps at 1e-4, as in
    tests/test_torch_port_train_step.py)."""
    over = {**TINY, **over, "data.device_resident": True,
            "data.synthetic_size": 20}
    jstate, pstate, jms, pms = run_twin_steps(preset, over, calls=3,
                                              resident=True)
    assert_metrics_close(jms, pms)
    assert_state_close(jstate, pstate, atol=2e-4 / 20)


# -- ckpt/from_jax: the EMA and the schedule's count ------------------------

@pytest.mark.parametrize("preset,over", [
    ("dcgan_cifar10", {}),
    ("wgan_cifar10", {"loss.n_critic": 2}),
], ids=["adam", "rmsprop"])
def test_from_jax_carries_ema_and_schedule_count(preset, over):
    """A JAX state two calls into a linear schedule, with an EMA, carried
    into a fresh port state: each optimizer's count is the schedule's
    (RMSprop's optax state keeps no other), g_ema is params_g_ema, and the
    next call of both steps agrees at the decayed LR."""
    over = {**TINY, **over, "optim.schedule": "linear",
            "train.total_steps": 4, "train.ema": 0.9}
    cfg, g, d, jstate, pcfg, _ = twin_train_states(preset, over)
    jstep = build_train_step(cfg, g, d)
    rng = np.random.default_rng(2)
    s = cfg.model.image_size
    batch = {"image": rng.integers(0, 256, size=(6, s, s, 3)).astype(
        np.uint8)}
    for _ in range(2):
        jstate, _ = jstep(jstate, {"image": jnp.asarray(batch["image"])})
    host = jax.device_get(jstate)
    *_, pcfg2, pstate = twin_train_states(preset, over)
    from tpugan_torch.ckpt.from_jax import load_jax_train_state

    load_jax_train_state(pstate, host)
    g_updates = 2 if cfg.loss.n_critic == 1 else 1
    assert update_count(pstate.opt_d) == 2
    assert update_count(pstate.opt_g) == g_updates
    for k, v in flatten(to_numpy(host.params_g_ema)).items():
        np.testing.assert_array_equal(module_arrays(pstate.g_ema)[k], v)
    jstate, jm = jstep(jstate, {"image": jnp.asarray(batch["image"])})
    pstate, pm = port_step(pcfg2, pstate.g, pstate.d)(
        pstate, {"image": torch.from_numpy(batch["image"])})
    assert_metrics_close([{k: float(v) for k, v in jm.items()}],
                         [{k: v.item() for k, v in pm.items()}])
    assert_state_close(jax.device_get(jstate), pstate,
                       atol=max(cfg.optim.lr_g, cfg.optim.lr_d) / 20)


# -- ADA's state: TrainState fields, from_jax ------------------------------

def test_ada_state_is_jaxs_and_carries():
    """Under ada_target the port's state holds ``ada_p`` and ``ada_rt`` as
    0-dim float32 tensors, zero as JAX's start, None without ADA; from_jax
    carries a JAX state's values exactly, and refuses a state whose ADA
    fields disagree with the port's."""
    over = {**TINY, "train.augment": "color",
            "train.ada_target": 0.6}
    cfg = get_preset("dcgan_cifar10").override(over)
    jg, jd = jax_models(cfg.model, "fp32")
    fresh = jax_train_state(cfg, jg, jd)
    pcfg = port_preset("dcgan_cifar10").override(over)
    tg, td = build_models(pcfg.model, "fp32", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    pstate = create_train_state(pcfg, tg, td)
    for k in ("ada_p", "ada_rt"):
        got = getattr(pstate, k)
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.item() == float(getattr(fresh, k)) == 0.0
    plain = create_train_state(
        port_preset("dcgan_cifar10").override(TINY), tg, td)
    assert plain.ada_p is None and plain.ada_rt is None

    *_, jstate, _, carried = twin_train_states(
        "dcgan_cifar10", over, ada_p=np.float32(0.25),
        ada_rt=np.float32(-0.1))
    assert carried.ada_p.item() == 0.25
    assert carried.ada_rt.item() == float(np.float32(-0.1))
    with pytest.raises(ValueError, match="ada_p"):
        load_jax_train_state(plain, jax.device_get(jstate))
