"""The port's checkpoints (``tpugan_torch/ckpt/checkpoint.py``) and the
Trainer's save / resume / halt / preemption paths, after
``tests/test_checkpoint.py`` and ``tests/test_aux_subsystems.py``: a
roundtrip is bit-exact, N + resume + N steps equal 2N steps bit for bit
(a linear schedule, the EMA of G and spectral norm; the host pipeline and
device-resident epoch sampling), retention, overwrite, an atomic
``config.json``, restore onto another device, ``halt_on_nonfinite`` and
SIGTERM.  Every preset the port trains runs at its default ``ckpt_every``
and writes its final checkpoint.  This file imports no JAX."""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from _torch_port_common import port_states_equal
from tpugan_torch.ckpt.checkpoint import CheckpointManager
from tpugan_torch.configs import get_preset
from tpugan_torch.train import trainer as trainer_mod
from tpugan_torch.train.trainer import NonFiniteLossError, Trainer

TINY = {"data.dataset": "synthetic", "data.synthetic_size": 24,
        "data.batch_size": 6, "model.ngf": 8, "model.ndf": 8, "model.nz": 12,
        "train.precision": "fp32", "train.log_every": 1,
        "train.sample_every": 0}


def _cfg(tmp_path, preset="sngan_cifar10", run="run", **over):
    return get_preset(preset).override({
        **TINY, "train.out_dir": str(tmp_path / run / "out"),
        "train.ckpt_dir": str(tmp_path / run / "ckpt"), **over})


# sngan_cifar10 (spectral norm's u in D) with a linear schedule whose
# decay starts inside the run and an EMA of G
STATEFUL = {"optim.schedule": "linear", "train.total_steps": 8,
            "train.ema": 0.9}


def test_roundtrip_is_bit_exact(tmp_path):
    tr = Trainer(_cfg(tmp_path, **STATEFUL, **{"train.ckpt_every": 0}),
                 device="cpu")
    tr.train(3)
    ckpt = CheckpointManager(str(tmp_path / "c"))
    tr.save_checkpoint(ckpt)
    assert ckpt.latest_step() == 3
    fresh = Trainer(_cfg(tmp_path, **STATEFUL), device="cpu")
    assert fresh.restore(str(tmp_path / "c")) == 3
    port_states_equal(tr.state, fresh.state)
    # the restored optimizers' counts stay on the CPU, as torch.optim keeps
    # them, and the restored state trains on
    assert all(st["step"].device.type == "cpu"
               for st in fresh.state.opt_d.state.values())
    fresh.train(4)
    assert fresh.state.step == 4


@pytest.mark.parametrize("preset,over", [
    ("sngan_cifar10", STATEFUL),
    ("dcgan_cifar10", {**STATEFUL, "data.device_resident": True,
                       "data.sampling": "epoch", "data.synthetic_size": 9}),
    # ADA with a target below any r_t: p climbs 0.2 a step (batch 6,
    # ada_kimg 0.03), so the gates draw at p strictly between 0 and 1
    ("sngan_cifar10", {**STATEFUL,
                       "train.augment": "color,translation,cutout",
                       "train.ada_target": -1.0, "train.ada_kimg": 0.03}),
], ids=["host_pipeline_sn_ema_linear", "resident_epoch_sampling",
        "ada_augment"])
def test_resume_equals_the_uninterrupted_run(tmp_path, preset, over):
    """4 steps, a checkpoint, resume, 4 more == 8 steps, bit for bit: the
    modules, the EMA, the moments and counts (so the decayed LR), ADA's p
    and r_t, the key and the data order (the host pipeline fast-forwards;
    the resident epochs derive from the step: batch 6 of 9 images
    straddles epochs)."""
    full = Trainer(_cfg(tmp_path, preset, "full", **over,
                        **{"train.ckpt_every": 0}), device="cpu")
    full.train(8)
    half_cfg = _cfg(tmp_path, preset, "half", **over,
                    **{"train.ckpt_every": 4})
    Trainer(half_cfg, device="cpu").train(4)
    res = Trainer(half_cfg.override({"train.resume":
                                     half_cfg.train.ckpt_dir}), device="cpu")
    res.train(8)
    port_states_equal(full.state, res.state)
    if full.state.ada_p is not None:
        assert 0.0 < full.state.ada_p.item() <= 1.0
    lr = full.state.opt_d.param_groups[0]["lr"]
    assert 0 < lr < full.cfg.optim.lr_d  # the decay had started
    # the resumed run logged steps 5..8 only
    with open(os.path.join(half_cfg.train.out_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3, 4, 5, 6, 7, 8]


def test_retention_overwrite_and_atomic_config(tmp_path):
    tr = Trainer(_cfg(tmp_path, "dcgan_cifar10", **{"train.ckpt_every": 1}),
                 device="cpu")
    tr.train(5)
    ckpt = CheckpointManager(tr.cfg.train.ckpt_dir)
    # every step saved, the newest three kept
    assert ckpt.all_steps() == [3, 4, 5]
    names = sorted(os.listdir(ckpt.directory))
    assert names == ["3.pt", "4.pt", "5.pt", "config.json"]  # no .tmp left
    cfg_json = json.loads(open(os.path.join(ckpt.directory,
                                            "config.json")).read())
    assert cfg_json["name"] == "dcgan_cifar10"
    # saving an existing step replaces it (torch.save's semantics)
    before = ckpt.restore(5)
    with torch.no_grad():
        next(tr.g.parameters()).add_(1.0)
    tr.save_checkpoint(ckpt)
    after = ckpt.restore(5)
    key = next(iter(before["g"]))
    assert torch.equal(after["g"][key], before["g"][key] + 1.0)
    small = CheckpointManager(str(tmp_path / "one"), max_to_keep=1)
    for step in (1, 2):
        small.save(step, {"step": step})
    assert small.all_steps() == [2] and small.restore()["step"] == 2
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


@pytest.mark.parametrize("map_location", ["cpu", torch.device("cpu")])
def test_restore_onto_the_trainers_device(tmp_path, map_location):
    """``restore`` maps every tensor onto the caller's device (the card's
    checkpoint onto a CPU trainer is in tests/test_torch_port_cuda.py)."""
    tr = Trainer(_cfg(tmp_path, "dcgan_cifar10", **{"train.ema": 0.5}),
                 device="cpu")
    tr.train(2)
    sd = CheckpointManager(tr.cfg.train.ckpt_dir).restore(
        map_location=map_location)
    assert sd["step"] == 2 and sd["rng"] == [int(v) for v in tr.state.rng]
    tensors = [t for part in ("g", "d", "g_ema") for t in sd[part].values()]
    assert all(t.device.type == "cpu" for t in tensors)
    # a checkpoint file path restores as its directory's latest does
    other = Trainer(_cfg(tmp_path, "dcgan_cifar10", "b", **{
        "train.ema": 0.5}), device="cpu")
    other.restore(os.path.join(tr.cfg.train.ckpt_dir, "2.pt"))
    port_states_equal(tr.state, other.state)


def test_halt_on_nonfinite_saves_then_raises(tmp_path):
    cfg = _cfg(tmp_path, "dcgan_cifar10", **{"train.halt_on_nonfinite": True,
                                              "train.ckpt_every": 0})
    tr = Trainer(cfg, device="cpu")
    real_step = tr.step_fn

    def poisoned(state, batch):
        state, metrics = real_step(state, batch)
        if state.step >= 3:  # diverge on the 3rd step
            metrics = dict(metrics, loss_d=torch.tensor(float("nan")))
        return state, metrics

    tr.step_fn = poisoned
    with pytest.raises(NonFiniteLossError, match="loss_d"):
        tr.train(10)
    assert CheckpointManager(cfg.train.ckpt_dir).latest_step() == 3
    assert Trainer(cfg, device="cpu").restore(cfg.train.ckpt_dir) == 3
    # the handlers went back
    assert signal.getsignal(signal.SIGTERM) is not trainer_mod._on_preempt


def test_sigterm_saves_and_returns(tmp_path):
    """A SIGTERM sent from another thread mid-run: the call in flight
    finishes, a checkpoint is saved, ``train()`` returns, the old handler
    is back, and ``resume`` continues from that step."""
    cfg = _cfg(tmp_path, "dcgan_cifar10", **{"train.ckpt_every": 0,
                                              "train.log_every": 0})
    tr = Trainer(cfg, device="cpu")
    prev = signal.getsignal(signal.SIGTERM)

    def send():
        while tr.state.step < 2:
            threading.Event().wait(0.005)
        os.kill(os.getpid(), signal.SIGTERM)

    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    tr.train(100_000)
    sender.join(timeout=60)
    assert not sender.is_alive()
    stopped = tr.state.step
    assert 2 <= stopped < 100_000
    assert signal.getsignal(signal.SIGTERM) is prev
    ckpt = CheckpointManager(cfg.train.ckpt_dir)
    assert ckpt.latest_step() == stopped
    res = Trainer(cfg.override({"train.resume": cfg.train.ckpt_dir}),
                  device="cpu")
    res.train(stopped + 2)
    assert res.state.step == stopped + 2


@pytest.mark.parametrize("preset", [
    "dcgan_mnist", "dcgan_cifar10", "lsgan_cifar10", "wgan_cifar10",
    "wgan_gp_cifar10", "sngan_cifar10", "dcgan_celeba64",
    "dcgan_celeba64_fast", "cdcgan_celeba64", "cdcgan_celeba128"])
def test_every_preset_trains_at_its_default_ckpt_every(tmp_path, preset):
    """The preset's own ckpt_every (1000) and step options, at tiny widths
    on the synthetic dataset: train(n) runs and leaves its final
    checkpoint (the fast preset: FusedProp, 50 steps a call, resident)."""
    cfg = get_preset(preset)
    assert cfg.train.ckpt_every == 1000
    n = cfg.train.steps_per_call if cfg.train.steps_per_call > 1 else 2
    small = {"model.ngf": 4, "model.ndf": 4} if cfg.model.image_size == 128 \
        else {}
    tr = Trainer(_cfg(tmp_path, preset, **small), device="cpu")
    last = tr.train(n)
    assert tr.state.step == n and np.isfinite(last["loss_d"])
    assert CheckpointManager(tr.cfg.train.ckpt_dir).all_steps() == [n]
