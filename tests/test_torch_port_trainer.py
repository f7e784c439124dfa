"""The port's ``Trainer`` against the JAX package's: ``train(3)`` from one
carried state logs the same losses (``metrics.jsonl``, ``log_every=1``) on
the synthetic dataset, with fuse_stats on and off; the input pipeline
yields the JAX pipeline's batches; options the port does not take raise."""

import json
import os

import jax
import numpy as np
import pytest

from tpugan import ops as jax_ops
from tpugan.configs import get_preset
from tpugan.data.datasets import make_synthetic as jax_synthetic
from tpugan.data.pipeline import make_input_pipeline as jax_pipeline
from tpugan.train import Trainer as JaxTrainer
from tpugan_torch.ckpt.from_jax import load_jax_train_state
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.data.datasets import load_dataset, make_synthetic
from tpugan_torch.data.pipeline import make_input_pipeline
from tpugan_torch.train.trainer import Trainer

TINY = {"data.dataset": "synthetic", "data.synthetic_size": 20,
        "data.batch_size": 6, "model.ngf": 8, "model.ndf": 8, "model.nz": 12,
        "train.precision": "fp32", "train.log_every": 1,
        "train.ckpt_every": 0}


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("mode", ["on", "off"])
def test_trainer_logs_the_jax_trainers_losses(tmp_path, mode):
    over = {**TINY, "train.fuse_stats": mode,
            "train.ckpt_dir": str(tmp_path / "ckpt")}
    jcfg = get_preset("dcgan_celeba64").override(
        {**over, "train.out_dir": str(tmp_path / "jax"),
         "train.sample_every": 0})
    # the port's run also writes sample grids (megakernel v2's plain
    # version on the CPU): the grid after step 2 puts G in eval mode, and
    # step 3's losses show that the step put it back in train mode
    pcfg = port_preset("dcgan_celeba64").override(
        {**over, "train.out_dir": str(tmp_path / "port"),
         "train.sample_every": 2, "train.kernels": "pallas"})
    try:
        jt = JaxTrainer(jcfg)
        pt = Trainer(pcfg, device="cpu")
        # carried before the JAX run: its step donates the state's buffers
        load_jax_train_state(pt.state, jax.device_get(jt.state))
        jt.train(3)
        last = pt.train(3)
    finally:
        jax_ops.set_fuse_stats("off")
    ref, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert [r["step"] for r in got] == [1, 2, 3] == [r["step"] for r in ref]
    for r, g in zip(ref, got):
        for k in ("loss_d", "loss_g", "d_real", "d_fake", "gp"):
            # fp32; the tolerance of tests/test_torch_port_train_step.py
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {g['step']} {k}")
        assert g["images_per_sec"] > 0
    assert last["loss_d"] == got[-1]["loss_d"]
    assert pt.state.step == 3
    pngs = sorted(p.name for p in (tmp_path / "port").glob("samples_*.png"))
    assert pngs == ["samples_0000002.png", "samples_0000003.png"]
    # a second call continues the run (and the data stream) to step 4
    pt.train(4)
    assert pt.state.step == 4


def test_pipeline_yields_the_jax_pipelines_batches():
    data = make_synthetic(8, 3, 10, seed=2)
    np.testing.assert_array_equal(data["images"],
                                  jax_synthetic(8, 3, 10, seed=2)["images"])
    for start in (0, 4):
        got = iter(make_input_pipeline(data, 3, seed=9, with_labels=True,
                                       device="cpu", start_step=start))
        ref = iter(jax_pipeline(data, 3, seed=9, with_labels=True,
                                start_step=start))
        # 3 batches per epoch: 7 batches cross two epoch boundaries
        for _ in range(7):
            g, r = next(got), next(ref)
            np.testing.assert_array_equal(g["image"].numpy(),
                                          np.asarray(r["image"]))
            np.testing.assert_array_equal(g["label"].numpy(),
                                          np.asarray(r["label"]))
        got.close()


@pytest.mark.parametrize("override,match", [
    ({"train.ckpt_every": 10}, "ckpt_every"),
    ({"train.resume": "runs/ckpt"}, "resume"),
    ({"train.eval_every": 5}, "eval_every"),
    ({"train.mesh_shape": 2}, "mesh_shape"),
    ({"train.fused_prop": True}, "fused_prop"),
    ({"train.grad_accum": 2}, "grad_accum"),
    ({"train.steps_per_call": 2}, "steps_per_call"),
    ({"train.augment": "color"}, "augment"),
    ({"train.ema": 0.999}, "ema"),
    ({"data.device_resident": True}, "device_resident"),
    ({"loss.kind": "wgan_gp"}, "wgan_gp"),
    ({"optim.schedule": "linear"}, "linear"),
])
def test_unported_options_raise(override, match):
    cfg = port_preset("dcgan_cifar10").override({**TINY, **override})
    with pytest.raises(NotImplementedError, match=match):
        Trainer(cfg, device="cpu")


def test_label_smoothing_is_refused_where_it_means_nothing():
    cfg = port_preset("wgan_cifar10").override(
        {**TINY, "loss.real_label": 0.9})
    with pytest.raises(ValueError, match="label smoothing"):
        Trainer(cfg, device="cpu")


def test_real_dataset_readers_raise():
    with pytest.raises(NotImplementedError, match="Data"):
        load_dataset("cifar10", image_size=32, channels=3)
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("imagenet", image_size=32, channels=3)
