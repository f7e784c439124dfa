"""The port's ``Trainer`` against the JAX package's: ``train(3)`` from one
carried state logs the same losses (``metrics.jsonl``, ``log_every=1``) on
the synthetic dataset, with fuse_stats on and off, ``train(2)`` of the
conditional preset on the dataset's labels, and the fast preset (FusedProp,
resident data, steps a call); ``eval_every`` and ``keep_best`` log the JAX
trainer's FID and bank its watermark, which a resumed run keeps; the input
pipeline yields the JAX pipeline's batches; a mesh larger than the ranks
running is refused, a passed mesh is resolved as the JAX Trainer resolves
it, and conditional training on labels that are
all zero is refused; the options ported since train, the dataset files among
them."""

import gzip
import json
import os
import pickle
import struct

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


def test_conditional_trainer_logs_the_jax_trainers_losses(tmp_path):
    """cdcgan_celeba64 on the synthetic dataset's two classes: real labels
    through the pipeline, fake ones from the step's keys, and the sample
    grids on the fixed labels."""
    over = {**TINY, "train.ckpt_dir": str(tmp_path / "ckpt")}
    jcfg = get_preset("cdcgan_celeba64").override(
        {**over, "train.out_dir": str(tmp_path / "jax"),
         "train.sample_every": 0})
    pcfg = port_preset("cdcgan_celeba64").override(
        {**over, "train.out_dir": str(tmp_path / "port"),
         "train.sample_every": 1, "train.kernels": "pallas"})
    jt = JaxTrainer(jcfg)
    pt = Trainer(pcfg, device="cpu")
    load_jax_train_state(pt.state, jax.device_get(jt.state))
    jt.train(2)
    pt.train(2)
    ref, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert [r["step"] for r in got] == [1, 2] == [r["step"] for r in ref]
    for r, g in zip(ref, got):
        for k in ("loss_d", "loss_g", "d_real", "d_fake"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {g['step']} {k}")
    pngs = sorted(p.name for p in (tmp_path / "port").glob("samples_*.png"))
    assert pngs == ["samples_0000001.png", "samples_0000002.png"]


def _best_meta(ckpt_dir):
    with open(os.path.join(ckpt_dir, "best", "best_fid.json")) as f:
        return json.load(f)


def test_eval_and_keep_best_match_the_jax_trainer(tmp_path):
    """``eval_every=1`` and ``keep_best`` over two steps from one carried
    state: the logged FID and KID at each step within 1e-3 relative of the
    JAX trainer's (independent proxy extractors, fp32 generators that agree
    to the step's tolerance), the same steps banked as best, and the
    watermark in ``best/best_fid.json``.  A run resumed into the same
    ckpt_dir keeps an unbeaten watermark and its checkpoint; a fresh run
    clears the stale ``best/`` on its first train()."""
    over = {**TINY, "data.synthetic_size": 24, "train.eval_every": 1,
            "train.keep_best": True, "eval.fid_n": 12, "eval.fid_batch": 6,
            "train.kernels": "xla", "train.sample_every": 0}
    runs = {}
    for pkg, preset in (("jax", get_preset), ("port", port_preset)):
        runs[pkg] = preset("dcgan_cifar10").override({
            **over, "train.out_dir": str(tmp_path / pkg),
            "train.ckpt_dir": str(tmp_path / f"{pkg}_ckpt")})
    jt = JaxTrainer(runs["jax"])
    pt = Trainer(runs["port"], device="cpu")
    load_jax_train_state(pt.state, jax.device_get(jt.state))
    jt.train(2)
    pt.train(2)
    ref = [r for r in _metrics(tmp_path / "jax") if "fid" in r]
    got = [r for r in _metrics(tmp_path / "port") if "fid" in r]
    assert [r["step"] for r in got] == [1, 2] == [r["step"] for r in ref]
    for r, g in zip(ref, got):
        for k in ("fid", "kid"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-3,
                                       err_msg=f"step {g['step']} {k}")
    best = [[r["step"] for r in _metrics(tmp_path / pkg) if "best_fid" in r]
            for pkg in ("jax", "port")]
    assert best[0] == best[1] and best[1]
    jmeta = _best_meta(runs["jax"].train.ckpt_dir)
    pmeta = _best_meta(runs["port"].train.ckpt_dir)
    assert pmeta["step"] == jmeta["step"] == best[1][-1]
    np.testing.assert_allclose(pmeta["fid"], jmeta["fid"], rtol=1e-3)
    assert pt._load_best_meta() == pmeta
    best_dir = os.path.join(runs["port"].train.ckpt_dir, "best")
    assert sorted(os.listdir(best_dir)) == sorted(
        [f"{pmeta['step']}.pt", "best_fid.json", "config.json"])

    # resumed: an unbeatable banked watermark survives the next eval
    with open(os.path.join(best_dir, "best_fid.json"), "w") as f:
        json.dump({"fid": -1.0, "step": pmeta["step"]}, f)
    rt = Trainer(runs["port"].override(
        {"train.resume": runs["port"].train.ckpt_dir}), device="cpu")
    rt.train(3)
    assert rt.state.step == 3
    assert _best_meta(runs["port"].train.ckpt_dir) == {
        "fid": -1.0, "step": pmeta["step"]}
    assert f"{pmeta['step']}.pt" in os.listdir(best_dir)
    assert np.isfinite(rt.evaluate(seed=1)["fid"])
    # fresh: the stale best/ is cleared, and this run's best banked
    Trainer(runs["port"], device="cpu").train(1)
    assert _best_meta(runs["port"].train.ckpt_dir)["step"] == 1


def test_conditional_training_refuses_all_zero_labels(tmp_path):
    cfg = port_preset("cdcgan_celeba64").override(
        {**TINY, "train.out_dir": str(tmp_path)})
    data = make_synthetic(64, 3, 12, seed=0, n_classes=2)
    data["labels"][:] = 0
    with pytest.raises(ValueError, match="all zero"):
        Trainer(cfg, data=data, device="cpu").train(1)


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
    ({"train.mesh_shape": 2}, "only 1 rank"),
    ({"train.spatial_shards": 2}, "spatial_shards=2 but only 1 rank"),
    ({"train.fsdp_shards": 2}, "needs 2 ranks, but only 1"),
])
def test_unported_options_raise(tmp_path, override, match):
    """A mesh larger than the ranks running is refused, as the JAX
    package refuses a mesh larger than its devices (make_mesh,
    make_mesh_2d, the Trainer's spatial_shards check): one process here,
    no process group."""
    cfg = port_preset("dcgan_cifar10").override(
        {**TINY, "train.out_dir": str(tmp_path / "out"),
         "train.ckpt_dir": str(tmp_path / "ckpt"), **override})
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, device="cpu").train(1)


class _Mesh:
    """A stand-in for a ``("data",)`` mesh of ``n`` ranks."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


@pytest.mark.parametrize("override,n,want", [
    ({}, 4, "passed"),
    ({"train.mesh_shape": 2}, 4, "passed"),
    ({"train.spatial_shards": 2}, 4, ("dp_space", 2, 2)),
    ({"train.spatial_shards": 2, "train.mesh_shape": 1}, 4,
     ("dp_space", 1, 2)),
    ({"train.fsdp_shards": 2}, 4, ("2d", 1, 2)),
])
def test_a_passed_mesh_resolves_as_the_jax_trainer_resolves(
        monkeypatch, override, n, want):
    """``Trainer(cfg, mesh=)`` as the JAX Trainer takes it: the passed
    ``("data",)`` mesh steps the batch, spatial sharding makes it a
    (N // S, S) ``("data", "space")`` mesh (``mesh_shape`` first), FSDP's
    2-D mesh supersedes it."""
    import torch

    from tpugan_torch.parallel import fsdp, spatial

    monkeypatch.setattr(spatial, "make_mesh_dp_spatial",
                        lambda d, s, dev: ("dp_space", d, s))
    monkeypatch.setattr(fsdp, "make_mesh_2d", lambda d, m, dev: ("2d", d, m))
    tr = object.__new__(Trainer)
    tr.cfg = port_preset("dcgan_cifar10").override({**TINY, **override})
    tr.device = torch.device("cpu")
    mesh = _Mesh(n)
    step_mesh, spatial_mesh = tr._resolve_mesh(mesh)
    if want == "passed":
        assert step_mesh is mesh and spatial_mesh is None
    elif want[0] == "dp_space":
        assert step_mesh == spatial_mesh == want
    else:
        assert step_mesh == want and spatial_mesh is None


def _write_dataset(name: str, root) -> None:
    """Small files in each reader's format: 13 images (two batches of 6)."""
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    if name == "mnist":
        for fname, arr, magic in (
                ("train-images-idx3-ubyte.gz",
                 rng.integers(0, 256, (13, 28, 28)), 0x803),
                ("train-labels-idx1-ubyte.gz",
                 rng.integers(0, 10, (13,)), 0x801)):
            arr = arr.astype(np.uint8)
            with gzip.open(os.path.join(root, fname), "wb") as f:
                f.write(struct.pack(">I", magic))
                f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
                f.write(arr.tobytes())
    elif name == "cifar10":
        for i in range(1, 6):
            n = 3 if i < 5 else 1
            with open(os.path.join(root, f"data_batch_{i}"), "wb") as f:
                pickle.dump({b"data": rng.integers(0, 256, (n, 3072)).astype(
                    np.uint8), b"labels": [int(v) for v in rng.integers(
                        0, 10, n)]}, f)
    else:  # a CelebA folder at the aligned geometry
        from PIL import Image

        os.makedirs(os.path.join(root, "img_align_celeba"))
        for i in range(13):
            Image.fromarray(rng.integers(0, 256, (218, 178, 3)).astype(
                np.uint8)).save(os.path.join(root, "img_align_celeba",
                                             f"{i:06d}.png"))


EVAL = {"eval.fid_n": 8, "eval.fid_batch": 8}


@pytest.mark.parametrize("override", [
    {"train.ckpt_every": 1},
    {"train.resume": "RESUME"},
    {"train.fused_prop": True},
    {"train.grad_accum": 2},
    {"train.steps_per_call": 2, "train.total_steps": 10},
    {"train.ema": 0.999},
    {"data.device_resident": True},
    {"optim.schedule": "linear"},
    {"train.keep_best": True, "train.eval_every": 1, **EVAL},
    {"train.eval_every": 5, **EVAL},
    {"train.augment": "color"},
    {"train.augment": "translation,cutout"},
    {"train.augment": "color", "train.ada_target": 0.6},
    {"data.dataset": "cifar10"},
    {"data.dataset": "mnist"},
    {"data.dataset": "celeba"},
], ids=["ckpt_every", "resume", "fused_prop", "grad_accum",
        "steps_per_call", "ema", "device_resident", "linear", "keep_best",
        "eval_every", "augment_color", "augment_translation_cutout",
        "ada_target", "cifar10", "mnist", "celeba"])
def test_ported_options_train(tmp_path, override):
    """The options that raised before the port took them: each trains two
    steps and leaves its final checkpoint (a dataset read from files the
    test writes)."""
    ckpt = str(tmp_path / "ckpt")
    name = override.get("data.dataset")
    if name:
        _write_dataset(name, tmp_path / "data")
        override = {**override, "data.data_dir": str(tmp_path / "data")}
    if override.get("train.resume"):
        # a checkpoint to resume from
        Trainer(port_preset("dcgan_cifar10").override(
            {**TINY, "train.out_dir": str(tmp_path / "first"),
             "train.ckpt_dir": ckpt}), device="cpu").train(1)
        override = {"train.resume": ckpt}
    cfg = port_preset("dcgan_cifar10").override(
        {**TINY, "train.out_dir": str(tmp_path / "out"),
         "train.ckpt_dir": ckpt, **override})
    tr = Trainer(cfg, device="cpu")
    tr.train(2)
    assert tr.state.step == 2
    logged = _metrics(tmp_path / "out")
    assert [r["step"] for r in logged if "loss_d" in r] == (
        [2] if cfg.train.steps_per_call == 2 or cfg.train.resume else [1, 2])
    assert os.path.exists(os.path.join(ckpt, "2.pt"))
    if cfg.train.ckpt_every:
        assert os.path.exists(os.path.join(ckpt, "1.pt"))
    if cfg.train.eval_every:
        # every eval_every steps and at the last
        assert [r["step"] for r in logged if "fid" in r] == (
            [1, 2] if cfg.train.eval_every == 1 else [2])
    if cfg.train.keep_best:
        assert tr._load_best_meta()["step"] in (1, 2)
    if cfg.train.ada_target:
        assert all("ada_p" in r for r in logged if "loss_d" in r)


def test_fast_preset_logs_the_jax_trainers_losses(tmp_path):
    """dcgan_celeba64_fast at tiny widths (FusedProp, the dataset resident,
    2 steps a call): the same losses at every call as the JAX trainer's."""
    over = {**TINY, "data.synthetic_size": 16, "train.steps_per_call": 2,
            "train.total_steps": 6}
    jcfg = get_preset("dcgan_celeba64_fast").override(
        {**over, "train.out_dir": str(tmp_path / "jax"),
         "train.ckpt_dir": str(tmp_path / "jax_ckpt"),
         "train.sample_every": 0})
    pcfg = port_preset("dcgan_celeba64_fast").override(
        {**over, "train.out_dir": str(tmp_path / "port"),
         "train.ckpt_dir": str(tmp_path / "port_ckpt"),
         "train.sample_every": 4, "train.kernels": "pallas"})
    assert pcfg.train.fused_prop and pcfg.data.device_resident
    try:
        jt = JaxTrainer(jcfg)
        pt = Trainer(pcfg, device="cpu")
        load_jax_train_state(pt.state, jax.device_get(jt.state))
        jt.train()
        pt.train()
    finally:
        jax_ops.set_fuse_stats("off")
    ref, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert [r["step"] for r in got] == [2, 4, 6] == [r["step"] for r in ref]
    for r, g in zip(ref, got):
        for k in ("loss_d", "loss_g", "d_real", "d_fake", "gp"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"step {g['step']} {k}")
    pngs = sorted(p.name for p in (tmp_path / "port").glob("samples_*.png"))
    assert pngs == ["samples_0000004.png", "samples_0000006.png"]
    assert pt.state.step == 6


def test_label_smoothing_is_refused_where_it_means_nothing():
    cfg = port_preset("wgan_cifar10").override(
        {**TINY, "loss.real_label": 0.9})
    with pytest.raises(ValueError, match="label smoothing"):
        Trainer(cfg, device="cpu")


def test_real_dataset_readers_raise(tmp_path):
    """A reader whose files are absent raises FileNotFoundError; an
    unknown dataset name raises ValueError."""
    for name in ("cifar10", "mnist", "celeba"):
        with pytest.raises(FileNotFoundError):
            load_dataset(name, str(tmp_path), image_size=32, channels=3)
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("imagenet", str(tmp_path), image_size=32, channels=3)
