"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files with small configurations and cells added, which the harness reads
in place of its own folder."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
REPO = HERE.parent
SMALL = {"ngf": 8, "ndf": 8, "nz": 16}
# the conditional preset as a cell would run it (the benchmark has no
# such configuration yet): CelebA-128's size, resident, the port's kernels
COND = "cdcgan_celeba128"
COND_OVERRIDES = {"data.dataset": "synthetic", "data.synthetic_size": 202599,
                  "data.device_resident": True, "train.kernels": "pallas",
                  "train.fuse_stats": "on", "train.total_steps": 1000000,
                  "train.sample_every": 0, "train.ckpt_every": 0,
                  "train.eval_every": 0}
# (source configuration, small configuration, what it changes besides the
# widths): the fp32 ones run under the fp32 cell's limits
SMALL_CONFIGS = (
    ("dcgan_celeba64_fast", "small_fast", {}),
    ("dcgan_celeba64_fp32", "small_fp32", {}),
    ("dcgan_celeba64_fast", "small_fused_fp32", {"train.precision": "fp32"}),
    (COND, "small_cond", {}),
    (COND, "small_cond_fp32", {"train.precision": "fp32"}),
    (COND, "small_cond_fused_fp32", {"train.precision": "fp32",
                                     "train.fused_prop": True,
                                     "data.device_resident": False}),
)


def source_conf(name: str) -> dict:
    """A configuration file of the benchmark, or the conditional preset's
    in that file's form."""
    if name != COND:
        return json.loads((HERE / "configs" / f"{name}.json").read_text())
    from tpugan_torch.configs import get_preset

    return {"name": COND, "source": "https://arxiv.org/abs/1411.1784",
            "preset": COND, "overrides": COND_OVERRIDES,
            "config": get_preset(COND).override(COND_OVERRIDES).to_dict(),
            "reduced": []}


def small_files(root: Path) -> dict:
    """Add small configurations and cells to the benchmark folder at
    ``root``: each configuration of ``SMALL_CONFIGS`` at widths 8 (and
    steps_per_call 2 where it has more), and a cell on each with the
    limits of the fp32 cell; returns {cell: configuration}."""
    cells = {}
    fp32_limits = next(
        w["limits"] for w in (json.loads(p.read_text()) for p in
                              sorted((HERE / "workloads").glob("*.json")))
        if w["config"] == "dcgan_celeba64_fp32")
    for src, name, changes in SMALL_CONFIGS:
        conf = source_conf(src)
        conf["name"] = name
        c = conf["config"]
        c["model"].update(SMALL)
        if c["train"]["steps_per_call"] > 1:
            c["train"]["steps_per_call"] = 2
        for key, value in changes.items():
            group, field = key.split(".")
            c[group][field] = value
        (root / "configs" / f"{name}.json").write_text(json.dumps(conf))
        cell = f"small.{name}"
        work = {"name": cell, "config": name, "chips": 1, "why": "a test",
                "traffic": {"name": "small", "batch_size": 8,
                            "dataset_images": 64, "warmup_steps": 2,
                            "profile_steps": 2},
                "limits": fp32_limits}
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(work))
        cells[cell] = name
    return cells


@pytest.fixture
def small_bench(tmp_path, monkeypatch):
    """The harness reading a copy of its folder with the small cells."""
    from portbench import harness

    root = tmp_path / "portbench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(HERE / sub, root / sub)
    cells = small_files(root)
    monkeypatch.setattr(harness, "HERE", root)
    return cells
