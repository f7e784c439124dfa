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


def small_files(root: Path) -> dict:
    """Add small configurations and cells to the benchmark folder at
    ``root``: each full configuration at widths 8 (and steps_per_call 2),
    an fp32 FusedProp one, and a cell on each with the limits of the fp32
    cell; returns {cell: configuration}."""
    cells = {}
    fp32_limits = next(
        w["limits"] for w in (json.loads(p.read_text()) for p in
                              sorted((HERE / "workloads").glob("*.json")))
        if w["config"] == "dcgan_celeba64_fp32")
    for src, name, prec, fused in (
            ("dcgan_celeba64_fast", "small_fast", None, None),
            ("dcgan_celeba64_fp32", "small_fp32", None, None),
            ("dcgan_celeba64_fast", "small_fused_fp32", "fp32", True)):
        conf = json.loads((HERE / "configs" / f"{src}.json").read_text())
        conf["name"] = name
        c = conf["config"]
        c["model"].update(SMALL)
        if c["train"]["steps_per_call"] > 1:
            c["train"]["steps_per_call"] = 2
        if prec:
            c["train"]["precision"] = prec
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
