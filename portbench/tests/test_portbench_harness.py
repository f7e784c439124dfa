"""The harness is driven by data: a cell added as files alone runs, on a
copy of the checkout's benchmark, without an edit; the entry point refuses
to run without a card; the traced slice reduces to the device's busy
share and the host's spans."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import trace
from portbench.tests.conftest import HERE, REPO, small_files


@pytest.mark.parametrize("cell", ["small.small_fp32",
                                  "small.small_cond_fp32"])
def test_new_workload_runs_without_an_edit(tmp_path, cell):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    (tmp_path / "portbench" / "tests").mkdir()
    cells = small_files(tmp_path / "portbench")
    assert all(p.read_bytes() == b for p, b in before.items())
    code = ("import sys, json, torch; torch.set_num_threads(2); "
            "from portbench import harness; "
            "print(json.dumps(harness.run_cell(sys.argv[1], 3, 0.3, "
            "bool(int(sys.argv[2])), 'cpu')))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    for traced in ("0", "1"):
        r = subprocess.run([sys.executable, "-c", code, cell, traced],
                           cwd=tmp_path, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        assert out["correct"] and cell in cells
        if traced == "1":
            assert "dispatch_ms" in out["metrics"]
            assert "step_mfu_pct" in out["metrics"]
            if cell == "small.small_fp32":  # the host pipeline's cell
                assert "input_wait_ms" in out["metrics"]
        else:
            assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}


def test_no_card_no_result():
    cell = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"][0]
    r = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        cell["name"], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_trace_reduction():
    host = [(trace.SLICE, 0.0, 10.0, 1), ("portbench.dispatch", 0.0, 6.0, 1),
            ("aten::conv2d", 1.0, 2.0, 1), ("aten::add", 1.2, 1.5, 1),
            ("portbench.fetch", 6.0, 10.0, 1), ("aten::mul", 1.0, 9.0, 2)]
    device = [("kern_a", 1.5, 3.0), ("kern_b", 2.5, 4.0),
              ("Memcpy HtoD", 7.0, 8.0)]
    t = trace.Trace(0.0, 10.0, device, host)
    assert t.busy_s() == 3.5 and t.window_s == 10.0
    assert t.idle_gaps() == [(0.0, 1.5), (4.0, 7.0), (8.0, 10.0)]
    assert len(t.kernels()) == 2
    label = t.host_labels()
    assert label(1.3) == "dispatch: aten::conv2d"
    assert label(5.0) == "dispatch" and label(9.0) == "fetch"
    b = t.breakdown()
    assert b["device_ops"][0] == ["kern_a", 1.5]
    assert dict(b["idle_gaps"]) == {"dispatch": 1.5 + 3.0, "fetch": 2.0}
