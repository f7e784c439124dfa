"""Every configuration, cell and metric of the benchmark is a file the
harness finds by its name, and ``BENCHMARK.json`` names them as they are."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench import harness
from portbench.tests.conftest import HERE, REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        (HERE / "configs").glob("*.json")))
def test_config_is_found_and_is_its_preset(name):
    from tpugan_torch.configs import Config, get_preset

    conf = harness.load("configs", name)
    assert conf["name"] == name
    assert len(conf["source"]) <= 200 and conf["reduced"] == []
    built = get_preset(conf["preset"]).override(conf["overrides"])
    assert built.to_dict() == conf["config"]
    Config.from_dict(conf["config"])


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        (HERE / "workloads").glob("*.json")))
def test_workload_is_found_and_names_a_config(name):
    work = harness.load("workloads", name)
    assert work["name"] == name and NAME.match(name)
    assert harness.load("configs", work["config"])
    t = work["traffic"]
    assert t["batch_size"] > 0 and t["dataset_images"] >= t["batch_size"]
    assert t["profile_steps"] > 0 and t["warmup_steps"] > 0
    assert 0 < len(work["why"]) <= 200 and "\n" not in work["why"]
    assert work["limits"] and all(k in harness.check.NAMES
                                  for k in work["limits"])


@pytest.mark.parametrize("name", harness.metric_names())
def test_metric_reader_is_found(name):
    mod = importlib.import_module(f"portbench.metrics.{name}")
    assert UNIT.match(mod.UNIT) and mod.SOURCE in SOURCES
    assert mod.MOVES in {m["name"] for m in BENCH["end_to_end"]}
    assert callable(mod.read)


def test_benchmark_json_names_the_files():
    assert BENCH["paths"] == ["portbench"]
    assert {c["name"] for c in BENCH["configs"]} == {
        p.stem for p in (HERE / "configs").glob("*.json")}
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file() and c["reduced"] == []
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert set(cells) == {p.stem for p in (HERE / "workloads").glob("*.json")}
    for name, w in cells.items():
        work = harness.load("workloads", name)
        assert (w["config"], w["traffic"], w["why"], w["chips"]) == (
            work["config"], work["traffic"]["name"], work["why"],
            work["chips"])
    assert {m["name"] for m in BENCH["per_layer"]} == set(
        harness.metric_names())
    for m in BENCH["per_layer"]:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == (
            mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE)
        assert set(m.get("workloads", cells)) <= set(cells)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert 1 <= BENCH["run_seconds"] <= 51
