"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to a configuration, a cell or a per-layer metric
is a file found by its name: ``configs/<name>.json`` (the configuration
as it is run, with its source, overrides and assumptions),
``workloads/<name>.json`` (its configuration, its traffic, its limits and
why it exists) and ``metrics/<name>.py`` (a reader that returns the
metric from the run, or None where it finds nothing to read).

Set-up builds the program's ``Trainer`` (``tpugan_torch``) on the cell's
configuration with the dataset (its labels too, where the model takes
them) and the weights the benchmark makes from the seed (by the
reference of the configuration's ``model.arch``, ``reference/<arch>.py``),
and drives its ``step_fn`` through its first calls, with the window's own
feed (the ``Trainer``'s: the resident dataset, or the host
pipeline); hooks read its first three steps for the check
(``check.FirstSteps``).  The window then runs whole calls of the same
``step_fn`` on the same state until the seconds are up, fetching the
step's metrics to the host every ``train.log_every`` steps as
``Trainer.train`` does, and synchronises.  With ``trace`` a fixed slice
in its middle runs under ``torch.profiler``; the rates of a traced run
come from the steps outside that slice.  After the window the program is
freed and the plain reference follows the same first three steps.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

from portbench import check, dataset
from portbench.reference import train as ref_train

HERE = Path(__file__).resolve().parent
SPAN = "portbench."


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        have = sorted(p.stem for p in (HERE / kind).glob("*.json"))
        raise SystemExit(f"no {kind[:-1]} {name!r}; have {have}")
    return json.loads(path.read_text())


def metric_names() -> list[str]:
    return sorted(p.stem for p in (HERE / "metrics").glob("*.py")
                  if not p.stem.startswith("_"))


def config_as_run(conf: dict, work: dict, seed: int) -> dict:
    """The configuration's file with the cell's batch and the run's seed."""
    cfg = json.loads(json.dumps(conf["config"]))
    cfg["data"]["batch_size"] = int(work["traffic"]["batch_size"])
    cfg["train"]["seed"] = int(seed)
    return cfg


def feed_of(cfg: dict) -> str:
    return "resident" if cfg["data"]["device_resident"] else "pipeline"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Run:
    """What a run measured, as the per-layer readers take it."""

    cfg: dict
    precision: str
    batch: int
    feed: str
    steps: int = 0  # the window's unprofiled steps
    seconds: float = 0.0  # and their seconds
    spans: dict = field(default_factory=dict)  # span -> seconds, unprofiled
    peak_bytes: Optional[int] = None  # the window's, by the allocator
    trace: object = None  # trace.Trace of the profiled slice
    slice_steps: int = 0
    slice_launches: dict = field(default_factory=dict)  # program counters

    @property
    def fused(self) -> bool:
        return bool(self.cfg["train"]["fused_prop"])


class Cell:
    """The program set up for one cell from one seed."""

    def __init__(self, name: str, seed: int, device="cuda",
                 program: bool = True):
        t = time.perf_counter()
        self.name, self.seed = name, int(seed)
        self.device = torch.device(device)
        self.work = load("workloads", name)
        self.conf = load("configs", self.work["config"])
        self.cfg = config_as_run(self.conf, self.work, seed)
        self.split: dict = {}
        # the fp32 configuration states fp32: PyTorch's fp32 convs and
        # matmuls without TF32 (the program leaves these flags as they
        # are, and cuDNN's convs take TF32 by default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from tpugan_torch.configs import Config
        from tpugan_torch.train.trainer import Trainer

        self.split["imports"] = time.perf_counter() - t
        t = time.perf_counter()
        m = self.cfg["model"]
        n = int(self.work["traffic"]["dataset_images"])
        self.images = dataset.make_images(n, m["image_size"], m["channels"],
                                          seed, self.device)
        self.data = {"images": self.images}
        self.labels = None
        if m["n_classes"] > 0:
            self.labels = dataset.make_labels(n, m["n_classes"], seed)
            self.data["labels"] = self.labels
        sync(self.device)
        if self.device.type == "cuda":
            # the set is made on the card in scratch buffers that no
            # deployment holds: the peak reported covers the program's
            # set-up, warm-up and window only
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.split["dataset"] = time.perf_counter() - t
        t = time.perf_counter()
        self.weights = ref_train.of(m).make_weights(m, seed, self.device)
        if not program:  # the reference's inputs alone
            return
        self.trainer = Trainer(Config.from_dict(self.cfg), data=self.data,
                               device=self.device)
        load_weights(self.trainer, self.weights)
        sync(self.device)
        self.split["model_and_state"] = time.perf_counter() - t
        t = time.perf_counter()
        if self.cfg["train"]["fuse_stats"] == "on" and \
                self.device.type == "cuda":
            from tpugan_torch.ops import _build

            _build.load("cuda_conv_stats")
        self.split["kernels"] = time.perf_counter() - t
        t = time.perf_counter()
        self.batches = iter(self.trainer._batches(self.data))
        self.split["feed"] = time.perf_counter() - t
        self.k = max(int(self.cfg["train"]["steps_per_call"]), 1)
        self.state = self.trainer.state
        self.step_fn = self.trainer.step_fn

    def first_steps(self) -> dict:
        """Drive the first calls (at least ``check.STEPS`` steps and the
        cell's warm-up) through the window's own call and feed, reading
        the first steps by hooks; returns them."""
        t = time.perf_counter()
        o = self.cfg["optim"]
        cap = check.FirstSteps(self.state, self.weights,
                               self.cfg["train"]["fused_prop"], o["beta1"])
        warm = max(int(self.work["traffic"]["warmup_steps"]), check.STEPS)
        done = 0
        try:
            while done < warm:
                self.state, metrics = self.step_fn(self.state,
                                                   next(self.batches))
                done += self.k
            host = {k: float(v) for k, v in metrics.items()}
        finally:
            cap.remove()
        self.steps_done = done
        self.split["warmup"] = time.perf_counter() - t
        log(f"warm-up: {done} steps, last metrics {host}")
        return cap.result()

    def free(self) -> None:
        """Stop the feed and drop the program's state."""
        close = getattr(self.batches, "close", None)
        if close is not None:
            close()
        del self.batches, self.trainer, self.state, self.step_fn
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32", rows_kept: float = 1.0,
                  label_fault: str = "") -> dict:
        return ref_train.follow(self.cfg, self.weights, self.images,
                                self.seed, feed=feed_of(self.cfg),
                                labels=self.labels, steps=check.STEPS,
                                precision=precision, rows_kept=rows_kept,
                                label_fault=label_fault, device=self.device)


def load_weights(trainer, weights: dict) -> None:
    """The benchmark's weights into the program's G and D, by name."""
    with torch.no_grad():
        for part, module in (("g", trainer.g), ("d", trainer.d)):
            params = dict(module.named_parameters())
            if sorted(params) != sorted(weights[part]):
                raise RuntimeError(
                    f"{part}: the program's parameters {sorted(params)} are "
                    f"not the reference's {sorted(weights[part])}")
            for k, p in params.items():
                if tuple(p.shape) != tuple(weights[part][k].shape):
                    raise RuntimeError(f"{part}.{k}: {tuple(p.shape)} here, "
                                       f"{tuple(weights[part][k].shape)} in "
                                       f"the reference")
                p.copy_(weights[part][k])


def _span(name: str, on: bool):
    return (torch.profiler.record_function(SPAN + name) if on
            else contextlib.nullcontext())


def window(cell: Cell, seconds: float, trace: bool) -> tuple[Run, dict]:
    """Whole calls of the cell's ``step_fn`` until ``seconds`` have passed
    (with ``trace``, the profiled slice in the middle); returns the run's
    measurements and what the result line needs of the window."""
    from tpugan_torch.ops import cuda_conv_stats

    from portbench import trace as tracing

    cfg, dev = cell.cfg, cell.device
    k, bsz = cell.k, cell.cfg["data"]["batch_size"]
    log_every = max(int(cfg["train"]["log_every"]), 1)
    prof_steps = int(cell.work["traffic"]["profile_steps"])
    run = Run(cfg, cfg["train"]["precision"], bsz, feed_of(cfg),
              spans={"input": 0.0, "dispatch": 0.0})
    cuda = dev.type == "cuda"
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    step = cell.steps_done
    attempted = failed = since_fetch = 0
    fetch_times: list = []  # seconds between fetches, outside the slice
    clock = time.perf_counter
    t0 = last_fetch = clock()
    paused = 0.0  # the profiler's own stop, kept out of the window
    profiled_s = 0.0
    traced = not trace
    prof = None

    def call(in_slice: bool) -> None:
        nonlocal step, attempted, failed, since_fetch, last_fetch
        ta = clock()
        with _span("input", in_slice):
            batch = next(cell.batches)
        tb = clock()
        with _span("dispatch", in_slice):
            cell.state, metrics = cell.step_fn(cell.state, batch)
        tc = clock()
        step += k
        attempted += k
        since_fetch += k
        if step % log_every < k:
            with _span("fetch", in_slice):
                host = [float(v) for v in metrics.values()]
            if not all(math.isfinite(v) for v in host):
                failed += since_fetch
            since_fetch = 0
            if not in_slice:
                fetch_times.append(clock() - last_fetch)
            last_fetch = clock()
        if not in_slice:
            run.spans["input"] += tb - ta
            run.spans["dispatch"] += tc - tb
            run.steps += k

    while True:
        call(False)
        at_fetch = step % log_every < k
        elapsed = clock() - t0 - paused
        if not traced and at_fetch and elapsed >= seconds / 2:
            traced = True
            before = cuda_conv_stats.launches
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            ts = clock()
            prof.start()
            with torch.profiler.record_function(tracing.SLICE):
                done = 0
                while done < prof_steps:
                    call(True)
                    done += k
                sync(dev)
            run.slice_steps = done
            profiled_s = clock() - ts
            run.slice_launches["conv_stats"] = (cuda_conv_stats.launches
                                                - before)
            tp = clock()
            prof.stop()
            paused += clock() - tp
            last_fetch = clock()
        if traced and clock() - t0 - paused >= seconds:
            break
    sync(dev)
    total = clock() - t0 - paused
    run.seconds = total - profiled_s
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
    if prof is not None:
        tp = clock()
        run.trace = tracing.from_profiler(prof)
        log(f"trace read in {clock() - tp:.1f}s: "
            f"{len(run.trace.device)} device operations")
    facts = dict(attempted=attempted, failed=failed, seconds=total,
                 images_per_s=bsz * attempted / total,
                 memory_peak_bytes=(max(setup_peak, run.peak_bytes)
                                    if cuda else None),
                 fetch_times=fetch_times)
    return run, facts


def per_layer(run: Run) -> dict:
    """Every metric whose reader finds something to read in this run."""
    out = {}
    for name in metric_names():
        mod = importlib.import_module(f"portbench.metrics.{name}")
        value = mod.read(run)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def card_facts(device) -> dict:
    """The card's name, power limit, clocks and temperature."""
    if torch.device(device).type != "cuda":
        return {}
    out = {"name": torch.cuda.get_device_name(device)}
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,power.draw,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader", "-i", str(torch.device(device).index
                                               or 0)],
            capture_output=True, text=True, timeout=20)
        out["nvidia_smi"] = r.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out


def median_p95(values: list) -> dict:
    if len(values) < 2:
        return {"n": len(values)}
    q = statistics.quantiles(values, n=20)
    return {"n": len(values), "median": statistics.median(values),
            "p95": q[-1], "min": min(values), "max": max(values)}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None) -> dict:
    """One run; returns the result line's object (``run.py`` prints it)."""
    t_start = time.time() if t_start is None else t_start
    started = time.time() - t_start  # interpreter, torch's import
    cell = Cell(name, seed, device)
    prog = cell.first_steps()
    sync(cell.device)
    setup_s = time.time() - t_start
    split = {k: round(v, 3) for k, v in cell.split.items()}
    log(f"set-up {setup_s:.3f}s: process start to the harness "
        f"{started:.3f}, then {split}")
    log(f"card at the window's start: {card_facts(cell.device)}")
    run, facts = window(cell, seconds, trace)
    log(f"card at the window's end: {card_facts(cell.device)}")
    log(f"window: {facts['attempted']} steps in {facts['seconds']:.3f}s; "
        f"{cell.cfg['train']['log_every']}-step intervals (s): "
        f"{median_p95(facts['fetch_times'])}")
    metrics = per_layer(run) if trace else {
        "train_images_per_s": {"value": facts["images_per_s"],
                               "unit": "images/s"},
        "setup_s": {"value": setup_s, "unit": "s"}}
    cell.free()
    t = time.time()
    ref = cell.reference()
    values = check.readings(prog, ref, cell.cfg["train"]["fused_prop"])
    correct, compared = check.judge(values, cell.work.get("limits", {}))
    correct = correct and facts["failed"] == 0
    log(f"reference in {time.time() - t:.1f}s; losses program "
        f"{prog['loss']} reference {ref['loss']}; not compared: "
        f"{ {k: v for k, v in values.items() if k not in compared} }")
    dev = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(cell.device)
                    if cell.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": facts["memory_peak_bytes"]}
    out = {"correct": bool(correct), "attempted": facts["attempted"],
           "failed": facts["failed"], "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["check"] = compared
    return out

