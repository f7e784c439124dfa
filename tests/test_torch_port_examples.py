"""The port's examples (``examples_torch/``) beside the JAX package's
(``examples/``).

Runs: each port script runs on ``--device cpu`` with the tiny overrides of
``scripts/ci.sh``'s examples tier and is held to what ci.sh asserts:
``train_dcgan_mnist`` writes ``final_grid.png``, the two
``train_multihost`` processes print the same ``loss_d``, and
``serve_and_query`` prints ``served == local for seed 7: True`` (its own
``allclose`` at rtol 1e-4, atol 1e-8).  Each script runs as ``__main__``
with its argv (``runpy``).  ``train_dcgan_mnist``, ``serve_and_query`` and
the mesh scripts run in this process, the mesh scripts on two gloo ranks
(``--world 2``: ci.sh's 8 fake JAX devices would be 8 processes here).
``train_multihost``'s two processes and ``train_wgan_gp_cifar10`` (whose
last step scores an FID of 10,000 samples, most of this file's work)
start first, from the ranks' preloaded forkserver
(``multihost.rank_context``), and run while the other tests do; the
multi-host processes meet through the script's own ``--coordinator`` on
a free port.

Configs: what a script decides is its configuration.  For the same argv
and the same device or rank count, each port script hands its ``Trainer``
(``serve_and_query``: its exporter, and its engine's batch) the same
``Config`` as its JAX twin, compared field by field, with ``Trainer``,
``make_mesh`` and ``spawn`` (and the exporter and engine) replaced by
stubs in both packages, so that neither trains and no JAX program
compiles.  The trainers' numbers are held to JAX's by
``test_torch_port_trainer.py``; two seeded whole runs of the two packages
cannot match and are not compared.
"""

import ast
import contextlib
import dataclasses
import io
import math
import queue
import re
import runpy
import socket
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch

from tpugan_torch.parallel import multihost

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "examples_torch"
JAX = ROOT / "examples"
THREADS = 1
METRICS = {"loss_d": 1.0, "d_real": 0.0, "d_fake": 0.0, "gp": 0.0,
           "loss_g": 1.0, "images_per_sec": 1.0}


def run_in_process(path: Path, argv, cwd) -> str:
    """Run a script as ``__main__`` with ``argv`` from ``cwd`` on
    ``THREADS`` threads (the suite runs other files beside it); returns
    what it printed."""
    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(buf):
            mp.chdir(cwd)
            mp.setattr(sys, "argv", [str(path), *map(str, argv)])
            mp.setattr(sys, "path", list(sys.path))
            runpy.run_path(str(path), run_name="__main__")
    finally:
        torch.set_num_threads(threads)
    return buf.getvalue()


def final_metrics(out: str) -> dict:
    """The metrics dict a script prints last, every value finite."""
    metrics = ast.literal_eval(out.strip().splitlines()[-1].split(
        "final: ")[-1])
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    return metrics


# ---------------------------------------------------------------------------
# The scripts run, as ci.sh runs them
# ---------------------------------------------------------------------------

class Background:
    """``train_wgan_gp_cifar10`` and ``train_multihost``'s two processes,
    started from the ranks' forkserver before this file's other tests and
    run while those do; each is collected by its own test, at the end."""

    def __init__(self, tmp):
        from _torch_port_workers import run_example

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.tmp = tmp
        ctx = multihost.rank_context()
        argvs = {
            "wgan": [["--steps", "6", "--out", str(tmp / "wgan")]],
            "mh": [["--num-processes", "2", "--process-id", str(i),
                    "--coordinator", f"127.0.0.1:{port}", "--steps", "4",
                    "--out", str(tmp / "mh")] for i in range(2)]}
        scripts = {"wgan": "train_wgan_gp_cifar10", "mh": "train_multihost"}
        self.jobs = {}
        for name, argv_list in argvs.items():
            q = ctx.Queue()
            procs = [ctx.Process(target=run_example, args=(
                str(PORT / f"{scripts[name]}.py"), ["--device", "cpu", *argv],
                str(tmp), q, THREADS))
                for argv in argv_list]
            for proc in procs:
                proc.start()
            self.jobs[name] = (procs, q)

    def collect(self, name) -> str:
        """What the job's processes printed, once each has exited 0."""
        procs, q = self.jobs[name]
        outs, t_end = [], time.time() + 300
        while len(outs) < len(procs):
            try:
                outs.append(q.get(timeout=1.0))
            except queue.Empty:
                codes = [proc.exitcode for proc in procs]
                assert time.time() < t_end and not any(codes), codes
        for proc in procs:
            proc.join(timeout=60)
        assert all(ok for ok, _ in outs), [o for ok, o in outs if not ok]
        assert all(proc.exitcode == 0 for proc in procs)
        return "".join(o for _, o in outs)

    def close(self):
        for procs, _ in self.jobs.values():
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=10)


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    jobs = Background(tmp_path_factory.mktemp("background"))
    try:
        yield jobs
    finally:
        jobs.close()


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """``train_dcgan_mnist --steps 4``: its output directory and what it
    printed."""
    tmp = tmp_path_factory.mktemp("examples")
    out = run_in_process(PORT / "train_dcgan_mnist.py",
                         ["--device", "cpu", "--steps", 4,
                          "--out", tmp / "mnist"], tmp)
    return tmp / "mnist", out


def test_train_dcgan_mnist_writes_its_grid(mnist):
    out_dir, out = mnist
    assert (out_dir / "final_grid.png").read_bytes()[:4] == b"\x89PNG"
    assert (out_dir / "ckpt" / "4.pt").is_file()
    assert "MNIST idx files not found -> deterministic synthetic dataset" \
        in out
    final_metrics(out)


def test_serve_and_query_serves_the_local_pixels(mnist, tmp_path):
    out = run_in_process(PORT / "serve_and_query.py",
                         ["--device", "cpu", "--ckpt", mnist[0] / "ckpt"],
                         tmp_path)
    assert "exported step-4 generator (28px, nz=100)" in out
    assert re.search(r"serving on 127\.0\.0\.1:\d+", out)
    assert "served == local for seed 7: True" in out


@pytest.mark.parametrize("script, argv", [
    ("data_parallel_training", ["--steps", 4]),
    ("train_256px_spatial", ["--steps", 2, "--width", 8, "--batch", 8]),
], ids=["data_parallel", "spatial"])
def test_mesh_examples_train_on_two_ranks(script, argv, tmp_path):
    out = run_in_process(PORT / f"{script}.py",
                         ["--device", "cpu", "--world", 2, *argv], tmp_path)
    assert out.splitlines()[0] == "2 device(s): ['cpu', 'cpu']"
    final_metrics(out)


# ---------------------------------------------------------------------------
# Each script's configuration against its JAX twin's
# ---------------------------------------------------------------------------

class _Stop(Exception):
    """Raised by the engine stub: the script has decided all it decides."""


def _recorders(seen):
    class Trainer:
        def __init__(self, cfg, data=None, mesh=None, device=None):
            seen["cfg"], seen["mesh"] = cfg, mesh

        def train(self):
            return dict(METRICS)

        def sampler(self):
            return SimpleNamespace(save_grid=lambda path, n, seed: seen.update(
                grid=(Path(path).name, n, seed)))

    def make_mesh(n=None, *a, **k):
        return ("mesh", n)

    def export_generator(cfg, *a, **k):
        seen["cfg"] = cfg
        return b""

    def load_generator(*a, **k):
        return SimpleNamespace(image_size=0, nz=0)

    def engine(gen, max_batch):
        seen["max_batch"] = max_batch
        raise _Stop

    return Trainer, make_mesh, export_generator, load_generator, engine


def port_decides(argv, script, n, cwd) -> dict:
    """What the port's script hands its stubs, on ``n`` ranks."""
    import tpugan_torch.export as export
    import tpugan_torch.parallel as parallel
    import tpugan_torch.serve.server as server
    import tpugan_torch.train.trainer as trainer

    seen = {}
    Trainer, make_mesh, exp, load, engine = _recorders(seen)

    def spawn(fn, world, args=(), **kw):
        seen["world"] = world
        return [fn(0, *args)]

    mesh = script in ("data_parallel_training", "train_256px_spatial")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "Trainer", Trainer)
        mp.setattr(parallel, "make_mesh", make_mesh)
        mp.setattr(multihost, "spawn", spawn)
        mp.setattr(export, "export_generator", exp)
        mp.setattr(export, "load_generator", load)
        mp.setattr(server, "BatchingEngine", engine)
        with contextlib.suppress(_Stop):
            run_in_process(PORT / f"{script}.py",
                           ["--device", "cpu",
                            *(["--world", n] if mesh else []), *argv], cwd)
    return seen


def jax_decides(argv, script, n, cwd) -> dict:
    """What the JAX script hands its stubs, on ``n`` devices."""
    import tpugan.cli
    import tpugan.export
    import tpugan.parallel
    import tpugan.serve
    import tpugan.train

    seen = {}
    Trainer, make_mesh, exp, load, engine = _recorders(seen)
    devices = jax.devices()[:n]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: list(devices))
        mp.setattr(tpugan.train, "Trainer", Trainer)
        mp.setattr(tpugan.parallel, "make_mesh", make_mesh)
        mp.setattr(tpugan.cli, "_load_generator_from_ckpt",
                   lambda d: (tpugan.cli._load_cfg_for_ckpt(d), None, None,
                              None, 4))
        mp.setattr(tpugan.export, "export_generator", exp)
        mp.setattr(tpugan.export, "load_generator", load)
        mp.setattr(tpugan.serve, "BatchingEngine", engine)
        with contextlib.suppress(_Stop):
            run_in_process(JAX / f"{script}.py", argv, cwd)
    return seen


CONFIG_CASES = [
    ("train_dcgan_mnist", [], 1),
    ("train_dcgan_mnist", ["--steps", 4, "--out", "OUT"], 1),
    ("train_wgan_gp_cifar10", ["--steps", 6, "--out", "OUT"], 1),
    ("data_parallel_training", ["--steps", 4], 1),
    ("data_parallel_training", ["--steps", 4], 2),
    ("data_parallel_training", [], 8),
    ("train_256px_spatial", ["--steps", 2, "--width", 8, "--batch", 8], 2),
    ("train_256px_spatial", ["--steps", 2, "--width", 8, "--batch", 8], 8),
    ("train_256px_spatial", ["--data-shards", 2], 8),
    ("train_multihost", ["--steps", 4, "--out", "OUT"], 1),
    ("train_multihost", ["--preset", "wgan_gp_cifar10"], 1),
    ("serve_and_query", ["--ckpt", "CKPT"], 1),
]


@pytest.mark.parametrize(
    "script, argv, n", CONFIG_CASES,
    ids=[f"{s}-{i}" for i, (s, _, _) in enumerate(CONFIG_CASES)])
def test_each_example_builds_the_jax_config(script, argv, n, mnist,
                                            tmp_path):
    argv = [{"OUT": tmp_path / "out",
             "CKPT": mnist[0] / "ckpt"}.get(a, a) for a in argv]
    got = port_decides(argv, script, n, tmp_path)
    want = jax_decides(argv, script, n, tmp_path)
    port_cfg, jax_cfg = (dataclasses.asdict(x["cfg"]) for x in (got, want))
    assert port_cfg.keys() == jax_cfg.keys()
    for section, fields in jax_cfg.items():
        if not isinstance(fields, dict):
            assert port_cfg[section] == fields, section
            continue
        assert port_cfg[section].keys() == fields.keys(), section
        for name, value in fields.items():
            assert port_cfg[section][name] == value, f"{section}.{name}"
    if script == "train_multihost":
        # one process: the JAX script's one-device mesh, the port's none
        assert got["mesh"] is None and want["mesh"] == ("mesh", None)
    elif script == "serve_and_query":
        assert got["max_batch"] == want["max_batch"] == 32
    else:
        assert got["mesh"] == want["mesh"]
        assert got.get("grid") == want.get("grid")
    if script == "train_256px_spatial" and n > 1:
        # the port spawns the mesh's ranks
        t = got["cfg"].train
        assert got["world"] == (t.mesh_shape or 1) * t.spatial_shards


# ---------------------------------------------------------------------------
# The scripts that ran in the background
# ---------------------------------------------------------------------------

def test_train_wgan_gp_cifar10_trains_and_scores(background):
    out = background.collect("wgan")
    assert "CIFAR-10 not found -> deterministic synthetic dataset" in out
    assert final_metrics(out)["gp"] > 0
    # eval_every=2000 scores at the last step too, as the JAX Trainer does
    assert '"fid"' in (background.tmp / "wgan" / "metrics.jsonl").read_text()


def test_train_multihost_processes_agree(background):
    text = background.collect("mh")
    done = dict(re.findall(r"\[process (\d)\] done: loss_d=(\S+)", text))
    assert sorted(done) == ["0", "1"] and done["0"] == done["1"], text
    assert "[process 1] 2 processes, 2 global devices" in text
    assert (background.tmp / "mh" / "ckpt" / "4.pt").is_file()
