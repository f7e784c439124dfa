"""The port's multi-process bootstrap against the JAX package's
(``tests/test_multihost.py``, case for case as far as each applies): two
OS processes join one gloo process group on the CPU, sum across it, run
the WGAN-GP train step (double backward, cross-rank BatchNorm, both
updates) data-parallel, and train and resume through the ``Trainer``;
``initialize_multihost``'s bootstrap branches and its refusals; the
spawner's failure reporting and the backend rules.

The ranks are spawned once for the module (``_torch_port_workers.py``),
their last case failing on purpose; this file imports no JAX: its numbers
are held to the port's single program, which the other port tests hold
to the JAX package's.
Tolerances: the 2-process train step's metrics within 1e-5 relative of
the single program's and its parameters within lr / 20 = 5e-6; the two
ranks' logged losses equal."""

import numpy as np
import pytest
import torch.distributed as dist

from tpugan_torch.parallel import multihost

WGAN = {"model.ngf": 8, "model.ndf": 8, "model.nz": 8,
        "data.batch_size": 8, "train.precision": "fp32"}
TRAINER = {"data.dataset": "synthetic", "data.batch_size": 16,
           "data.synthetic_size": 64, "model.ngf": 8, "model.ndf": 8,
           "model.nz": 8, "train.precision": "fp32", "train.log_every": 1,
           "train.sample_every": 0, "train.ckpt_every": 2,
           "train.mesh_shape": 2}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case in one spawn of 2 ranks; its last case fails on rank 1,
    so the spawn raises, and each rank's results come from the files
    ``run_cases`` keeps."""
    import pickle

    from _torch_port_workers import run_cases

    imgs = np.random.default_rng(0).integers(
        0, 256, size=(8, 32, 32, 3)).astype(np.uint8)
    init = None  # the port's seeded initialization, on every rank
    data = {"images": np.random.default_rng(1).integers(
        0, 256, size=(64, 32, 32, 3)).astype(np.uint8)}
    cases = [
        ("all_reduce_psum", dict(world=2)),
        ("steps", dict(preset="wgan_gp_cifar10", overrides=WGAN,
                       init_sd=init, batches=[{"image": imgs}], kind="dp",
                       shape=(2,))),
        ("steps", dict(preset="wgan_gp_cifar10", overrides=WGAN,
                       init_sd=init, batches=[{"image": imgs}],
                       kind="single", shape=None)),
        ("trainer", dict(preset="dcgan_cifar10", overrides=TRAINER,
                         data=data, steps=2, resume_steps=3,
                         workdir=str(tmp_path_factory.mktemp("trainer")))),
        ("fail_on", dict(bad=1)),
    ]
    keep = tmp_path_factory.mktemp("results")
    try:
        multihost.spawn(run_cases, 2, (cases, str(keep)), device="cpu",
                        timeout=600)
        failure = None
    except RuntimeError as e:
        failure = str(e)
    results = []
    for rank in range(2):
        with open(keep / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    names = ["psum", "wgan", "wgan_single", "trainer"]
    return failure, {n: [r[i] for r in results] for i, n in enumerate(names)}


def test_two_process_distributed_psum(world):
    """Each process contributes its rows of arange(4); the sum across the
    group sees both."""
    _, got = world
    for pid, r in enumerate(got["psum"]):
        assert r["rank"] == pid and r["main"] == (pid == 0)
        assert r["slice"] == (2 * pid, 2 * pid + 2)
        assert r["sum"] == 6.0


def test_two_process_distributed_train_step(world):
    """The WGAN-GP step (penalty double backward, BatchNorm over both
    ranks, both updates) over 2 processes equals the single program from
    the same state (the single program is held to the JAX step by
    ``test_torch_port_train_step.py``); both ranks log the same losses."""
    _, got = world
    sd, pms, _ = got["wgan"][0]
    assert got["wgan"][1] == pms  # the ranks agree
    one, oms, _ = got["wgan_single"][0]
    for k, v in oms[0].items():
        np.testing.assert_allclose(pms[0][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert pms[0]["gp"] > 0
    for part in ("g", "d"):
        for k, v in one[part].items():
            np.testing.assert_allclose(sd[part][k], v, rtol=0,
                                       atol=1e-4 / 20, err_msg=k)


def test_two_process_trainer_end_to_end(world):
    """Trainer(cfg).train() on 2 processes: each feeds its own rows, both
    log the same losses, only process 0 writes metric files, and the run
    resumes from the shared checkpoint."""
    _, got = world
    a, b = got["trainer"]

    def losses(m):  # (images_per_sec is each rank's own clock)
        return {k: v for k, v in m.items() if k != "images_per_sec"}

    assert losses(a["metrics"]) == losses(b["metrics"])
    assert losses(a["resumed"]) == losses(b["resumed"])
    assert a["resumed_step"] == b["resumed_step"] == 3
    assert "metrics.jsonl" in a["wrote"] and b["wrote"] == []
    assert a["facts"]["mesh"] == ("data",)
    assert np.isfinite(a["resumed"]["loss_d"])


def test_spawn_reports_a_failed_rank(world):
    """A rank that raises (rank 1, in the fixture's last case) stops the
    others (rank 0 waits at a barrier it never passes) and its traceback
    is raised in the parent."""
    failure, _ = world
    assert failure is not None and "rank 1 failed" in failure
    assert "fails on purpose" in failure


def test_initialize_multihost_unit_paths(monkeypatch):
    """Every bootstrap branch, in-process: the single-process no-op, an
    explicit coordinator (forwarded as a tcp:// URL), a file store URL,
    the launcher's environment (torchrun), and the half-specified cluster
    that must fail loudly."""
    calls = []

    def fake_init(backend=None, init_method=None, world_size=-1, rank=-1):
        calls.append((backend, init_method, world_size, rank))

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 3)

    assert multihost.initialize_multihost(device="cpu") == 0
    assert multihost.initialize_multihost(num_processes=1,
                                          device="cpu") == 0
    assert calls == []

    assert multihost.initialize_multihost("10.0.0.1:9999", 4, 3,
                                          device="cpu") == 3
    assert calls == [("gloo", "tcp://10.0.0.1:9999", 4, 3)]

    calls.clear()
    assert multihost.initialize_multihost("file:///tmp/x/store", 2, 1,
                                          device="cpu") == 3
    assert calls == [("gloo", "file:///tmp/x/store", 2, 1)]

    calls.clear()
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert multihost.initialize_multihost(autodetect=True,
                                          device="cpu") == 3
    assert calls == [("gloo", "env://", -1, -1)]

    calls.clear()
    with pytest.raises(ValueError, match="without"):
        multihost.initialize_multihost(process_id=3, device="cpu")
    assert calls == []


def test_backend_rules():
    """NCCL for CUDA ranks (one a card), gloo for the CPU, gloo for CUDA
    ranks only when asked; more CUDA ranks than cards raise."""
    import torch

    assert multihost.choose_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        multihost.choose_backend("cpu", 2, "nccl")
    assert multihost.choose_backend("cuda", 2, "gloo") == "gloo"
    too_many = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        multihost.choose_backend("cuda", too_many)
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        multihost.spawn(print, too_many, device="cuda")


def test_local_batch_slice_single_process():
    assert multihost.local_batch_slice(8) == slice(0, 8)
    assert multihost.is_main_process()
