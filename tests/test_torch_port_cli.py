"""The port's command line (``tpugan_torch/cli.py``) on ``--device cpu``,
in process, at small widths: the train -> sample -> eval -> sample
--outdir -> fid round trip, export and serve from a checkpoint, the
commands whose output the JAX package's CLI fixes (presets,
convert-inception), profile, and the options not ported yet."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from tpugan import cli as jax_cli
from tpugan_torch import cli
from tpugan_torch.eval.inception import _conv_defs
from tpugan_torch.export import ExportedGenerator, load_generator
from tpugan_torch.sample.sampler import Sampler
from tpugan_torch.utils import profiling

SETS = ["data.dataset=synthetic", "data.batch_size=8",
        "data.synthetic_size=32", "model.ngf=8", "model.ndf=8",
        "model.nz=8", "train.total_steps=3", "train.log_every=3",
        "train.sample_every=0", "train.ckpt_every=3",
        "train.precision=fp32", "train.kernels=pallas"]


def run(capsys, *argv):
    cli.main(["--device", "cpu", *argv])
    return capsys.readouterr().out


def _sets(sets):
    return [a for s in sets for a in ("--set", s)]


@pytest.fixture()
def ckpt(tmp_path, capsys):
    out = run(capsys, "train", "dcgan_mnist", "--out", str(tmp_path / "run"),
              *_sets(SETS))
    final = json.loads(out.strip().splitlines()[-1])["final"]
    assert np.isfinite(final["loss_d"]) and np.isfinite(final["loss_g"])
    return str(tmp_path / "run" / "ckpt")


def test_train_sample_eval_fid_round_trip(ckpt, tmp_path, capsys):
    assert os.path.exists(os.path.join(ckpt, "config.json"))
    grid = str(tmp_path / "g.png")
    out = run(capsys, "sample", "--ckpt", ckpt, "--n", "4", "--seed", "5",
              "--out", grid)
    assert "wrote" in out and "step 3" in out and os.path.exists(grid)
    result = json.loads(run(capsys, "eval", "--ckpt", ckpt, "--fid-n",
                            "16").strip().splitlines()[-1])
    assert np.isfinite(result["fid"]) and result["backend"] == "proxy"
    d1, d2 = str(tmp_path / "set_a"), str(tmp_path / "set_b")
    run(capsys, "sample", "--ckpt", ckpt, "--n", "8", "--seed", "1",
        "--outdir", d1)
    run(capsys, "sample", "--ckpt", ckpt, "--n", "8", "--seed", "2",
        "--outdir", d2)
    assert sorted(os.listdir(d1))[0] == "sample_000000.png"
    assert len(os.listdir(d2)) == 8
    r = json.loads(run(capsys, "fid", d1, d2, "--image-size", "28",
                       "--channels", "1", "--batch", "8")
                   .strip().splitlines()[-1])
    assert np.isfinite(r["fid"]) and r["n_a"] == 8 and r["n_b"] == 8
    assert "is_mean" not in r


def test_export_and_serve_from_a_checkpoint(ckpt, tmp_path, capsys,
                                            monkeypatch):
    """``export`` writes the artifact the checkpoint's sampler agrees
    with; ``serve --ckpt`` and ``serve --model`` hand serve_forever an
    engine over that artifact."""
    cfg, g, _ = cli._load_generator_from_ckpt(ckpt, "cpu")
    want = Sampler(cfg.override({"train.kernels": "xla"}), g).sample(
        5, seed=9)
    path = str(tmp_path / "g.tpugan")
    out = run(capsys, "export", "--ckpt", ckpt, "--out", path, "--batch",
              "4")
    assert "batch=4" in out and "kernels=pallas" in out
    art = load_generator(path, device="cpu")
    assert art.fixed_batch == 4
    # the per-layer kernel-1 path (its plain version here, fp32) against
    # the module's PyTorch ops: BN folded into the kernel's affine
    np.testing.assert_allclose(art.sample(5, seed=9), want, atol=1e-5)
    served = []
    monkeypatch.setattr(cli, "serve_forever",
                        lambda engine, host, port: served.append(engine))
    for source in (["--ckpt", ckpt], ["--model", path]):
        run(capsys, "serve", *source, "--max-batch", "8")
        engine = served.pop()
        try:
            assert isinstance(engine.gen, ExportedGenerator)
            got = engine.sample(5, seed=9).result(timeout=120)
        finally:
            engine.close()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_presets_print_the_jax_packages_lines(capsys):
    jax_cli.main(["presets"])
    theirs = capsys.readouterr().out
    assert run(capsys, "presets") == theirs and "dcgan_celeba64" in theirs


@pytest.mark.parametrize("preset,sets", [
    ("dcgan_cifar10", ["data.batch_size=16"]),
    ("cdcgan_celeba128", ["model.image_size=32", "data.batch_size=8"])])
def test_profile_reports_costs_and_rate(capsys, tmp_path, preset, sets):
    out = run(capsys, "profile", preset, "--iters", "1", "--trace",
              str(tmp_path / "prof"),
              *_sets(["model.ngf=8", "model.ndf=8", "model.nz=8",
                      "train.precision=fp32", *sets]))
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["flops_per_step"] > 1e6 and rec["bytes_accessed"] > 0
    assert rec["ms_per_step"] > 0 and rec["images_per_sec"] > 0
    assert rec["device"] == "cpu"
    assert os.path.exists(tmp_path / "prof" / "trace.json")


def test_convert_inception_writes_the_jax_packages_pickle(tmp_path, capsys):
    rng = np.random.default_rng(0)
    sd = {}
    for path, *_ in _conv_defs():
        sd[f"{path}.conv.weight"] = torch.from_numpy(
            rng.standard_normal((3, 2, 1, 2)).astype(np.float32))
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{path}.bn.{k}"] = torch.from_numpy(
                rng.standard_normal(3).astype(np.float32))
    sd["fc.weight"] = torch.ones(4, 3)
    sd["fc.bias"] = torch.zeros(4)
    src = str(tmp_path / "inc.pth")
    torch.save(sd, src)
    ours, theirs = str(tmp_path / "ours.pkl"), str(tmp_path / "theirs.pkl")
    run(capsys, "convert-inception", "--src", src, "--out", ours)
    jax_cli.main(["convert-inception", "--src", src, "--out", theirs])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with open(ours, "rb") as f:
        got = pickle.load(f)
    np.testing.assert_array_equal(got["fc"]["w"], np.ones((3, 4)))


def test_not_ported_options_name_their_items(tmp_path, capsys):
    """bench names its Queue A item; the JAX CLI's refusals of a mesh: serve
    --shards without --ckpt, and a mesh larger than the ranks running (a
    process launched as one rank of one)."""
    with pytest.raises(NotImplementedError, match="Benchmark"):
        cli.main(["--device", "cpu", "bench", "--quick"])
    with pytest.raises(SystemExit, match="--shards needs --ckpt"):
        cli.main(["--device", "cpu", "serve", "--model", str(tmp_path),
                  "--shards", "4"])
    with pytest.raises(SystemExit, match="needs --model or --ckpt"):
        cli.main(["--device", "cpu", "serve", "--shards", "4"])
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with pytest.raises(ValueError, match="only 1 rank"):
            run(capsys, "train", "dcgan_mnist", "--out",
                str(tmp_path / "m"), *_sets(SETS + ["train.mesh_shape=4"]))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "presets", "--bogus"])
    with pytest.raises(SystemExit, match="config.json"):
        cli.main(["--device", "cpu", "sample", "--ckpt", str(tmp_path)])


def test_profiling_helpers_count_and_time():
    """``cost_analysis`` counts a matmul's 2mnk FLOPs and its operands'
    and result's bytes, nothing for a view and a mutated operand once;
    the timer runs on the CPU."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    costs = profiling.cost_analysis(torch.matmul, a, b)
    assert costs["flops"] == 2 * 8 * 16 * 4
    assert costs["bytes accessed"] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    viewed = profiling.cost_analysis(
        lambda: torch.matmul(a.t().view(16, 8).t(), b.view(16, 4)))
    assert viewed == costs
    assert profiling.cost_analysis(
        lambda: a.add_(1.0))["bytes accessed"] == 8 * 16 * 4
    assert profiling.timeit(torch.matmul, a, b, iters=3, warmup=1) > 0
