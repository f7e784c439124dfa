"""The port's deployable generator artifact (``tpugan_torch/export``)
against its live module path and against the JAX package's artifact for
the same carried weights, on the CPU at small widths: symbolic and fixed
batches, the conditional model, the refusals, and serving through
``BatchingEngine``."""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

from _torch_port_common import to_numpy, twin_generators
from tpugan.export import export_generator as jax_export
from tpugan.export import load_generator as jax_load
from tpugan_torch.ckpt.from_jax import load_jax_module
from tpugan_torch.export import (export_generator, load_generator,
                                 save_generator)
from tpugan_torch.models.registry import build_generator
from tpugan_torch.ops import convs
from tpugan_torch.sample.sampler import seeded_labels, seeded_noise
from tpugan_torch.serve.server import BatchingEngine

SMALL = {"model.ngf": 8, "model.nz": 8, "model.embed_dim": 4}


def _live(g, kernels, z, y=None):
    """The live module path: eval mode, the image in float32."""
    with torch.no_grad(), convs.using_impl(kernels):
        zt = torch.from_numpy(z)
        out = g(zt, torch.from_numpy(y)) if y is not None else g(zt)
    return out.float().numpy()


@pytest.fixture(scope="module")
def uncond():
    return twin_generators("dcgan_celeba64", SMALL)


@pytest.fixture(scope="module")
def jax_artifact(uncond):
    cfg, g, params, state, _, _ = uncond
    return jax_load(jax_export(cfg, g, params, state, platforms=("cpu",)))


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
def test_artifact_matches_live_module_and_jax_artifact(uncond, jax_artifact,
                                                       kernels):
    _, _, params, state, pcfg, tg = uncond
    cfg = pcfg.override({"train.kernels": kernels})
    art = load_generator(export_generator(cfg, tg), device="cpu")
    assert art.meta["runtime"] == "torch" and art.meta["batch"] is None
    assert art.meta["platforms"] == ["cpu", "cuda"]
    assert "torch_version" in art.meta and "jax_version" not in art.meta
    # the same aten ops (and, under "pallas", the same op) on the same
    # weights: fp32 within 1e-6, at three batch sizes of one artifact
    for n in (1, 5, 13):
        z = seeded_noise(8, n, seed=n)
        got = art.generate(z)
        assert got.shape == (n, 64, 64, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, _live(tg, kernels, z), rtol=0,
                                   atol=1e-6)
    # the JAX package's artifact of the same weights (XLA, fp32): the
    # sampler's tolerances; "pallas" in bf16 with the weights carried into
    # a bf16 port generator
    ref = jax_artifact.sample(6, seed=3)
    np.testing.assert_allclose(art.sample(6, seed=3), ref, atol=1e-4)
    if kernels == "pallas":
        g16 = build_generator(cfg.model, "bf16", device="cpu").eval()
        load_jax_module(g16, to_numpy(params), to_numpy(state))
        art16 = load_generator(export_generator(cfg, g16), device="cpu")
        np.testing.assert_allclose(art16.sample(6, seed=3), ref, atol=3e-2)


def test_pallas_graph_holds_the_kernel_op(uncond, tmp_path):
    _, _, _, _, pcfg, tg = uncond
    cfg = pcfg.override({"train.kernels": "pallas"})
    path = str(tmp_path / "g.tpugan")
    tg.train()
    save_generator(path, cfg, tg)
    assert tg.training  # the caller's mode is put back
    tg.eval()
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["generator.pt2", "meta.json"]
        program = torch.export.load(io.BytesIO(zf.read("generator.pt2")))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert sum("tpugan_torch.convt_affine_act" in t for t in targets) == 4
    # no op makes a tensor on a named device (the trace's metadata checks
    # name one; moving the program rewrites them)
    named = {str(n.target) for n in program.graph.nodes
             if n.op == "call_function" and "device" in n.kwargs}
    assert named <= {"aten._assert_tensor_metadata.default"}, named


def test_fixed_batch_pads_the_tail(uncond):
    _, _, _, _, pcfg, tg = uncond
    cfg = pcfg.override({"train.kernels": "pallas"})
    fixed = load_generator(export_generator(cfg, tg, batch=4), device="cpu")
    free = load_generator(export_generator(cfg, tg), device="cpu")
    assert fixed.fixed_batch == 4
    z = seeded_noise(8, 10, seed=1)
    np.testing.assert_allclose(fixed.generate(z), free.generate(z), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(fixed.sample(10, seed=1),
                               free.sample(10, seed=1), rtol=0, atol=1e-6)


def test_conditional_artifact_matches_jax():
    cfg, g, params, state, pcfg, tg = twin_generators("cdcgan_celeba64",
                                                      SMALL)
    ref = jax_load(jax_export(cfg, g, params, state, platforms=("cpu",)))
    art = load_generator(export_generator(pcfg, tg), device="cpu")
    assert art.conditional and art.n_classes == pcfg.model.n_classes
    np.testing.assert_allclose(art.sample(5, seed=2), ref.sample(5, seed=2),
                               atol=1e-4)
    z, y = seeded_noise(8, 3, 4), seeded_labels(pcfg.model.n_classes, 3, 4)
    np.testing.assert_allclose(art.generate(z, y), _live(tg, "xla", z, y),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="labels"):
        art.generate(z)


def test_refusals(uncond, tmp_path):
    cfg, g, params, state, pcfg, tg = uncond
    with pytest.raises(ValueError, match="JAX artifact"):
        load_generator(jax_export(cfg, g, params, state,
                                  platforms=("cpu",)), device="cpu")
    with pytest.raises(ValueError, match="not 'cpu'"):
        load_generator(export_generator(pcfg, tg, platforms=("cuda",)),
                       device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        export_generator(pcfg, tg, platforms=("tpu",))
    blob = export_generator(pcfg, tg)
    buf = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as src, \
            zipfile.ZipFile(buf, "w") as dst:
        meta = json.loads(src.read("meta.json"))
        dst.writestr("meta.json", json.dumps(dict(meta, format_version=2)))
        dst.writestr("generator.pt2", src.read("generator.pt2"))
    with pytest.raises(ValueError, match="unsupported artifact format"):
        load_generator(buf.getvalue(), device="cpu")
    art = load_generator(blob, device="cpu")
    with pytest.raises(ValueError, match="labels"):
        art.generate(seeded_noise(8, 2, 0), [0, 1])


def test_artifact_serves_through_the_engine(uncond):
    _, _, _, _, pcfg, tg = uncond
    cfg = pcfg.override({"train.kernels": "pallas"})
    art = load_generator(export_generator(cfg, tg, batch=4), device="cpu")
    engine = BatchingEngine(art, max_batch=8, linger_ms=1)
    try:
        got = engine.sample(7, seed=5).result(timeout=120)
    finally:
        engine.close()
    np.testing.assert_allclose(got, art.sample(7, seed=5), rtol=0, atol=1e-6)
