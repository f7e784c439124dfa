"""The port's serving slice against the JAX package: seeded noise and
labels, Sampler pixels for a seed, and HTTP serving end to end (on CPU)."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import twin_generators
from tpugan.sample.sampler import Sampler as JaxSampler
from tpugan.sample.sampler import seeded_labels as jax_labels
from tpugan.sample.sampler import seeded_noise as jax_noise
from tpugan.utils.images import encode_png as jax_encode_png
from tpugan_torch.sample.sampler import Sampler, seeded_labels, seeded_noise
from tpugan_torch.serve.server import BatchingEngine, make_server
from tpugan_torch.utils.images import encode_png


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("offset", [0, 5, 1000])
def test_seeded_noise_and_labels_match_jax(seed, offset):
    # labels are integer draws: bit-exact.  Noise runs XLA's float32
    # erf_inv polynomial on the same uniform bits; XLA's log1p / fused
    # multiply-adds leave at most an ulp (<= 4.8e-7 at |z| < 8), so 1e-6.
    np.testing.assert_array_equal(seeded_labels(10, 32, seed, offset),
                                  np.asarray(jax_labels(10, 32, seed, offset)))
    np.testing.assert_allclose(seeded_noise(100, 32, seed, offset),
                               np.asarray(jax_noise(100, 32, seed, offset)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernels", ["xla", "pallas"])
def test_sampler_pixels_match_jax(kernels):
    """The whole slice: seed -> noise -> generator -> pixels, port vs JAX
    (the JAX Sampler runs XLA on the CPU; the port's "pallas" runs the
    megakernel's plain version)."""
    cfg, g, params, state, pcfg, tg = twin_generators(
        "dcgan_cifar10", {"model.ngf": 8})
    ref = JaxSampler(cfg, g, params, state).sample(6, seed=11)
    s = Sampler(pcfg.override({"train.kernels": kernels}), tg)
    got = s.sample(6, seed=11)
    assert got.shape == ref.shape == (6, 32, 32, 3) and got.dtype == np.float32
    # "xla": fp32 both, sum order.  "pallas": bf16 matmul operands as the
    # Pallas megakernel, against an fp32 XLA forward.
    np.testing.assert_allclose(got, ref, atol=1e-4 if kernels == "xla"
                               else 3e-2)
    chunked = s.sample(6, seed=11, batch_size=4)
    if kernels == "pallas":  # the kernel path computes each image alone
        np.testing.assert_array_equal(chunked, got)
    else:  # PyTorch's CPU convs pick batch-dependent blockings: fp32 ulps
        np.testing.assert_allclose(chunked, got, rtol=0, atol=1e-6)


def test_sampler_surface_conditional_matches_jax():
    cfg, g, params, state, pcfg, tg = twin_generators(
        "cdcgan_celeba64", {"model.ngf": 4, "model.nz": 8,
                            "model.embed_dim": 4})
    js = JaxSampler(cfg, g, params, state)
    s = Sampler(pcfg, tg)
    # fp32, sum order only
    np.testing.assert_allclose(s.sample(4, seed=2), js.sample(4, seed=2),
                               atol=1e-4)
    z = np.asarray(js.noise(3, 5))
    np.testing.assert_allclose(s.sample_fixed(z, [0, 1, 1]),
                               js.sample_fixed(z, jnp.array([0, 1, 1])),
                               atol=1e-4)
    for spherical in (False, True):
        np.testing.assert_allclose(
            s.interpolate(1, 2, steps=3, label=1, spherical=spherical),
            js.interpolate(1, 2, steps=3, label=1, spherical=spherical),
            atol=1e-4)
    # the truncated latents differ by an ulp of erf/erf_inv at most
    np.testing.assert_allclose(s.sample_truncated(2, seed=4, threshold=0.5),
                               js.sample_truncated(2, seed=4, threshold=0.5),
                               atol=1e-4)


def test_save_grid_png_matches_jax_png(tmp_path):
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (10, 14, 3), np.uint8)
    for arr in (img, img[..., :1]):
        ours = Image.open(io.BytesIO(encode_png(arr)))
        theirs = Image.open(io.BytesIO(jax_encode_png(arr)))
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    _, _, _, _, pcfg, tg = twin_generators("dcgan_mnist", {"model.ngf": 4})
    grid = Sampler(pcfg, tg).save_grid(str(tmp_path / "g.png"), n=4, nrow=2)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "g.png")), grid[..., 0])


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_serving_end_to_end():
    cfg, g, params, state, pcfg, tg = twin_generators(
        "dcgan_cifar10", {"model.ngf": 8})
    sampler = Sampler(pcfg.override({"train.kernels": "pallas"}), tg)
    engine = BatchingEngine(sampler, max_batch=8, linger_ms=5)
    srv = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        results = {}

        def hit(i, body):
            results[i] = _post(url + "/sample", body)

        reqs = [{"n": 3, "seed": 1, "format": "npy"},
                {"n": 5, "seed": 2, "format": "png", "nrow": 3},
                {"n": 12, "seed": 3, "format": "npy"}]
        threads = [threading.Thread(target=hit, args=(i, b))
                   for i, b in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i in (0, 2):
            code, body = results[i]
            assert code == 200
            imgs = np.load(io.BytesIO(body))
            # served pixels are the Sampler's for the same seed, whatever
            # batch the engine coalesced them into
            np.testing.assert_allclose(
                imgs, sampler.sample(reqs[i]["n"], seed=reqs[i]["seed"]),
                atol=1e-6)
        code, body = results[1]
        assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        for bad in ({"n": 0}, {"n": 2, "nrow": 0}, {"n": 2, "labels": [0, 1]},
                    {"n": 2, "format": "gif"}):
            assert _post(url + "/sample", bad)[0] == 400
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["model"]["image_size"] == 32
        assert health["stats"]["images"] >= 20
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()


def test_conditional_serving_validates_labels():
    _, _, _, _, pcfg, tg = twin_generators(
        "cdcgan_celeba64", {"model.ngf": 4, "model.nz": 8,
                            "model.embed_dim": 4})
    engine = BatchingEngine(Sampler(pcfg, tg), max_batch=4)
    srv = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/sample"
    try:
        assert _post(url, {"n": 2, "labels": [0, 5]})[0] == 400
        assert _post(url, {"n": 2, "labels": [0]})[0] == 400
        code, body = _post(url, {"n": 2, "labels": [1, 0], "format": "npy"})
        assert code == 200 and np.load(io.BytesIO(body)).shape == (2, 64, 64,
                                                                   3)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
    with pytest.raises(ValueError):
        Sampler(pcfg, tg).generate(np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError):
        Sampler(pcfg.override({"train.kernels": "cudnn"}), tg)
    assert torch.is_grad_enabled()


@pytest.mark.parametrize("preset,n,bs,u", [
    ("dcgan_cifar10", 12, 3, 2),     # two calls of 2 batches
    ("dcgan_cifar10", 11, 3, 2),     # one call of 2, then a batch and a tail
    ("cdcgan_celeba64", 8, 2, 4),    # conditional, one call of 4
])
def test_unroll_gives_unroll_1_pixels(preset, n, bs, u):
    """``sample(unroll=u)`` (the plain loop on the CPU) equals
    ``unroll=1`` bit for bit, seeded labels and a tail included."""
    _, _, _, _, pcfg, tg = twin_generators(
        preset, {"model.ngf": 4, "model.nz": 8, "model.embed_dim": 4})
    s = Sampler(pcfg, tg)
    want = s.sample(n, seed=4, batch_size=bs)
    got = s.sample(n, seed=4, batch_size=bs, unroll=u)
    assert got.shape == want.shape == (n,) + want.shape[1:]
    np.testing.assert_array_equal(got, want)


def test_unroll_under_pallas_warns_and_runs_sequentially():
    _, _, _, _, pcfg, tg = twin_generators("dcgan_cifar10",
                                           {"model.ngf": 4, "model.nz": 8})
    s = Sampler(pcfg.override({"train.kernels": "pallas"}), tg)
    with pytest.warns(UserWarning, match="unroll"):
        got = s.sample(7, seed=1, batch_size=2, unroll=4)
    np.testing.assert_array_equal(got, s.sample(7, seed=1, batch_size=2))
