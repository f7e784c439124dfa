"""The port's eval (``tpugan_torch/eval``) against ``tpugan/eval`` on the
CPU: the metric math, the proxy extractor, InceptionV3, ``evaluate`` with
a carried generator, and ``evaluate_folders``.

Tolerances:

- FID, KID, IS and PRDC: bit for bit on the same features (the same numpy
  and scipy arithmetic);
- the proxy extractor with JAX's weights carried across: features within
  1e-5 relative (fp32 conv sum order);
- the proxy built by the port itself: its conv weights within 8 ulp of
  JAX's (threefry's normals differ from XLA's ``erf_inv`` by an ulp, and
  the scale divides once more), FID within 1e-3 relative;
- InceptionV3 with carried weights: features within 1e-4 relative, at 2
  images; the 299 px resize within 1e-5;
- ``evaluate`` and ``evaluate_folders``: FID and KID within 1e-3
  relative (independent extractors; the generator carried, under "xla").
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port_common import twin_generators
from tpugan.eval import features as jax_features
from tpugan.eval import fid as jax_fid
from tpugan.eval import inception as jax_inception
from tpugan.eval.evaluate import evaluate as jax_evaluate
from tpugan.eval.evaluate import evaluate_folders as jax_evaluate_folders
from tpugan_torch.eval import evaluate as port_evaluate
from tpugan_torch.eval import features, fid, inception
from tpugan_torch.utils.cache import BoundedCache


def _feats(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d))


@pytest.mark.parametrize("n,d", [(40, 8), (12, 32)])
def test_metrics_are_jaxs_bit_for_bit(n, d):
    """n > d and n < d (a singular covariance: the regularized retry)."""
    a, b = _feats(n, d, 0), _feats(n, d, 1) * 0.8 + 0.3
    assert fid.fid_from_features(a, b) == jax_fid.fid_from_features(a, b)
    assert fid.kid_from_features(a, b) == jax_fid.kid_from_features(a, b)
    probs = np.abs(a[:, :5]) / np.abs(a[:, :5]).sum(1, keepdims=True)
    assert fid.inception_score(probs) == jax_fid.inception_score(probs)
    assert (fid.prdc_from_features(a, b, k=3)
            == jax_fid.prdc_from_features(a, b, k=3))


def test_bounded_cache_evicts_the_least_recent():
    c = BoundedCache(maxsize=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert "b" not in c and len(c) == 2 and c.get("a") == 1


@pytest.fixture(scope="module")
def jax_proxy():
    """JAX's proxy weights (convs and trained head) for 3 channels."""
    convs, head = jax_features._proxy_params(3)
    return [np.asarray(w) for w in convs], tuple(np.asarray(h) for h in head)


def test_proxy_features_with_carried_weights(jax_proxy):
    convs, head = jax_proxy
    x = np.random.default_rng(2).uniform(-1, 1, (16, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jax_features._proxy_features)(
        [jnp.asarray(w) for w in convs], jnp.asarray(x)))
    feat, probs = features.proxy_extractor(convs, head, device="cpu")(
        x, batch=5)
    np.testing.assert_allclose(feat, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    ref_p = np.asarray(jax.nn.softmax(ref @ head[0] + head[1], axis=-1))
    np.testing.assert_allclose(probs, ref_p, rtol=0, atol=1e-4)


def test_proxy_built_independently(jax_proxy):
    """The port draws the proxy's convs itself (threefry) and fits its own
    head: the weights within a few ulp, FID of two sets within 1e-3."""
    for got, ref in zip(features.proxy_convs(3), jax_proxy[0]):
        assert got.dtype == np.float32 and got.shape == ref.shape
        ulps = np.abs(got - ref) / np.spacing(np.abs(ref))
        assert ulps.max() <= 8
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (48, 64, 64, 3)).astype(np.float32)
    y = (rng.uniform(-1, 1, (48, 64, 64, 3)) * 0.6 + 0.1).astype(np.float32)
    port = features.make_extractor(3, "proxy", device="cpu")
    assert features.make_extractor(3, "proxy", device="cpu") is port
    jext = jax_features.make_extractor(3, "proxy")
    fr, pr = port(x)
    got = fid.fid_from_features(fr, port(y)[0])
    ref = jax_fid.fid_from_features(jext(x)[0], jext(y)[0])
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    np.testing.assert_allclose(pr.sum(1), 1.0, rtol=1e-5)
    with pytest.raises(FileNotFoundError, match="inception_weights"):
        features.make_extractor(3, "inception", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        features.make_extractor(3, "vgg", device="cpu")


@pytest.mark.parametrize("size", [28, 32, 64, 128])
def test_resize_to_299_is_jaxs(size):
    """``F.interpolate`` bilinear (half-pixel centres, clamped borders)
    against ``jax.image.resize`` at each enlargement the eval makes."""
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax_inception.resize_to_299(jnp.asarray(x)))
    got = inception.resize_to_299(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the border rows and columns, where the two clamp
    np.testing.assert_allclose(got[:, [0, -1]], ref[:, [0, -1]], atol=1e-6)
    np.testing.assert_allclose(got[:, :, [0, -1]], ref[:, :, [0, -1]],
                               atol=1e-6)


def test_inception_init_random_and_carried_forward(tmp_path):
    """The port's ``init_random`` follows JAX's key chain (the first convs
    redrawn here with ``jax.random``); those weights carried into JAX's
    forward give the port's features within 1e-4, at 2 images of 64 px;
    ``load_weights`` reads them back from npz and pickle."""
    params = inception.init_random(0)
    assert sorted(params) == sorted(jax_inception.param_paths())
    key = jax.random.PRNGKey(0)
    for path, cin, cout, kh, kw in jax_inception._conv_defs()[:3]:
        key, k = jax.random.split(key)
        ref = np.asarray(jax.random.normal(k, (kh, kw, cin, cout))
                         / np.sqrt(kh * kw * cin))
        got = params[path]["w"]
        assert (np.abs(got - ref) / np.spacing(np.abs(ref))).max() <= 8
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    feat_j, logits_j = jax_inception.forward(
        jax.tree.map(jnp.asarray, params),
        jax_inception.resize_to_299(jnp.asarray(x)))
    net = inception.InceptionV3.from_params(params, device="cpu")
    with torch.no_grad():
        feat, logits = net(inception.resize_to_299(torch.from_numpy(x)))
    feat_j = np.asarray(feat_j)
    np.testing.assert_allclose(feat.numpy(), feat_j, rtol=0,
                               atol=1e-4 * np.abs(feat_j).max())
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=0, atol=1e-4 * np.abs(feat_j).max())
    # the weight files
    flat = {f"{m}/{leaf}": a for m, d in params.items()
            for leaf, a in d.items()}
    np.savez(tmp_path / "w.npz", **flat)
    import pickle

    with open(tmp_path / "w.pkl", "wb") as f:
        pickle.dump(params, f)
    for name in ("w.npz", "w.pkl"):
        back = inception.load_weights(str(tmp_path / name))
        for m, d in params.items():
            for leaf, a in d.items():
                np.testing.assert_array_equal(back[m][leaf], a)
    # the grayscale input is tiled to RGB
    ext = features.inception_extractor(params, device="cpu")
    f1, _ = ext(x[..., :1], batch=2)
    f3, _ = ext(np.repeat(x[..., :1], 3, axis=-1), batch=2)
    np.testing.assert_array_equal(f1, f3)


def test_convert_torch_state_dict_is_jaxs():
    rng = np.random.default_rng(5)
    sd = {}
    for path, cin, cout, kh, kw in inception._conv_defs():
        sd[f"{path}.conv.weight"] = rng.standard_normal(
            (cout, cin, kh, kw)).astype(np.float32)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{path}.bn.{leaf}"] = rng.standard_normal(cout).astype(
                np.float32)
    sd["fc.weight"] = rng.standard_normal((1008, 2048)).astype(np.float32)
    sd["fc.bias"] = rng.standard_normal(1008).astype(np.float32)
    got = inception.convert_torch_state_dict(sd)
    ref = jax_inception.convert_torch_state_dict(sd)
    assert sorted(got) == sorted(ref)
    for m in ref:
        for leaf in ref[m]:
            np.testing.assert_array_equal(got[m][leaf], ref[m][leaf])
    net = inception.InceptionV3.from_params(got, device="cpu")
    assert net.Mixed_7c.branch_pool.w.shape == (1, 1, 2048, 192)


@pytest.mark.parametrize("preset,over", [
    ("dcgan_cifar10", {}),
    ("cdcgan_celeba64", {"eval.prdc": True}),
], ids=["dcgan_cifar10", "cdcgan_celeba64_prdc"])
def test_evaluate_with_a_carried_generator(preset, over):
    """``evaluate`` of one generator in both packages on the same real
    images: the port's sampled set is JAX's (carried G, "xla"), so FID,
    KID and PRDC agree to the extractors' precision; the real features
    are cached under "passed", and a stream of fewer than 2 is refused."""
    over = {"model.ngf": 8, "model.nz": 12, "eval.fid_n": 24,
            "eval.fid_batch": 10, "train.kernels": "xla", **over}
    cfg, g, params, state, pcfg, tg = twin_generators(preset, over)
    s = cfg.model.image_size
    real = np.random.default_rng(6).integers(0, 256, (30, s, s, 3)).astype(
        np.uint8)
    ref = jax_evaluate(cfg, g, params, state, seed=3,
                       real_images=real)
    cache = port_evaluate._REAL_FEAT_CACHE
    cache.clear()
    got = port_evaluate.evaluate(pcfg, tg, seed=3, real_images=real)
    assert got["n"] == ref["n"] == 24 and got["backend"] == "proxy"
    for k in ("fid", "kid"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
    if pcfg.eval.prdc:
        for k in ("precision", "recall", "density", "coverage"):
            np.testing.assert_allclose(got[k], ref[k], atol=1 / 24,
                                       err_msg=k)
    assert len(cache) == 1 and next(iter(cache._d))[0] == "passed"
    again = port_evaluate.evaluate(pcfg, tg, seed=3, real_images=real)
    assert again["fid"] == got["fid"] and len(cache) == 1
    with pytest.raises(ValueError, match="at least 2"):
        port_evaluate.evaluate(pcfg.override({"eval.fid_n": 1}), tg,
                               real_images=real)


def test_evaluate_keys_the_real_set(tmp_path):
    """The "dataset" key (the config's set loaded), and the "stream" key:
    a streaming folder's features are cached on its fingerprint, so a
    second tick decodes nothing."""
    from tpugan_torch.data.datasets import load_dataset

    over = {"model.ngf": 8, "model.nz": 12, "eval.fid_n": 6,
            "eval.fid_batch": 4, "train.kernels": "xla",
            "data.dataset": "synthetic", "data.synthetic_size": 10}
    *_, pcfg, tg = twin_generators("dcgan_cifar10", over)
    cache = port_evaluate._REAL_FEAT_CACHE
    cache.clear()
    a = port_evaluate.evaluate(pcfg, tg)
    assert next(iter(cache._d))[0] == "dataset"
    root = tmp_path / "img_align_celeba"
    os.makedirs(root)
    rng = np.random.default_rng(7)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (40, 36, 3)).astype(
            np.uint8)).save(root / f"{i:03d}.png")
    st = load_dataset("celeba", str(tmp_path), image_size=32, channels=3,
                      streaming="on")["images"]
    b = port_evaluate.evaluate(pcfg, tg, real_images=st)
    assert st.decoded_count == 6
    c = port_evaluate.evaluate(pcfg, tg, real_images=st)
    assert st.decoded_count == 6 and c["fid"] == b["fid"]
    assert [k[0] for k in cache._d] == ["dataset", "stream"]
    assert a["fid"] != b["fid"]


def test_evaluate_folders_is_jaxs(tmp_path):
    rng = np.random.default_rng(8)
    for side, scale in (("a", 1.0), ("b", 0.5)):
        os.makedirs(tmp_path / side / "sub")
        for i in range(10):
            arr = (rng.integers(0, 256, (36, 30, 3)) * scale).astype(
                np.uint8)
            sub = "sub/" if i % 2 else ""
            Image.fromarray(arr).save(tmp_path / side / f"{sub}{i:02d}.png")
    args = (str(tmp_path / "a"), str(tmp_path / "b"))
    kw = dict(image_size=32, channels=3, n=9, batch=4)
    ref = jax_evaluate_folders(*args, **kw)
    got = port_evaluate.evaluate_folders(*args, **kw, device="cpu")
    assert (got["n_a"], got["n_b"]) == (ref["n_a"], ref["n_b"]) == (9, 9)
    for k in ("fid", "kid"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
    with pytest.raises(ValueError, match=">=2 images"):
        port_evaluate.evaluate_folders(*args, image_size=32, n=1,
                                       device="cpu")
