"""Feature and class-probability extractors for FID and IS (port of
``tpugan/eval/features.py``).

Two backends behind one interface, ``make_extractor(channels, backend,
weights_path, device)`` -> ``run(images, batch) -> (features, probs)``,
numpy in and out, the network on ``device``:

- ``inception``: InceptionV3's pool3 features (``eval/inception.py``),
  the reference's; weights-gated: ``eval.inception_weights`` names a
  converted weight file, and without one this backend raises.  Grayscale
  is tiled to RGB and every image resized to 299 px.
- ``proxy``: a fixed random-feature CNN, four 3 x 3 stride-2 convs (C ->
  32 -> 64 -> 128 -> 256) with LeakyReLU(0.2) and a global average pool,
  whose weights are the JAX package's draws (threefry ``normal`` on
  ``PRNGKey(20260816)``, within an ulp of XLA's), and a 16-class head fit
  once by 300 full-batch momentum-GD steps of softmax regression on a
  seeded synthetic set, in float32 on the extractor's device.  Relative
  feature distances are what FID needs; the trained head makes proxy-IS
  rank class coverage.  The convs are ``F.conv2d`` (the JAX package runs
  them on ``lax.conv``: a 3 x 3 conv never reaches its Pallas conv).

Extractors are cached (bounded LRU) per (channels, backend, weights,
device), so repeated eval ticks reuse the network and the fitted head.
On a CUDA device the convs run in fp32 unless the caller allows TF32
(``torch.backends.cudnn.allow_tf32``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpugan_torch.data.datasets import make_synthetic
from tpugan_torch.eval import inception
from tpugan_torch.ops.kernel_common import leaky_relu
from tpugan_torch.sample import threefry
from tpugan_torch.utils.cache import BoundedCache
from tpugan_torch.utils.device import resolve_device

_PROXY_SEED = 20260816
_PROXY_DIM = 256
_PROXY_CLASSES = 16  # trained-head classes (synthetic color-phase classes)
_TINY = torch.finfo(torch.float32).tiny  # the least normal float32

Extractor = Callable[..., Tuple[np.ndarray, np.ndarray]]


def proxy_convs(channels: int) -> List[np.ndarray]:
    """The proxy's four conv weights, HWIO float32: (C, 32) -> (32, 64) ->
    (64, 128) -> (128, 256), each ``normal / sqrt(9 cin)`` from the key
    chain ``key, k = split(key)`` on ``PRNGKey(20260816)``."""
    key = threefry.prng_key(_PROXY_SEED)
    chans = [channels, 32, 64, 128, _PROXY_DIM]
    out = []
    for cin, cout in zip(chans[:-1], chans[1:]):
        key, k = threefry.split(key, 2)
        out.append(threefry.normal(k, (3, 3, cin, cout))
                   / np.float32(np.sqrt(9 * cin)))
    return out


def proxy_features(convs: Sequence[torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) images in [-1, 1] -> (N, 256) pooled features; the
    convs are OIHW tensors on ``x``'s device."""
    h = x.permute(0, 3, 1, 2)
    for w in convs:
        h = leaky_relu(F.conv2d(h, w, stride=2, padding=1), 0.2)
    return h.mean(dim=(2, 3))


def _train_proxy_head(convs, channels: int, n: int = 2048,
                      image_size: int = 64, steps: int = 300):
    """Softmax regression of the synthetic class labels on the frozen
    random features: full-batch GD with momentum, the standardization
    folded into the head (logits = f @ w_raw + b on raw pooled features)."""
    dev = convs[0].device
    data = make_synthetic(image_size, channels, n, seed=_PROXY_SEED,
                          n_classes=_PROXY_CLASSES)
    x = torch.from_numpy(data["images"]).to(dev).float() / 127.5 - 1.0
    onehot = F.one_hot(torch.from_numpy(data["labels"]).to(dev).long(),
                       _PROXY_CLASSES).float()
    feats = proxy_features(convs, x)
    mu, sd = feats.mean(0), feats.std(0, unbiased=False) + 1e-6
    fz = (feats - mu) / sd
    w = torch.zeros(_PROXY_DIM, _PROXY_CLASSES, device=dev)
    v = torch.zeros_like(w)
    for _ in range(steps):
        # the gradient of -mean(log_softmax(fz @ w)[y])
        # the softmax's far tails are subnormal floats, below the ulp of
        # any sum here, which the CPU multiplies ~30x slower: zeroed
        prob = torch.softmax(fz @ w, dim=-1)
        prob = torch.where(prob < _TINY, 0.0, prob)
        g = fz.T @ (prob - onehot) / n
        v = 0.9 * v - 0.5 * g
        w = w + v
    return w / sd[:, None], -(mu / sd) @ w


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """A float32 tensor on ``dev`` from an array (copied) or a tensor."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(dev, torch.float32)


def _runner(fn, dev: torch.device, default_batch: int) -> Extractor:
    """numpy float32 images, ``batch`` at a time through ``fn`` on
    ``dev`` -> (features, probs) on the host."""

    @torch.no_grad()
    def run(images: np.ndarray, batch: int = default_batch):
        feats, probs = [], []
        for s in range(0, len(images), batch):
            x = torch.from_numpy(np.ascontiguousarray(
                images[s:s + batch], np.float32)).to(dev)
            f, p = fn(x)
            feats.append(f.cpu().numpy())
            probs.append(p.cpu().numpy())
        return np.concatenate(feats), np.concatenate(probs)

    return run


def proxy_extractor(convs_hwio: Sequence[np.ndarray], head=None,
                    device="cuda") -> Extractor:
    """The proxy extractor from HWIO conv weights and a head ``(w, b)``
    (numpy or tensors), the head fit here when None."""
    dev = resolve_device(device)
    convs = [_tensor(w, dev).permute(3, 2, 0, 1).contiguous()
             for w in convs_hwio]
    if head is None:
        head = _train_proxy_head(convs, convs[0].shape[1])
    head_w, head_b = (_tensor(t, dev) for t in head)

    def extract(x):
        feat = proxy_features(convs, x)
        return feat, torch.softmax(feat @ head_w + head_b, dim=-1)

    return _runner(extract, dev, 256)


def inception_extractor(params, device="cuda") -> Extractor:
    """The InceptionV3 extractor over the JAX-layout ``params``."""
    dev = resolve_device(device)
    net = inception.InceptionV3.from_params(params, device=dev)

    def extract(x):
        if x.shape[-1] == 1:  # grayscale -> RGB, as pytorch-fid does
            x = x.repeat(1, 1, 1, 3)
        feat, logits = net(inception.resize_to_299(x))
        return feat, torch.softmax(logits, dim=-1)

    return _runner(extract, dev, 64)


# InceptionV3's weights are ~100 MB: bound, not leak
_EXTRACTOR_CACHE = BoundedCache(maxsize=4)


def make_extractor(channels: int, backend: str = "proxy",
                   weights_path: str = "", device="cuda") -> Extractor:
    """``f(images float32 in [-1, 1], NHWC, batch) -> (features, probs)``
    on the host, the network on ``device``; cached per (channels, backend,
    weights_path, device)."""
    dev = resolve_device(device)
    key = (channels, backend, weights_path, str(dev))
    fn = _EXTRACTOR_CACHE.get(key)
    if fn is None:
        if backend == "inception":
            if not weights_path:
                raise FileNotFoundError(
                    "InceptionV3 weights are not bundled; set "
                    "eval.inception_weights to a converted weight file "
                    "(eval/inception.py convert_torch_state_dict) or use "
                    "the 'proxy' backend")
            fn = inception_extractor(inception.load_weights(weights_path),
                                     dev)
        elif backend == "proxy":
            fn = proxy_extractor(proxy_convs(channels), device=dev)
        else:
            raise ValueError(f"unknown eval feature backend {backend!r}")
        _EXTRACTOR_CACHE.put(key, fn)
    return fn
