"""End-to-end FID / KID / IS (and PRDC) of a generator (port of
``tpugan/eval/evaluate.py``).

``evaluate(cfg, g, seed=, real_images=)`` generates ``eval.fid_n`` seeded
images through the ``Sampler`` (megakernel v2 under
``train.kernels="pallas"``), extracts features of the generated and the
real set with one extractor (``eval/features.py``) on G's device, and
computes the metrics on the host (``eval/fid.py``).  Real-set features are
cached (bounded LRU) under one of three keys: ``"dataset"`` (the set
loaded from the config), ``"stream"`` (a streaming folder, keyed on its
``fingerprint()`` before anything is decoded, so repeated eval ticks cost
no decode) and ``"passed"`` (an in-RAM array, keyed on a fingerprint of
its bytes).

Under ``train.spatial_shards`` the generation is collective (every rank of
the spatial mesh calls ``evaluate``; ``sample/sampler.py``), and the first
rank alone extracts the features and scores: the others return None.

``evaluate_folders(a, b)`` scores two image folders against each other
(the ``pytorch-fid path_a path_b`` workflow), generator-free.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np
import torch

from tpugan_torch.configs import Config
from tpugan_torch.data.datasets import load_dataset, load_image_folder
from tpugan_torch.eval.features import make_extractor
from tpugan_torch.eval.fid import (fid_from_features, inception_score,
                                   kid_from_features, prdc_from_features)
from tpugan_torch.parallel.multihost import is_main_process
from tpugan_torch.sample.sampler import Sampler
from tpugan_torch.utils.cache import BoundedCache

# each entry is ~fid_n x 2048 floats (~80 MB at the defaults)
_REAL_FEAT_CACHE = BoundedCache(maxsize=4)


def _array_fingerprint(a: np.ndarray) -> tuple:
    """Cheap identity of a real-image set: shape, dtype and the first and
    last 64 KiB."""
    flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    h = hashlib.sha1()
    h.update(repr((a.shape, str(a.dtype))).encode())
    h.update(flat[:65536].tobytes())
    h.update(flat[-65536:].tobytes())
    return (a.shape, h.hexdigest())


def evaluate(cfg: Config, g: torch.nn.Module, *, seed: int = 0,
             real_images=None) -> Optional[Dict[str, float]]:
    """FID, KID and IS (and PRDC under ``eval.prdc``) of generator module
    ``g`` against ``real_images`` (uint8 or [-1, 1] NHWC, or a streaming
    folder; by default the config's dataset), all on ``g``'s device; None
    on a rank other than the first of a spatial mesh (module docstring)."""
    device = next(g.parameters()).device
    n = cfg.eval.fid_n
    bs = cfg.eval.fid_batch

    fake = Sampler(cfg, g).sample(n, seed=seed, batch_size=bs)
    if cfg.train.spatial_shards > 0 and not is_main_process():
        return None
    extractor = make_extractor(cfg.model.channels, cfg.eval.metric,
                               cfg.eval.inception_weights, device=device)
    feat_fake, probs_fake = extractor(fake, batch=bs)

    if real_images is None:
        # everything that changes the real set or the extractor
        key = ("dataset", cfg.data.dataset, cfg.data.data_dir,
               cfg.model.image_size, cfg.model.channels,
               cfg.data.synthetic_size, cfg.train.seed, cfg.model.n_classes,
               cfg.eval.metric, cfg.eval.inception_weights, n, str(device))
        if _REAL_FEAT_CACHE.get(key) is None:
            data = load_dataset(
                cfg.data.dataset, cfg.data.data_dir,
                image_size=cfg.model.image_size, channels=cfg.model.channels,
                synthetic_size=cfg.data.synthetic_size, seed=cfg.train.seed,
                n_classes=cfg.model.n_classes,
                # a streaming folder decodes only the n images sliced below
                streaming=cfg.data.streaming, max_ram_mb=cfg.data.max_ram_mb)
            imgs = data["images"]
            if hasattr(imgs, "gather"):
                imgs = np.asarray(imgs[:n])
            real_images = imgs[:n].astype(np.float32) / 127.5 - 1.0
    elif hasattr(real_images, "fingerprint"):
        # a streaming folder: keyed before anything is decoded
        key = ("stream", real_images.fingerprint(), min(n, len(real_images)),
               cfg.model.channels, cfg.eval.metric,
               cfg.eval.inception_weights, str(device))
        if _REAL_FEAT_CACHE.get(key) is None:
            real_images = np.asarray(
                real_images[:n], np.float32) / 127.5 - 1.0
    else:
        real_images = np.asarray(real_images)[:n]
        key = ("passed", _array_fingerprint(real_images),
               cfg.model.channels, cfg.eval.metric,
               cfg.eval.inception_weights, str(device))
        if _REAL_FEAT_CACHE.get(key) is None:
            real_images = real_images.astype(np.float32)
            if real_images.max() > 1.5:  # uint8-range input
                real_images = real_images / 127.5 - 1.0

    feat_real = _REAL_FEAT_CACHE.get(key)
    if feat_real is None:
        feat_real, _ = extractor(real_images, batch=bs)
        _REAL_FEAT_CACHE.put(key, feat_real)

    if min(len(feat_real), len(feat_fake)) < 2:
        raise ValueError(
            "evaluate() needs at least 2 real and 2 fake samples (got "
            f"{len(feat_real)} real / {len(feat_fake)} fake): FID's "
            "covariance and KID's unbiased estimator are undefined at n<2; "
            "raise eval.fid_n or pass a larger real set")
    fid = fid_from_features(feat_real, feat_fake)
    kid, kid_std = kid_from_features(feat_real, feat_fake)
    is_mean, is_std = inception_score(probs_fake)
    out = {"fid": fid, "kid": kid, "kid_std": kid_std,
           "is_mean": is_mean, "is_std": is_std,
           "n": int(len(fake)), "backend": cfg.eval.metric}
    if cfg.eval.prdc:
        out.update(prdc_from_features(feat_real, feat_fake))
    return out


def evaluate_folders(path_a: str, path_b: str, *, image_size: int = 64,
                     channels: int = 3, metric: str = "proxy",
                     inception_weights: str = "", n: int = 0,
                     batch: int = 256, prdc: bool = False,
                     device="cuda") -> Dict[str, float]:
    """FID and KID between two image folders, each decoded at one geometry
    (``load_image_folder``: center crop, bilinear resize, sorted order, at
    most ``n`` images) and featured by one extractor on ``device``.  No IS:
    neither folder is the generated one."""
    a = load_image_folder(path_a, image_size, channels, limit=n)
    b = load_image_folder(path_b, image_size, channels, limit=n)
    if min(len(a), len(b)) < 2:
        raise ValueError(
            f"evaluate_folders needs >=2 images per side (got {len(a)} in "
            f"{path_a!r}, {len(b)} in {path_b!r})")
    extractor = make_extractor(channels, metric, inception_weights,
                               device=device)
    feat_a, _ = extractor(a.astype(np.float32) / 127.5 - 1.0, batch=batch)
    feat_b, _ = extractor(b.astype(np.float32) / 127.5 - 1.0, batch=batch)
    kid, kid_std = kid_from_features(feat_a, feat_b)
    out = {"fid": fid_from_features(feat_a, feat_b),
           "kid": kid, "kid_std": kid_std,
           "n_a": int(len(a)), "n_b": int(len(b)), "backend": metric}
    if prdc:
        out.update(prdc_from_features(feat_a, feat_b))
    return out
