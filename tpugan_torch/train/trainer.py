"""The public trainer API (port of ``tpugan/train/trainer.py``), on one
device.

``Trainer(cfg).train()`` runs the alternating D/G loop of
``train/steps.py`` over the host input pipeline, logs the losses and the
``images_per_sec`` counter (data images per wall second, between log
points) to ``out_dir/metrics.jsonl`` every ``log_every`` steps, and writes
a fixed-noise sample grid every ``sample_every`` steps through the
``Sampler`` (one launch of megakernel v2 under ``train.kernels="pallas"``).
The host synchronizes only at those points.

``train.fuse_stats`` selects the train-mode DBlock path: "on" runs the
conv + BN-statistics kernel (``ops/cuda_conv_stats.py``) in every DBlock
with BatchNorm (and no spectral norm), "auto" does so on a CUDA device.

A conditional model (``cdcgan``) trains on the dataset's labels, and its
grids take the fixed labels ``Sampler.labels(64, seed)``; a dataset whose
labels are all zero is refused.

Not ported yet (ROADMAP.md, Queue A), and raising here: checkpoints
(``ckpt_every`` must be 0; no final checkpoint is written), ``resume``,
eval (``eval_every``, ``keep_best``), profiling, ``halt_on_nonfinite``,
meshes (``mesh_shape``, ``spatial_shards``, ``fsdp_shards``), and the
step options ``check_supported`` lists.  No signal handler is installed.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tpugan_torch.configs import Config
from tpugan_torch.data.datasets import load_dataset
from tpugan_torch.data.pipeline import make_input_pipeline
from tpugan_torch.models.registry import build_models
from tpugan_torch.sample.sampler import Sampler
from tpugan_torch.train.state import TrainState, create_train_state
from tpugan_torch.train.steps import build_train_step, check_supported
from tpugan_torch.utils.device import resolve_device
from tpugan_torch.utils.images import make_grid, save_png, to_uint8
from tpugan_torch.utils.logging import MetricsLogger

_NOT_PORTED = (
    ("ckpt_every", "Checkpoints"), ("resume", "Checkpoints"),
    ("eval_every", "Eval"), ("keep_best", "Eval"),
    ("profile_steps", "Trainer loop"), ("halt_on_nonfinite", "Checkpoints"),
    ("mesh_shape", "Parallel"), ("spatial_shards", "Parallel"),
    ("fsdp_shards", "Parallel"),
)


class Trainer:
    def __init__(self, cfg: Config, data: Optional[dict] = None,
                 device="cuda"):
        for field, item in _NOT_PORTED:
            if getattr(cfg.train, field):
                raise NotImplementedError(
                    f"train.{field} is not ported yet (ROADMAP.md, Queue A: "
                    f"{item!r}); set it to its off value")
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(cfg.train.seed)
        self.g, self.d = build_models(cfg.model, cfg.train.precision,
                                      fuse_stats=cfg.train.fuse_stats,
                                      device=self.device, generator=gen)
        self.state: TrainState = create_train_state(cfg, self.g, self.d)
        self.step_fn = build_train_step(cfg, self.g, self.d)
        self._data = data  # injected dataset (tests); else loaded lazily

    def _dataset(self) -> dict:
        if self._data is None:
            c = self.cfg
            self._data = load_dataset(
                c.data.dataset,
                image_size=c.model.image_size, channels=c.model.channels,
                synthetic_size=c.data.synthetic_size, seed=c.train.seed,
                n_classes=c.model.n_classes)
        return self._data

    def sampler(self) -> Sampler:
        return Sampler(self.cfg, self.g)

    def train(self, total_steps: Optional[int] = None) -> Dict[str, float]:
        """Train up to step ``total_steps`` (default ``train.total_steps``);
        returns the last logged metrics."""
        cfg = self.cfg
        total_steps = total_steps or cfg.train.total_steps
        out_dir = cfg.train.out_dir
        conditional = cfg.model.arch == "cdcgan"
        data = self._dataset()
        if conditional and cfg.model.n_classes > 1:
            # A conditional model on all-zero labels (the JAX loaders'
            # fallback when a label file is absent) would see every real
            # image as class 0 while its fake labels are uniform.
            lab = data.get("labels")
            lab = np.asarray(lab) if lab is not None else np.empty(0)
            if lab.size and int(lab.max()) == 0:
                raise ValueError(
                    f"conditional training (model.arch='cdcgan', n_classes="
                    f"{cfg.model.n_classes}) but the dataset's labels are "
                    f"all zero: is the label file missing?")
        logger = MetricsLogger(out_dir)
        start_step = self.state.step
        pipeline = make_input_pipeline(
            data, cfg.data.batch_size, seed=cfg.train.seed,
            with_labels=conditional, device=self.device,
            start_step=start_step)
        sampler = self.sampler()
        fixed_z = sampler.noise(64, cfg.train.seed)
        fixed_y = sampler.labels(64, cfg.train.seed)

        last_metrics: Dict[str, float] = {}
        t0 = time.perf_counter()
        imgs_since = 0
        it = iter(pipeline)
        try:
            for i in range(start_step, total_steps):
                self.state, metrics = self.step_fn(self.state, next(it))
                imgs_since += cfg.data.batch_size
                step_no = i + 1
                last = step_no >= total_steps
                if cfg.train.log_every and (
                        step_no % cfg.train.log_every == 0 or last):
                    host = {k: float(v) for k, v in metrics.items()}
                    host["images_per_sec"] = imgs_since / max(
                        time.perf_counter() - t0, 1e-9)
                    logger.log(step_no, host)
                    last_metrics = host
                    t0 = time.perf_counter()
                    imgs_since = 0
                if cfg.train.sample_every and (
                        step_no % cfg.train.sample_every == 0 or last):
                    imgs = sampler.sample_fixed(fixed_z, fixed_y)
                    save_png(os.path.join(out_dir,
                                          f"samples_{step_no:07d}.png"),
                             make_grid(to_uint8(imgs), nrow=8))
                    t0 = time.perf_counter()  # grid D2H + PNG out of img/s
                    imgs_since = 0
        finally:
            it.close()
            logger.close()
        return last_metrics
