"""The public trainer API (port of ``tpugan/train/trainer.py``), on one
device.

``Trainer(cfg).train()`` runs the train step of ``train/steps.py`` (K =
``train.steps_per_call`` steps a call) over the host input pipeline, or
over the dataset held on the device (``data.device_resident``: uploaded
once, each step gathers its batch there), and:

- logs the losses and the ``images_per_sec`` counter (data images per wall
  second, between log points) to ``out_dir/metrics.jsonl`` every
  ``log_every`` steps;
- writes a fixed-noise sample grid every ``sample_every`` steps through the
  ``Sampler`` (one launch of megakernel v2 under ``train.kernels="pallas"``),
  from the EMA of G when ``train.ema > 0`` (with G's live BatchNorm
  statistics);
- saves a checkpoint (``ckpt/checkpoint.py``) every ``ckpt_every`` steps
  and at the end; ``train.resume`` (a checkpoint directory or file)
  restores one first, and a fresh run into a directory that holds later
  steps warns;
- under ``halt_on_nonfinite``, saves a checkpoint and raises
  ``NonFiniteLossError`` when a logged metric is NaN or inf;
- on SIGTERM or SIGINT finishes the call in flight, saves a checkpoint and
  returns (a second signal force-quits); the handlers are installed on the
  main thread only, and the old ones are always put back;
- under ``profile_steps`` N, traces calls 2 to N + 1 with ``torch.profiler``
  into ``out_dir/prof/steps_<step>.json.gz``, the program's spans among its
  events, and writes the program's counters of those calls
  (``utils/tracing.py``) beside it, ``steps_<step>.counters.json``;
- every ``eval_every`` steps and at the last step, scores the sampling
  generator with ``eval/evaluate.py`` (FID, KID, IS; logged under the
  ``eval`` prefix, its time kept out of ``images_per_sec``) against the
  run's dataset, passed whole so that a streaming folder's real features
  are cached on its fingerprint; under ``keep_best`` a new best FID saves
  a checkpoint into ``ckpt_dir/best`` (one kept) and the watermark
  ``best/best_fid.json`` (written atomically).  A restored run keeps the
  watermark; a fresh run clears a stale ``best/`` on its first
  ``train()`` only.

Every cadence advances in strides of K (a window fires once whatever K
is).  The host synchronizes only at the log, grid and checkpoint points.

``train.fuse_stats`` selects the train-mode DBlock path: "on" runs the
conv + BN-statistics kernel (``ops/cuda_conv_stats.py``) in every DBlock
with BatchNorm (and no spectral norm), "auto" does so on a CUDA device.

The dataset is ``data.dataset`` read from ``data.data_dir``
(``data/datasets.py``: MNIST, CIFAR-10, CelebA in RAM or streaming, or
synthetic).  A conditional model (``cdcgan``) trains on the dataset's
labels, and its grids take the fixed labels ``Sampler.labels(64, seed)``;
a dataset whose labels are all zero is refused.

Meshes (``parallel/``; one process per rank, in a ``torch.distributed``
process group that the caller started: ``parallel.multihost.spawn``,
``initialize_multihost`` or ``torchrun``), resolved as the JAX trainer
resolves them:

- ``mesh`` (an argument: a ``("data",)`` mesh from ``parallel.make_mesh``)
  or ``mesh_shape`` N: a ``("data",)`` mesh of N ranks (data parallel:
  the batch sharded, the state replicated);
- ``fsdp_shards`` M: a ``("data", "model")`` mesh of (``mesh_shape`` or
  world // M) x M ranks, parameters and moments sharded over ``model``;
- ``spatial_shards`` S alone: a ``("space",)`` mesh of S ranks, feature
  maps H-sharded (``parallel/spatial.py``); with ``mesh_shape`` (or a
  ``mesh`` of N ranks: ``mesh_shape`` N // S) a ``("data", "space")``
  mesh, which supersedes the ``mesh`` passed;
- ``fsdp_shards`` with ``spatial_shards`` raises (both claim the second
  axis).

Asking for more ranks than are running raises.  When more than one rank
shares the work, ``fuse_stats`` is off (the fused kernel's statistics are
one rank's); at one rank it stays as configured.  Every rank computes; the
first writes ``metrics.jsonl``, the grids and the ``keep_best``
watermark, and checkpoints (``ckpt/checkpoint.py``: the first rank writes,
the others wait).  The grids and FID come from the first rank (a whole
copy of G under FSDP, gathered by every rank), from every rank together
under spatial sharding; the scores are the first rank's.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import signal
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpugan_torch.ckpt.checkpoint import (CheckpointManager, atomic_write,
                                          load)
from tpugan_torch.configs import Config
from tpugan_torch.data.datasets import load_dataset
from tpugan_torch.data.pipeline import make_input_pipeline
from tpugan_torch.eval.evaluate import evaluate
from tpugan_torch.models.registry import build_models
from tpugan_torch.parallel import fsdp, multihost, spatial
from tpugan_torch.parallel.mesh import (axis_index, axis_size, in_mesh,
                                        make_mesh, mesh_size,
                                        shard_train_state)
from tpugan_torch.sample.sampler import Sampler
from tpugan_torch.train.state import (TrainState, create_train_state,
                                      sync_ema_buffers)
from tpugan_torch.train.steps import build_train_step
from tpugan_torch.utils import tracing
from tpugan_torch.utils.device import resolve_device
from tpugan_torch.utils.images import make_grid, save_png, to_uint8
from tpugan_torch.utils.logging import MetricsLogger

# calls between two checks for a preemption signal under a mesh (each
# check is an all-reduce and a host sync)
_AGREE_EVERY = 10

# Graceful preemption: on SIGTERM (SIGINT likewise) the trainer finishes
# the call in flight, saves a checkpoint and returns; the run resumes
# exactly through ``train.resume``.  A second signal restores the default
# disposition and re-raises it (force-quit).
_PREEMPTED = threading.Event()


class NonFiniteLossError(RuntimeError):
    """Raised (with a checkpoint already saved) when train.halt_on_nonfinite
    is set and a logged metric goes NaN/inf: the GAN diverged."""


def _on_preempt(signum, frame):
    if _PREEMPTED.is_set():  # second signal: give up gracefulness
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)
    _PREEMPTED.set()


def _arm_preemption():
    """Install the graceful handlers; returns the previous handlers (to put
    back when training ends), or None off the main thread."""
    if threading.current_thread() is not threading.main_thread():
        return None
    _PREEMPTED.clear()
    return {s: signal.signal(s, _on_preempt)
            for s in (signal.SIGTERM, signal.SIGINT)}


def _disarm_preemption(prev) -> None:
    for s, h in (prev or {}).items():
        signal.signal(s, h)


class _NullLogger:
    """The metrics sink of every rank but the first."""

    def log(self, *a, **k):
        pass

    def close(self):
        pass


class Trainer:
    def __init__(self, cfg: Config, data: Optional[dict] = None,
                 device="cuda", mesh=None):
        # validation first, before any process-wide side effect
        if cfg.train.fsdp_shards > 0 and cfg.train.spatial_shards > 0:
            raise ValueError(
                "train.fsdp_shards and train.spatial_shards both claim "
                "the second mesh axis; choose one")
        k = cfg.train.steps_per_call
        if k > 1 and cfg.train.total_steps % k:
            # K steps a call: a partial last call would overshoot
            # total_steps by up to k - 1 updates
            raise ValueError(
                f"train.total_steps={cfg.train.total_steps} is not a "
                f"multiple of train.steps_per_call={k}; each call advances "
                f"k steps, so the run would overshoot: round total_steps or "
                f"change steps_per_call")
        if (cfg.data.sampling == "epoch"
                and (cfg.train.total_steps + 1) * cfg.data.batch_size
                >= 2 ** 31):
            # the port's positions are int64, but the two packages refuse
            # the same configs (the JAX step's are int32)
            raise ValueError(
                f"sampling='epoch' computes run positions as step*batch_size "
                f"in int32 in the JAX package; total_steps="
                f"{cfg.train.total_steps} x batch_size={cfg.data.batch_size} "
                f"overflows 2^31: use sampling='replacement' for runs this "
                f"long")
        self.cfg = cfg
        self.device = (multihost.rank_device(device) if multihost.world_size()
                       > 1 else resolve_device(device))
        self.mesh, self.spatial_mesh = self._resolve_mesh(mesh)
        placed = self.mesh or self.spatial_mesh
        if placed is not None and not in_mesh(placed):
            raise ValueError(
                f"rank {multihost.process_index()} is not in the "
                f"{placed.size()}-rank mesh: run as many ranks as the mesh "
                f"needs")
        # the fused BN-statistics kernel sees one rank's batch
        shared = (mesh_size(self.mesh) > 1
                  or mesh_size(self.spatial_mesh) > 1)
        self._fuse_mode = "off" if shared else cfg.train.fuse_stats
        gen = torch.Generator().manual_seed(cfg.train.seed)
        self.g, self.d = build_models(cfg.model, cfg.train.precision,
                                      fuse_stats=self._fuse_mode,
                                      device=self.device, generator=gen)
        self.state: TrainState = create_train_state(cfg, self.g, self.d)
        self._place_state()
        self.step_fn = build_train_step(cfg, self.g, self.d, mesh=self.mesh)
        self._data = data  # injected dataset (tests); else loaded lazily
        self._restored = False  # set by restore(): keeps the watermark
        self._best_cleared = False  # the first fresh train() clears best/
        self._best_fid = float("inf")

    def _resolve_mesh(self, mesh):
        """(the step's mesh, the spatial mesh), as the JAX trainer resolves
        them with ``mesh`` passed (module docstring); (None, None) on one
        rank."""
        t = self.cfg.train
        dev = self.device.type
        world = multihost.world_size()
        if t.spatial_shards > 0:
            n_space = t.spatial_shards
            n_data = t.mesh_shape or (mesh.size() // n_space
                                      if mesh is not None else 0)
            if n_data:
                m = spatial.make_mesh_dp_spatial(n_data, n_space, dev)
                return m, m
            if world < n_space:
                raise ValueError(
                    f"train.spatial_shards={n_space} but only {world} "
                    f"rank(s) are running: refusing a silently smaller mesh "
                    f"(the per-shard extent and memory would double)")
            if n_space == 1 and world == 1:
                return None, None
            from tpugan_torch.parallel.mesh import build_mesh

            return None, build_mesh((n_space,), ("space",), dev)
        if t.fsdp_shards > 0:
            n_model = t.fsdp_shards
            n_data = t.mesh_shape or max(world // n_model, 1)
            if n_data * n_model == 1 and world == 1:
                return None, None
            return fsdp.make_mesh_2d(n_data, n_model, dev), None
        if mesh is not None:
            return mesh, None
        if t.mesh_shape and (t.mesh_shape > 1 or dist.is_initialized()):
            # (a one-rank group too: its collectives run)
            return make_mesh(t.mesh_shape, dev), None
        return None, None

    def _place_state(self) -> None:
        """Replicate the state over the mesh (FSDP: shard it)."""
        mesh = self.mesh or self.spatial_mesh
        if mesh is None:
            return
        if self.cfg.train.fsdp_shards > 0:
            fsdp.shard_train_state_fsdp(self.state, mesh)
        else:
            shard_train_state(self.state, mesh)

    @property
    def is_main(self) -> bool:
        return multihost.is_main_process()

    def _dataset(self) -> dict:
        if self._data is None:
            c = self.cfg
            self._data = load_dataset(
                c.data.dataset, c.data.data_dir,
                image_size=c.model.image_size, channels=c.model.channels,
                synthetic_size=c.data.synthetic_size, seed=c.train.seed,
                n_classes=c.model.n_classes, streaming=c.data.streaming,
                max_ram_mb=c.data.max_ram_mb)
        return self._data

    def _gen_module(self) -> torch.nn.Module:
        """The generator that samples: the EMA of G when it is kept (with
        G's live buffers copied in), else G; under FSDP a whole copy of it
        (every rank must call)."""
        g = self.state.g
        if self.state.g_ema is not None:
            sync_ema_buffers(self.state)
            g = self.state.g_ema
        return fsdp.dense_copy(g) if self.state.fsdp else g

    def _on_all_ranks(self) -> bool:
        """Whether generation is collective: spatial sharding runs one
        forward over every rank; otherwise the first rank generates."""
        return self.spatial_mesh is not None

    def sampler(self) -> Sampler:
        return Sampler(self.cfg, self._gen_module())

    def evaluate(self, seed: int = 0) -> Dict[str, float]:
        """FID, KID and IS of the sampling generator (the EMA of G when it
        is kept) against the run's dataset, on this trainer's device; under
        a mesh every rank calls it and gets the first rank's scores."""
        g = self._gen_module()
        scores = None
        if self.is_main or self._on_all_ranks():
            with self._spatial():
                scores = evaluate(self.cfg, g, seed=seed,
                                  real_images=self._dataset()["images"])
        if dist.is_initialized():
            box = [scores]
            dist.broadcast_object_list(box, src=0)
            scores = box[0]
        return scores

    def _grid(self, fixed_z, fixed_y) -> Optional[np.ndarray]:
        """The fixed-noise grid's images on the first rank (None on the
        others)."""
        g = self._gen_module()
        if not (self.is_main or self._on_all_ranks()):
            return None
        with self._spatial():
            imgs = Sampler(self.cfg, g).sample_fixed(fixed_z, fixed_y)
        return imgs if self.is_main else None

    def _spatial(self):
        """The spatial context of this trainer's mesh (a no-op without)."""
        if self.spatial_mesh is None:
            return contextlib.nullcontext()
        return spatial.spatial_ctx(self.spatial_mesh)

    # -- keep_best watermark ------------------------------------------------
    def _best_dir(self) -> str:
        return os.path.join(self.cfg.train.ckpt_dir, "best")

    def _load_best_meta(self) -> Optional[dict]:
        """The banked keep_best watermark as {'fid', 'step'}, or None."""
        try:
            with open(os.path.join(self._best_dir(), "best_fid.json")) as f:
                meta = json.load(f)
            return {"fid": float(meta["fid"]), "step": int(meta["step"])}
        except (FileNotFoundError, KeyError, ValueError, TypeError):
            return None

    def _save_best_watermark(self, step: int, fid: float) -> None:
        if not self.is_main:
            return

        def write(path):
            with open(path, "w") as f:
                json.dump({"fid": float(fid), "step": int(step)}, f)

        os.makedirs(self._best_dir(), exist_ok=True)
        atomic_write(os.path.join(self._best_dir(), "best_fid.json"), write)

    def _arm_keep_best(self) -> None:
        """A restored run keeps the banked watermark; a fresh run owns
        ``best/`` and clears a previous run's on its first train() (later
        calls share the in-memory watermark)."""
        if self._restored:
            meta = self._load_best_meta()
            if meta is not None:
                self._best_fid = min(self._best_fid, meta["fid"])
        elif (not self._best_cleared and self.is_main
              and os.path.isdir(self._best_dir())):
            print(f"warning: clearing stale best slot {self._best_dir()} "
                  f"from a previous run (a fresh run owns ckpt_dir/best; "
                  f"resume the old run to keep it)")
            shutil.rmtree(self._best_dir())
        self._best_cleared = True

    # -- checkpoints --------------------------------------------------------
    def save_checkpoint(self, ckpt: CheckpointManager) -> None:
        ckpt.save(self.state.step, self.state.state_dict(),
                  self.cfg.to_json())

    def restore(self, path: str, step: Optional[int] = None) -> int:
        """Restore the checkpoint file ``path``, or step ``step`` (default:
        the latest) of the checkpoint directory ``path``, onto this
        trainer's device; returns the restored step."""
        if os.path.isfile(path):
            sd = load(path, map_location=self.device)
        else:
            sd = CheckpointManager(path).restore(step,
                                                 map_location=self.device)
        self.state.load_state_dict(sd)
        self._restored = True
        return self.state.step

    # -- training -----------------------------------------------------------
    def _batches(self, data: dict):
        """The step's input: the dataset uploaded to the device once (one
        dict, every call), or the host pipeline from the state's step."""
        cfg = self.cfg
        conditional = cfg.model.arch == "cdcgan"
        if cfg.data.device_resident:
            if hasattr(data["images"], "gather"):
                raise ValueError(
                    "data.device_resident requires the decoded dataset in "
                    "memory; this dataset is streaming: set "
                    "data.streaming='off' or drop device_resident")
            resident = {"dataset_images": torch.from_numpy(
                np.ascontiguousarray(data["images"])).to(self.device)}
            if conditional:
                resident["dataset_labels"] = torch.from_numpy(
                    np.asarray(data["labels"])).to(self.device)
            return itertools.repeat(resident)
        n_data = axis_size(self.mesh, "data")
        rows = None if n_data == 1 else multihost.local_rows(
            cfg.data.batch_size, n_data, axis_index(self.mesh, "data"),
            cfg.train.grad_accum)
        return make_input_pipeline(
            data, cfg.data.batch_size, seed=cfg.train.seed,
            with_labels=conditional, device=self.device,
            start_step=self.state.step,
            stack=max(cfg.train.steps_per_call, 1), rows=rows)

    def _preempted(self, call: int) -> bool:
        """A SIGTERM / SIGINT seen: under a mesh, by any rank, checked every
        ``_AGREE_EVERY`` calls (one all-reduce), so that all ranks stop at
        the same step."""
        flag = _PREEMPTED.is_set()
        if mesh_size(self.mesh or self.spatial_mesh) > 1:
            if call % _AGREE_EVERY:
                return False
            t = torch.tensor([float(flag)], device=self.device)
            dist.all_reduce(t)
            flag = bool(t.item())
        return flag

    def _stop_profiler(self, prof, path: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path.replace(".json.gz", ".counters.json"), "w") as f:
            json.dump(tracing.counters(), f, indent=1, sort_keys=True)

    def train(self, total_steps: Optional[int] = None) -> Dict[str, float]:
        """Train up to step ``total_steps`` (default ``train.total_steps``);
        returns the last logged metrics."""
        cfg = self.cfg
        t = cfg.train
        total_steps = total_steps or t.total_steps
        out_dir = t.out_dir
        os.makedirs(out_dir, exist_ok=True)
        ckpt = CheckpointManager(t.ckpt_dir)
        if t.resume:
            start = self.restore(t.resume)
            if self.is_main:
                print(f"resumed from step {start}")
        elif not self._restored:
            prev = ckpt.latest_step()
            if prev is not None and prev > self.state.step and self.is_main:
                # the old run's higher steps would win latest_step() on a
                # later resume
                print(f"warning: {t.ckpt_dir} already holds step {prev} from "
                      f"a previous run; this fresh run starts at "
                      f"{self.state.step}: pass train.resume to continue the "
                      f"old run, or use a fresh ckpt_dir to avoid mixed "
                      f"checkpoints")
        data = self._dataset()
        if cfg.model.arch == "cdcgan" and cfg.model.n_classes > 1:
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
        logger = MetricsLogger(out_dir) if self.is_main else _NullLogger()
        k = max(t.steps_per_call, 1)
        bsz = cfg.data.batch_size
        it = iter(self._batches(data))
        sampler = Sampler(cfg, self.g)
        fixed_z = sampler.noise(64, t.seed)
        fixed_y = sampler.labels(64, t.seed)

        if t.keep_best:
            self._arm_keep_best()
        best_ckpt = None

        last_metrics: Dict[str, float] = {}
        t0 = time.perf_counter()
        imgs_since = 0
        prof, prof_path = None, ""
        start_step = self.state.step
        prev_handlers = _arm_preemption()
        preempted = False
        if self.spatial_mesh is not None:
            # (re-)installed for this run and cleared in the finally below,
            # so that it cannot leak into other trainers in this process
            spatial.set_spatial_mesh(self.spatial_mesh)
        try:
            for i in range(start_step, total_steps, k):
                if prev_handlers is not None and self._preempted(
                        (i - start_step) // k):
                    preempted = True
                    break
                # the profiler's window: calls 2 .. 1 + profile_steps
                if t.profile_steps:
                    if i == start_step + k and prof is None:
                        acts = [torch.profiler.ProfilerActivity.CPU]
                        if self.device.type == "cuda":
                            acts.append(torch.profiler.ProfilerActivity.CUDA)
                        prof = torch.profiler.profile(activities=acts)
                        tracing.reset()
                        prof.start()
                        prof_path = os.path.join(
                            out_dir, "prof", f"steps_{i + 1:07d}.json.gz")
                    elif prof is not None and i >= start_step + k * (
                            1 + t.profile_steps):
                        self._stop_profiler(prof, prof_path)
                        prof = None
                self.state, metrics = self.step_fn(self.state, next(it))
                imgs_since += bsz * k
                step_no = i + k
                last = step_no >= total_steps
                if t.log_every and (step_no % t.log_every < k or last):
                    host = {key: float(v) for key, v in metrics.items()}
                    host["images_per_sec"] = imgs_since / max(
                        time.perf_counter() - t0, 1e-9)
                    logger.log(step_no, host)
                    last_metrics = host
                    bad = [key for key, v in host.items()
                           if not np.isfinite(v)]
                    if t.halt_on_nonfinite and bad:
                        self.save_checkpoint(ckpt)
                        if prof is not None:
                            self._stop_profiler(prof, prof_path)
                            prof = None
                        raise NonFiniteLossError(
                            f"non-finite metrics {bad} at step {step_no}; "
                            f"checkpoint saved to {t.ckpt_dir}")
                    t0 = time.perf_counter()
                    imgs_since = 0
                if t.sample_every and (step_no % t.sample_every < k or last):
                    imgs = self._grid(fixed_z, fixed_y)
                    if imgs is not None:
                        save_png(os.path.join(out_dir,
                                              f"samples_{step_no:07d}.png"),
                                 make_grid(to_uint8(imgs), nrow=8))
                    t0 = time.perf_counter()  # grid D2H + PNG out of img/s
                    imgs_since = 0
                if t.eval_every and (step_no % t.eval_every < k or last):
                    scores = self.evaluate(seed=t.seed)
                    logger.log(step_no, {key: v for key, v in scores.items()
                                         if isinstance(v, (int, float))},
                               prefix="eval")
                    if t.keep_best and scores["fid"] < self._best_fid:
                        # the best-FID weights, beside the latest: 'best'
                        # is the deploy point, the latest the resume point
                        self._best_fid = scores["fid"]
                        if best_ckpt is None:
                            best_ckpt = CheckpointManager(self._best_dir(),
                                                          max_to_keep=1)
                        self.save_checkpoint(best_ckpt)
                        self._save_best_watermark(step_no, scores["fid"])
                        logger.log(step_no, {"best_fid": scores["fid"]},
                                   prefix="eval")
                    t0 = time.perf_counter()  # eval out of images_per_sec
                    imgs_since = 0
                if t.ckpt_every and step_no % t.ckpt_every < k:
                    self.save_checkpoint(ckpt)
            if prof is not None:
                self._stop_profiler(prof, prof_path)
                prof = None
            self.save_checkpoint(ckpt)
            if preempted and self.is_main:
                print(f"preempted at step {self.state.step}: checkpoint "
                      f"saved to {t.ckpt_dir}; rerun with train.resume="
                      f"{t.ckpt_dir!r} to continue")
            return last_metrics
        finally:
            # always put the process's signal handlers back: a swallowed
            # SIGTERM after training would leave the process unkillable
            # gracefully
            _disarm_preemption(prev_handlers)
            if self.spatial_mesh is not None:
                spatial.set_spatial_mesh(None)
            if prof is not None:
                prof.stop()
            getattr(it, "close", lambda: None)()
            ckpt.close()
            logger.close()
