"""Deployment export: a trained generator as a self-contained artifact
(port of ``tpugan/export/exporter.py``).

The generator's eval-mode forward (BatchNorm running statistics, the image
cast to float32) is traced once with ``torch.export``, with a symbolic batch
dimension unless a fixed batch is asked for, and saved with
``torch.export.save``.  The weights travel inside the program (its state
dict), so a serving host needs only ``torch`` and this loader: no model
code, no checkpoint.  The artifact keeps the live Sampler's seeded-noise
contract: ``ExportedGenerator.sample(n, seed)`` gives the same latents for
the same seed.

Under ``train.kernels="pallas"`` the trace runs the fused eval path, so each
GBlock is one node of the registered op ``tpugan_torch::convt_affine_act``
(kernel 1; four in ``dcgan_celeba64``): on the card it launches the CUDA
kernel, on the CPU it runs the kernel's plain version.  Loading such a
program needs only ``torch`` and ``tpugan_torch.ops.cuda_convt``, which
registers the op; this module imports it.  Under "xla" the program is
PyTorch's own ops.

The program is traced on the generator's device and saved with its weights
on the CPU: the forward builds no tensor on a named device, so
``load_generator(..., device=)`` moves it to any device ``platforms`` lists
(``torch.export.passes.move_to_device_pass``).

Artifact layout (zip), ``generator.tpugan`` by default:
  generator.pt2   ``torch.export.save`` of the eval-mode forward
  meta.json       the JAX package's keys (nz / image_size / channels /
                  n_classes / batch / platforms / format version / config),
                  with ``torch_version`` for its ``jax_version`` and
                  ``"runtime": "torch"``
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from tpugan_torch.configs import Config
from tpugan_torch.ops import convs
from tpugan_torch.ops import cuda_convt  # noqa: F401  (registers the op)
from tpugan_torch.sample.sampler import seeded_labels, seeded_noise
from tpugan_torch.utils.device import resolve_device

FORMAT_VERSION = 1
_EXPORT_NAME = "generator.pt2"
_JAX_EXPORT_NAME = "generator.jaxexport"
_META_NAME = "meta.json"
PLATFORMS = ("cpu", "cuda")


class _Forward(nn.Module):
    """The eval-mode generator, image in float32: (z) -> img."""

    def __init__(self, g: nn.Module):
        super().__init__()
        self.g = g

    def forward(self, z):
        return self.g(z).float()


class _CondForward(_Forward):
    """The conditional one: (z, y) -> img."""

    def forward(self, z, y):
        return self.g(z, y).float()


def export_generator(cfg: Config, g: nn.Module,
                     batch: Optional[int] = None,
                     platforms: Sequence[str] = PLATFORMS) -> bytes:
    """Serialize the eval-mode generator ``g`` to an artifact (bytes).

    ``batch=None`` exports with a symbolic batch dimension: one artifact
    serves any request size.  ``platforms`` lists the device types the
    artifact may be loaded on; the op has both a CPU and a CUDA
    implementation, so the program is the same for either.
    """
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms must be a non-empty subset of "
                         f"{PLATFORMS}, got {platforms}")
    conditional = cfg.model.arch == "cdcgan"
    dev = next(g.parameters()).device
    # an example batch of 2: torch.export specializes sizes 0 and 1
    n = int(batch) if batch else 2
    z = torch.zeros((n, cfg.model.nz), dtype=torch.float32, device=dev)
    args = (z, torch.zeros((n,), dtype=torch.int64, device=dev)) \
        if conditional else (z,)
    dynamic = None
    if not batch:
        b = torch.export.Dim("b", min=1)
        dynamic = tuple({0: b} for _ in args)
    fwd = (_CondForward if conditional else _Forward)(g)
    was_training = g.training
    g.eval()
    try:
        with torch.no_grad(), convs.using_impl(cfg.train.kernels):
            program = torch.export.export(fwd, args, dynamic_shapes=dynamic)
    finally:
        g.train(was_training)
    program = move_to_device_pass(program, "cpu")
    meta = {
        "format_version": FORMAT_VERSION,
        "runtime": "torch",
        "torch_version": torch.__version__,
        "conditional": conditional,
        "nz": cfg.model.nz,
        "image_size": cfg.model.image_size,
        "channels": cfg.model.channels,
        "n_classes": cfg.model.n_classes,
        "batch": batch,
        "platforms": list(platforms),
        "kernels": cfg.train.kernels,
        "config": json.loads(cfg.to_json()),
    }
    pt2 = io.BytesIO()
    torch.export.save(program, pt2)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_EXPORT_NAME, pt2.getvalue())
        zf.writestr(_META_NAME, json.dumps(meta, indent=1))
    return buf.getvalue()


def save_generator(path: str, cfg: Config, g: nn.Module,
                   batch: Optional[int] = None,
                   platforms: Sequence[str] = PLATFORMS) -> None:
    blob = export_generator(cfg, g, batch=batch, platforms=platforms)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


class ExportedGenerator:
    """A loaded artifact with the live Sampler's generation surface (and
    the surface ``BatchingEngine`` serves).

    ``generate(z[, y])`` runs the exported program on its device;
    ``sample(n, seed)`` reproduces the Sampler's latents for the same seed.
    """

    def __init__(self, program, meta: dict, device: torch.device):
        self._module = program.module()
        self.meta = meta
        self.device = device
        self.conditional = bool(meta["conditional"])
        self.nz = int(meta["nz"])
        self.n_classes = int(meta["n_classes"])
        self.image_size = int(meta["image_size"])
        self.channels = int(meta["channels"])
        self.fixed_batch = meta.get("batch")

    @torch.no_grad()
    def _call(self, z: torch.Tensor, y: Optional[torch.Tensor]) -> np.ndarray:
        out = self._module(z, y) if self.conditional else self._module(z)
        return out.cpu().numpy()

    def generate(self, z, y=None) -> np.ndarray:
        """Run explicit latents through the artifact, any batch size.

        A fixed-batch artifact takes exactly one shape, so the inputs are
        chunked to ``fixed_batch``, the tail zero-padded and sliced back:
        callers (the serving ``BatchingEngine`` included) need not know which
        kind of artifact they hold.
        """
        if self.conditional and y is None:
            raise ValueError("conditional artifact needs labels y")
        if not self.conditional and y is not None:
            raise ValueError("unconditional artifact: labels not accepted")
        z = torch.as_tensor(np.array(z, np.float32), device=self.device)
        if y is not None:
            y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        fb = self.fixed_batch
        if not fb:
            return self._call(z, y)
        n = z.shape[0]
        outs = []
        for start in range(0, n, fb):
            m = min(fb, n - start)
            zc = z[start:start + m]
            yc = None if y is None else y[start:start + m]
            if m < fb:
                zc = torch.cat([zc, zc.new_zeros((fb - m, self.nz))])
                if yc is not None:
                    yc = torch.cat([yc, yc.new_zeros((fb - m,))])
            outs.append(self._call(zc, yc)[:m])
        return np.concatenate(outs, axis=0)

    def sample(self, n: int, seed: int = 0, labels=None,
               batch_size: int = 0) -> np.ndarray:
        bs = batch_size or self.fixed_batch or n
        outs = []
        for start in range(0, n, bs):
            m = min(bs, n - start)
            z = seeded_noise(self.nz, m, seed, offset=start)
            y = None
            if self.conditional:
                y = (np.asarray(labels[start:start + m]) if labels is not None
                     else seeded_labels(self.n_classes, m, seed,
                                        offset=start))
            outs.append(self.generate(z, y))
        return np.concatenate(outs, axis=0)


def load_generator(path_or_bytes, device="cuda") -> ExportedGenerator:
    """An artifact from a path or its bytes, its program moved to
    ``device``, which must be one of the artifact's ``platforms``.  A JAX
    artifact (``generator.jaxexport``) and an unknown ``format_version``
    are refused."""
    dev = resolve_device(device)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = io.BytesIO(path_or_bytes)
    else:
        buf = open(path_or_bytes, "rb")
    try:
        with zipfile.ZipFile(buf) as zf:
            names = zf.namelist()
            if _JAX_EXPORT_NAME in names:
                raise ValueError(
                    f"this is a JAX artifact ({_JAX_EXPORT_NAME}, written by "
                    f"tpugan's export); load it with tpugan.export, or export "
                    f"the checkpoint again with tpugan_torch")
            meta = json.loads(zf.read(_META_NAME))
            if meta.get("format_version") != FORMAT_VERSION:
                raise ValueError(
                    f"unsupported artifact format {meta.get('format_version')}"
                    f" (loader supports {FORMAT_VERSION})")
            if dev.type not in meta["platforms"]:
                raise ValueError(
                    f"the artifact was exported for {meta['platforms']}, not "
                    f"{dev.type!r}")
            program = torch.export.load(io.BytesIO(zf.read(_EXPORT_NAME)))
    finally:
        buf.close()
    return ExportedGenerator(move_to_device_pass(program, dev), meta, dev)
