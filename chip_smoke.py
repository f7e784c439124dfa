#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``tpugan_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (no exception is caught):

1. build the CUDA kernels of ``tpugan_torch/csrc`` (one nvcc per source, in
   parallel) and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, in bf16, with the tolerance stated, and time kernel,
   plain version and (where one exists) one PyTorch library call of the
   same function: ``ms``/``library_ms`` by CUDA events around eager calls,
   host launch overhead included, and ``device_ms``/``library_device_ms``
   the same calls replayed as a CUDA graph, the device's time alone; each
   layer's rate and share of its bound on both measures, the conv +
   BN-statistics kernel's depth split against its alternatives, and where
   a megakernel launch's device time goes, layer by layer, from its
   blocks' clocks; v1's image must be v2's rounded to bf16, bit for bit;
   v2 also at 128 px, conditional at 64 px and at 32 px (the
   ``sngan_cifar10`` generator's grid); kernel 4 also at the new paths'
   shapes: the conditional D's first layer (Cin 4, the narrow path) and the
   spectrally normalized 32 px D's three layers on W / sigma; kernel 5 also
   at batches 256 and 64 (the flagship's, a ``grad_accum=2`` microbatch's),
   v2 also at a Trainer grid's 64 images; and the threefry kernel's three
   draws of a batch-1024 flagship step (indices, hflip bits, z_d) against
   ``sample/threefry.py``: randint and bernoulli bit for bit, normal within
   3 ulps, timed beside the host's draw with its copy to the card;
3. drive the main path at full width (``dcgan_celeba64``: nz=100, ngf=64,
   random weights from a seeded ``torch.Generator``, BN running stats from a
   few train-mode forwards): ``Sampler.sample(256)`` under
   ``train.kernels="pallas"`` against the per-layer-kernel module path, the
   v1 megakernel and the PyTorch-ops module path, plus determinism;
4. serve it: ``BatchingEngine`` + ``make_server`` on 127.0.0.1, concurrent
   ``POST /sample`` (png and npy) and ``GET /healthz``; npy pixels must equal
   ``Sampler.sample`` for the same seed; then, once the serving path's
   launches are counted, warm serving by CUDA events, split into each part
   of ``Sampler.sample`` (noise draw, copy in, fold and operands, the v2
   launch, depth-to-space, copy back, concatenation), beside the per-layer
   module path's forward;
5. train: ``Trainer`` on full-width ``dcgan_celeba64`` (batch 128, the
   synthetic dataset, ``fuse_stats="on"``, ``kernels="pallas"``): step 1's
   losses against a ``fuse_stats="off"`` run from the same seed, then
   timed steps of both, in turns, exactly 9 conv + BN-stats launches per
   step (3 BN blocks x 3 train-mode D forwards), finite losses, and a
   ``torch.profiler`` window: device time by kernel and the device's busy
   share of a step;
6. score a real and a generated batch with the trained D in eval mode under
   ``set_default_impl("pallas")`` (one fused conv kernel per block) against
   the "xla" impl;
7. SNGAN: ``Trainer`` on full-width ``sngan_cifar10`` (32 px, batch 128,
   hinge loss, spectral norm in D): finite losses, every spectral-norm
   ``u`` moved (the tail's one-entry ``u`` stays +-1) and unit-norm, ms per
   step, a grid from megakernel v2; then the trained D in eval mode under
   "pallas" (3 kernel-4 launches a forward, on W / sigma) against "xla",
   with every ``u`` bit for bit unchanged;
8. WGAN-GP: ``Trainer`` on full-width ``wgan_gp_cifar10`` for 2 x n_critic
   steps (and timed steps) with ``set_default_impl("pallas")`` for the
   whole run: no kernel-4 launch in the train steps (the penalty's D runs
   on PyTorch's ops), ``gp`` finite and > 0 at every step, ``loss_g``
   logged on the G steps only;
9. conditional: ``Trainer`` on full-width ``cdcgan_celeba64`` with
   fuse_stats on and off from one seed (step 1's losses within phase 5's
   bound; ms per step in turns), 9 conv + BN-stats launches a step, a
   conditional grid from v2; then the eval-mode D under "pallas" (4
   kernel-4 launches a forward, the first on the narrow path: the image and
   its label plane, Cin 4) against "xla";
10. the flagship: ``Trainer`` on full-width ``dcgan_celeba64_fast``
   (FusedProp, 50 steps a call, the synthetic dataset of 20 x 256 images
   resident on the card, batch 256, ``fuse_stats="on"``) for two calls,
   a checkpoint after each and the second profiled into ``out_dir/prof``:
   exactly 6 conv + BN-stats launches a step (3 BN blocks x 2 D forwards)
   and 3 threefry launches (the indices, the hflip bits and z_d),
   the host pipeline never built, finite losses; ms per step and images/s
   by CUDA events, the device's busy share and kernels a step under the
   profiler; one FusedProp step's D against one alternating step's from one
   seed, batch and ``z_d``;
11. state and resume: full-width ``dcgan_celeba64`` (batch 128) with
   ``ema=0.999`` and a linear LR over 10 steps, a checkpoint every 5 (cuDNN
   deterministic): the step-10 checkpoint restores bit for bit, a run
   resumed from step 5 ends bit for bit where the uninterrupted one did
   (key, step, LRs exact), grids from ``g_ema`` and from G through v2
   differ, a NaN in one D weight raises ``NonFiniteLossError`` with a
   checkpoint at that step, a SIGTERM sent mid-run from a thread saves and
   returns and ``resume`` continues, and the card's checkpoint restores
   into a CPU ``Trainer`` bit for bit;
12. ``grad_accum=2`` (18 conv + BN-stats launches a step) and ``remat`` (9
   + 9 recomputed; step 1 against the plain step within phase 5's bound;
   each one's peak device memory) on full-width ``dcgan_celeba64``;
13. data: MNIST idx (gz), CIFAR-10 pickle batches and a CelebA-layout
   folder of 2,048 PNGs at 178 x 218 with ``list_attr_celeba.txt`` (its
   Male column the labels), written from the synthetic set under
   ``runs/smoke/data`` and read back through the port's readers: MNIST and
   CIFAR-10 bit for bit, MNIST also at 64 px x 3 channels, the folder's
   crop and resize against PIL's, in RAM and streaming bit for bit
   (``decoded_count`` counts the images drawn), the C++ gather with flips
   against numpy at batch 128; host ms per batch of the streaming decode
   and of both gathers;
14. the small-data path: ``Trainer`` on full-width ``cdcgan_celeba64``
   from that folder (batch 128, hflip, kernels "pallas", fuse_stats on,
   ``augment="color,translation,cutout"``, ADA at target 0.6 with
   ``ada_kimg=10``, proxy FID of 2,048 samples every 10 steps with
   ``keep_best``), 20 steps streaming and 20 in RAM: 9 kernel-5 launches
   a step, 8 v2 launches a FID tick and one a grid, finite losses and
   FIDs, ``ada_p`` following its rule and moving off 0, ``best/`` and its
   watermark; the in-RAM run resumed from step 10 (cuDNN deterministic)
   ends bit for bit where it did (key, step, ADA's p and r_t, parameters,
   moments, watermark); ms per step with augment + ADA against the same
   step without, in turns, and a profiled window; ``evaluate()``'s time
   by part (v2 sampling, features, host FID / KID / IS);
14b. the proxy extractor and InceptionV3 (``init_random`` weights, 64
   images at 64 px resized to 299) on the card against the CPU, and
   ``apply_policy`` on the card against the CPU (fp32 and bf16), with ms
   per batch;
15. the CLI and the exported generator, full-width ``dcgan_celeba64``
   through ``tpugan_torch.cli.main`` in process, under ``runs/smoke/cli``:
   ``train`` (10 steps at batch 128, "pallas", fuse_stats on, 9 kernel-5
   launches a step, a checkpoint at step 10), ``sample`` (256 images, one
   v2 launch), ``export`` (a symbolic-batch artifact: ``generate(256)``
   on the card is exactly 4 kernel-1 launches and the live "pallas"
   module path bit for bit, within phase 3's bound of ``Sampler.sample``,
   at three batch sizes; a ``--batch 64`` artifact pads a tail of 100;
   moved to the CPU, the plain version within ``image_err``), ``serve
   --ckpt`` on 127.0.0.1 (npy pixels equal ``artifact.sample``; SIGTERM
   ends it), ``export-torch`` then ``import-torch`` (the state bit for
   bit, moments warm), ``profile``; then ``sample(unroll=4)`` under "xla"
   (one CUDA graph replay of 4 batches, bit for bit ``unroll=1``) and
   under "pallas" (a warning, sequential v2), and the artifact's
   ``generate(256)`` against the Sampler's, by CUDA events.  Phase 2
   also times kernel 1's wrapper through the registered op against the
   direct route (checks, then the launch);
16. world 1: full-width ``dcgan_celeba64`` (batch 128, fuse_stats on)
   through the ``Trainer`` with ``mesh_shape=1`` in a one-rank NCCL group,
   10 steps: 9 kernel-5 launches a step, the state bit for bit the plain
   Trainer's (cuDNN deterministic), ms/step, and the profiler's count of
   the step's all-reduces and NCCL's share of its device time;
17. DP and FSDP on 2 ranks (NCCL, one a card, where there are two cards;
   else gloo, both on the one card, asked for explicitly): full-width
   ``dcgan_celeba64`` at a global batch of 128, ``mesh_shape=2`` and
   ``mesh_shape=1, fsdp_shards=2``, each held to the single card's run at
   steps 1 and 3 (``held``, within ``MESH_LIMITS``), 10 steps timed on
   each rank, each rank's
   bytes of parameters plus moments (FSDP: about half) and
   ``memory_allocated``, and rank 0's grid (one v2 launch, none on rank
   1);
18. spatial: full-width ``dcgan_256_spatial`` (ngf=ndf=32, 256 px, batch
   128) with ``spatial_shards=2`` on 2 ranks: step 1's losses, and the
   parameters and losses at steps 1 and 3 (``held``), against the dense
   single card's, 5 steps timed, and a
   64-image grid through the spatial Sampler against the dense Sampler on
   the same generator;
19. sharded serving: ``ShardedSampler`` on 2 ranks under "pallas":
   ``sample(256)`` against the single-card module path (4 kernel-1
   launches a pass on each rank), then ``serve --shards 2 --ckpt`` (phase
   15's checkpoint) answering 3 ``POST /sample`` within ``image_err`` of
   the module path.  Each of 16-19 prints its backend, world, cards,
   ms/step or ms/call and launch counts; ranks report their own counts;
20. the six ``examples_torch`` scripts as a user runs them, each as
   ``__main__`` with its argv, from its own directory under
   ``runs/smoke/examples``: ``train_dcgan_mnist``,
   ``train_wgan_gp_cifar10`` (an eval at its last step),
   ``data_parallel_training`` and ``train_256px_spatial`` (``--width
   32``) on two ranks (gloo sharing the one card, as 17-19), 20 steps
   each at the presets' widths, ``train_multihost`` as two processes
   meeting at a ``--coordinator`` (the same ``loss_d`` on both), and
   ``serve_and_query`` on the MNIST run's checkpoint (``served == local
   ... True``); each one's wall time, ms/step over its last log window
   (the global batch over the Trainer's ``images_per_sec``) and its
   launch counts, its ranks' and processes' summed (zero under the
   presets' ``kernels="xla"``, ``fuse_stats="off"``).  A script that
   raises, lacks its output or prints ``False`` fails the run;
21. fp32 operands (``train.precision="fp32"``, ``kernels="pallas"``),
   TF32 off: kernels 1, 4 and 5 on fp32 x and w at the path's shapes
   (kernel 1 at the fp32 generator's four layers, batch 256; kernel 4 at
   its D's four layers, batch 128, and the conditional D's Cin-4 layer;
   kernel 5 at the three BN layers, batches 128 and 64), each on its
   wrapper's route (three TF32 passes; kernel 4's RGB layers on its narrow
   tile), within 1e-5 of the layer's largest |ref| of its plain version
   and the same bits on a second run, with two TF32 runs of the same
   function beside (cuDNN with TF32 on; the plain version on TF32-rounded
   operands), timed beside cuDNN in fp32 and bound on the route's rate
   (the FFMA rate's bound beside); then full-width fp32
   ``dcgan_celeba64`` trained with
   ``fuse_stats`` on and off from one seed (step 1's losses within 1e-3,
   exactly 9 kernel-5 launches a step, steps timed in turns), its D in
   eval mode under "pallas" against "xla" (4 kernel-4 launches a
   forward), its eval G's module path (4 kernel-1 launches), the exported
   fp32 artifact's ``generate(256)`` (4 launches, the module path's bits)
   and ``Sampler.sample(256)`` (one v2 launch, against v2's plain
   version), and the CLI's ``train`` / ``sample`` / ``serve --ckpt`` with
   ``tests/test_torch_port_cli.py``'s settings (``dcgan_mnist``, fp32,
   "pallas").

Phases 3-4, 5, 6, 7 (train, eval D), 8, 9 (train, eval D), 10, 11, 12
(``grad_accum``, remat's plain twin, remat), 14 (streaming, in RAM,
resumed, timed, ``evaluate``), 15 (each command, the artifact's
``generate``, the fixed-batch tail, ``unroll`` under "pallas"), 16-19
(each mesh run, its ranks' counts summed), 20 (each example) and 21
(each fp32 path, named "fp32 ...") are the paths: each zeroes
the launch counters just before it and reads them just after, and every
kernel it names must have launched.  Each kernel's ``launches`` in the
``kernels`` line sums its paths' counts, and ``launches_by_path`` lists
them; kernels 1, 4 and 5 carry an ``fp32`` case in ``cases`` (phase 21's
layers summed over one forward, each layer beside, and the launches of
the fp32 paths).
Checkpoints, the dataset files and the flagship's trace go to the
git-ignored ``runs/smoke``.  The last lines are the ``kernels`` JSON, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA device or without the ``tpugan_torch``
package beside this file.

    python3 chip_smoke.py --against DIR

compares megakernel v2 of the checkout in DIR (the parent commit, say) with
this one's, in turns on one card: the same image bits, and each run's times;
and the conv kernels' device ms by layer (``--measure-convs``: kernel 4 at
fp32 and bf16 at the eval D's layers, kernel 5 at fp32 and bf16, kernel 1
at fp32).

    python3 chip_smoke.py --mesh-tolerance

measures what phases 17-18's ``MESH_LIMITS`` sit between: the single card
run twice, the correct mesh runs and the same runs with a fault planted,
each against the single card at steps 1 and 3.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import queue
import re
import runpy
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM dense peaks (NVIDIA data sheet), at the full 700 W power limit:
# bf16 and TF32 on the tensor cores (the fp32 routes of kernels 1, 4 and 5
# run their products as three TF32 passes over split operands), fp32 FMA
# on the CUDA cores (the FFMA mainloop's products), and memory
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

BATCH = 256
TRAIN_BATCH = 128
N_FILES = 2048  # images in each dataset file set of phases 13-14
# checkpoints and the flagship's trace: written at run time, git-ignored,
# and kept out of chiprun_out/ (the small outputs' directory) for size
RUNS = ROOT / "runs" / "smoke"


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int) -> float:
    """Time per call by CUDA events around ``iters`` eager calls after one
    warm-up call: the device's time, or the host's where launching a call
    takes longer than running it."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events.  Unlike ``time_ms`` it
    leaves out the host's launch overhead (the wrapper's Python, the
    tensor-map encoding, the launch calls), which can outlast a kernel of
    tens of microseconds and is then what ``time_ms`` measures."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / (reps * iters)


def timed(fn, library=None, iters: int = 20) -> dict:
    """A kernel's time by events around eager calls (``ms``, ``time_ms``:
    host launch overhead included, the measure of the ``kernels`` line) and
    its device time alone (``device_ms``, ``graph_ms``), and the same two
    for the library call where there is one."""
    out = dict(ms=time_ms(fn, iters), device_ms=graph_ms(fn, iters))
    if library is not None:
        out.update(library_ms=time_ms(library, iters),
                   library_device_ms=graph_ms(library, iters))
    return out


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bf16_err(got, ref) -> tuple[float, bool]:
    """(max |got - ref|, within the limit) for two bf16 results of the same
    bf16 products whose fp32 sums differ only in order.  The sums differ by
    ~1e-6 relative, which may flip a bf16 rounding: one ulp, at most 2^-7 of
    the value.  Next to zero the sum order is the whole difference: 1e-3 of
    the layer's largest value.  The limit follows the layer's own scale, so
    a kernel that drops a part of the sum fails however small the layer's
    values are."""
    err = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    ok = bool((err <= 2.0 ** -7 * r + 1e-3 * r.max()).all())
    return err.max().item(), ok


def image_err(got, ref) -> tuple[float, bool]:
    """(max |got - ref|, within the limit) for the v2 kernel's fp32 image
    against its plain version: the same bf16 products, the fp32 sums in
    another order.  The order may flip an activation's bf16 rounding (one
    ulp) in any of the net's 5-6 layers, and the flips compound through
    the layers after it, so the floor is ten times ``bf16_err``'s: 2^-7
    |ref| + 1e-2 of the image's largest value.  A correct kernel errs a few
    thousandths of that value; one tile that misses one of its depth
    stages in one layer, a tenth."""
    err = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    ok = bool((err <= 2.0 ** -7 * r + 1e-2 * r.max()).all())
    return err.max().item(), ok


def fp32_err(got, ref) -> tuple[float, bool]:
    """(max |got - ref|, within the limit) for two fp32 sums of the same
    bf16 products in another order: ~sqrt(depth) * 2^-24 of the layer's
    scale (depth <= 4096 here), so 1e-4 of its largest value."""
    err = (got - ref).abs().max().item()
    return err, err <= 1e-4 * ref.abs().max().item()


def f32_check(got, ref) -> tuple[float, float, bool]:
    """(max |got - ref|, the layer's largest |ref|, within the limit) for
    an fp32 kernel against its plain version, TF32 off on both sides: the
    same fp32 products summed in another order, ~sqrt(depth) 2^-24 of the
    layer's scale at depth <= 4096, so 1e-5 of its largest |ref|.  A TF32
    run of the same function (operands rounded to 10 bits) errs ~1e-3 of
    it; ``f32_case`` prints that beside."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, scale, err <= 1e-5 * scale


def f32_stats_check(got, ref) -> tuple[float, float, bool]:
    """``f32_check`` for kernel 5's (y, mean, var): y as there, the mean
    within 1e-5 of y's largest |value|, the variance (E[y^2] - mean^2)
    within 1e-5 of the layer's largest second moment E[y^2]."""
    (y, m, v), (yr, mr, vr) = got, ref
    err, scale, ok = f32_check(y, yr)
    em = (m - mr).abs().max().item()
    ev = (v - vr).abs().max().item()
    ok = (ok and em <= 1e-5 * scale
          and ev <= 1e-5 * (vr + mr * mr).max().item())
    return max(err, em, ev), scale, ok


def tf32_round(t):
    """fp32 ``t`` rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``): an operand as a tensor core
    takes it under TF32."""
    import torch

    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """cuDNN's TF32 convolutions on (``on``) or off inside the block."""
    import torch

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rate(case: dict) -> str:
    """A layer's achieved rate on the quantity that bounds it, and its share
    of the bound (bound_ms / ms), eagerly and on the device alone."""
    out = []
    for key in ("ms", "device_ms"):
        t = case[key]
        if case["bound_by"] == "bytes":
            r = f"{case['bytes'] / t / 1e6:.1f} GB/s"
        else:
            r = f"{case['flops'] / t / 1e9:.1f} TFLOP/s"
        out.append(f"{key} {r}, {100 * case['bound_ms'] / t:.1f}% of bound")
    return "; ".join(out)


def time_host(fn, iters: int) -> float:
    """ms per call of ``fn`` on the host's clock, synchronizing the card
    after each call (a call may leave device work queued), after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def events_ms(fn) -> float:
    """Device-clock span of one call of ``fn`` (which may launch many
    kernels and run host code between them), by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def conv_work(x, w, out_bytes):
    """(flops, bytes) of one Conv(4, 2, 1): the multiply-adds, x and w read
    once, the output written once."""
    n, h, wd, cin = x.shape
    flops = 2 * n * (h // 2) * (wd // 2) * 16 * cin * w.shape[3]
    return flops, nbytes(x, w) + out_bytes


def gen_layers(mod, zb, hb, bb, s0, c0, reps: int = 5) -> dict:
    """Where a megakernel launch's device time goes (``mod``: cuda_gen for
    v1, cuda_gen2 for v2), from every block's device clock (%globaltimer)
    at its start, as it finishes its tiles of each layer and as it leaves
    the layer's grid barrier, averaged over ``reps`` launches of the
    stamped instantiation: per layer (the head, then each ConvT layer) the
    ms until the last block finished its tiles (``work_ms``; from the last
    block out of the barrier before, or the first block's start) and then
    until the last block left the barrier (``barrier_ms``), the median
    block's tiles (``median_work_ms``), and the ms between the first and
    the last block's start (``start_ms``)."""
    import torch

    dev = zb.device
    couts = [a.shape[0] for _, a, _, _ in bb]
    grid, _ = mod.plan(zb.shape[0], zb.shape[1], s0, c0, couts,
                       mod.resident(dev))
    layers = len(bb) + 1
    stamps = torch.zeros((2 * layers + 1, grid), dtype=torch.int64,
                         device=dev)
    work, wait, spread = [0.0] * layers, [0.0] * layers, 0.0
    median = [0.0] * layers
    for _ in range(reps):
        mod.launch(zb, hb, bb, s0, c0, stamps=stamps)
        torch.cuda.synchronize()
        t = stamps.double() / 1e6
        done, out = t[1::2].max(dim=1).values, t[2::2].max(dim=1).values
        start = torch.cat([t[0].min().view(1), out[:-1]])
        spread += (t[0].max() - t[0].min()).item() / reps
        for i in range(layers):
            work[i] += (done[i] - start[i]).item() / reps
            wait[i] += (out[i] - done[i]).item() / reps
            median[i] += (t[2 * i + 1] - start[i]).median().item() / reps
    return dict(work_ms=work, barrier_ms=wait, median_work_ms=median,
                start_ms=spread)


def includes(src: str) -> list[str]:
    """The headers of ``tpugan_torch/csrc`` that kernel source ``src``
    includes, itself or through another header."""
    csrc = ROOT / "tpugan_torch" / "csrc"
    seen, todo = [], [src]
    while todo:
        for name in re.findall(r'#include "([^"]+)"',
                               (csrc / todo.pop()).read_text()):
            if name not in seen:
                seen.append(name)
                todo.append(name)
    return [f"tpugan_torch/csrc/{name}" for name in seen]


def conv_case(x, wb, a, b, **extra) -> tuple[dict, object]:
    """Kernel 4 (``cuda_conv.conv_affine_act``, LeakyReLU epilogue) on one
    layer's bf16 input ``x`` and weight ``wb`` against its plain version,
    bf16 out (``bf16_err``) and the bare conv's fp32 sums (``fp32_err``):
    the case's times beside ``F.conv2d`` + affine + LeakyReLU, its bound,
    path and split; returns (case, the plain bf16 output)."""
    import torch
    import torch.nn.functional as F

    from tpugan_torch.ops import cuda_conv

    cout = wb.shape[3]
    got = cuda_conv.conv_affine_act(x, wb, a, b, act="leaky_relu")
    ref = cuda_conv.conv_affine_act_plain(x, wb, a, b, act="leaky_relu")
    # the bare conv's fp32 output: the sums themselves, unrounded
    got32 = cuda_conv.conv2d(x, wb)
    ref32 = cuda_conv.conv421_plain(x, wb)
    torch.cuda.synchronize()
    err, ok = bf16_err(got, ref)
    err32, ok32 = fp32_err(got32, ref32)
    n, h, wd, cin = x.shape
    shape = f"{n}x{h}x{wd}x{cin}->{h // 2}x{wd // 2}x{cout}"
    require(ok and ok32,
            f"conv {shape}: max err {err} (bf16 out, largest value "
            f"{ref.float().abs().max().item()}), {err32} (fp32 out, largest "
            f"value {ref32.abs().max().item()})")
    xl = x.permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW
    wl = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        y = F.conv2d(xl, wl, stride=2, padding=1)
        return F.leaky_relu(y * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1),
                            0.2)

    flops, byt = conv_work(x, wb, nbytes(a, b, got))
    bms, by = bound_ms(flops, byt)
    path, _, splits = cuda_conv.plan(x, cout)
    c = dict(**extra, shape=shape, path=path, splits=splits,
             **timed(lambda: cuda_conv.conv_affine_act(x, wb, a, b),
                     library),
             plain_ms=time_ms(lambda: cuda_conv.conv_affine_act_plain(
                 x, wb, a, b), 5),
             bound_ms=bms, bound_by=by, flops=flops, bytes=byt,
             max_abs_err=err, scale=ref.float().abs().max().item(),
             fp32_max_abs_err=err32, fp32_scale=ref32.abs().max().item())
    log(f"[kernel] conv_affine_act {json.dumps(c)}")
    log(f"[kernel] conv_affine_act {shape}: {rate(c)}")
    return c, ref


def stats_case(x, wb, **extra) -> dict:
    """Kernel 5 (``cuda_conv_stats.conv_stats``) on one BN layer's bf16
    input ``x`` and weight ``wb`` against its plain version (y by
    ``bf16_err``, the statistics of the fp32 sums to 1e-4 / 1e-3 relative):
    the case's times beside ``F.conv2d`` + ``torch.var_mean`` (cuDNN), its
    bound, and its time by depth split."""
    import torch
    import torch.nn.functional as F

    from tpugan_torch.ops import cuda_conv_stats

    n, h, wd, cin = x.shape
    cout = wb.shape[3]
    shape = f"{n}x{h}x{wd}x{cin}->{h // 2}x{wd // 2}x{cout}"
    y, mean, var = cuda_conv_stats.conv_stats(x, wb)
    yr, mr, vr = cuda_conv_stats.conv_stats_plain(x, wb)
    torch.cuda.synchronize()
    ey, ok = bf16_err(y, yr)
    require(ok, f"conv_stats {shape}: y max err {ey}")
    # statistics of the fp32 sums on both sides, summed in another order;
    # var = E[y^2] - mean^2 loses a few bits
    em = (mean - mr).abs()
    ev = (var - vr).abs()
    require(bool((em <= 1e-5 + 1e-4 * mr.abs()).all()),
            f"conv_stats {shape}: mean max err {em.max()}")
    require(bool((ev <= 1e-5 + 1e-3 * vr.abs()).all()),
            f"conv_stats {shape}: var max err {ev.max()}")
    xl = x.permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW
    wl = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        yl = F.conv2d(xl, wl, stride=2, padding=1)
        return yl, torch.var_mean(yl, dim=(0, 2, 3), correction=0)

    flops, byt = conv_work(x, wb, nbytes(y, mean, var))
    flops += 3 * y.numel()  # the sums of y and y^2
    bms, by = bound_ms(flops, byt)
    c = dict(**extra, shape=shape, **timed(
        lambda: cuda_conv_stats.conv_stats(x, wb), library),
        plain_ms=time_ms(lambda: cuda_conv_stats.conv_stats_plain(x, wb), 5),
        bound_ms=bms, bound_by=by, flops=flops, bytes=byt,
        max_abs_err=max(ey, em.max().item(), ev.max().item()),
        scale=yr.float().abs().max().item())
    # the depth split against its alternatives (the plan's choice is the
    # one the main path runs)
    steps = 16 * -(-cin // 64)
    c["split_ms"] = {
        s: graph_ms(lambda s=s: cuda_conv_stats._launch(x, wb, splits=s), 20)
        for s in (1, 2, 4) if steps % s == 0 and steps >= 8 * s}
    c["splits"] = cuda_conv_stats.plan(x, cout)[1]
    log(f"[kernel] conv_stats {json.dumps(c)}")
    log(f"[kernel] conv_stats {shape}: {rate(c)}; depth split "
        f"{c['splits']}, ms by split {c['split_ms']}")
    return c


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def run_steps(tr, n: int, data: dict, metrics: list | None = None) -> float:
    """ms per step of n train steps of Trainer ``tr`` fed by the input
    pipeline, as the Trainer runs them (logging and grids aside), by CUDA
    events; each step's metrics go to ``metrics``."""
    from tpugan_torch.data.pipeline import make_input_pipeline

    cfg = tr.cfg
    it = iter(make_input_pipeline(data, cfg.data.batch_size,
                                  seed=cfg.train.seed,
                                  with_labels=cfg.model.arch == "cdcgan",
                                  device=tr.device,
                                  start_step=tr.state.step))
    batches = [next(it)]  # the pipeline's prefetch, as in steady state

    def body():
        for i in range(n):
            tr.state, m = tr.step_fn(tr.state, batches[i])
            if metrics is not None:
                metrics.append(m)
            if i + 1 < n:
                batches.append(next(it))

    ms = events_ms(body) / n
    it.close()
    return ms


def profile_run(run, n: int, label: str, top: int = 12) -> dict:
    """Where a step's time goes: ``run()`` (n steps; returns its ms per
    step) under ``torch.profiler``, the device time by kernel and the
    device's busy share of a step (the rest is the host's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = run()
    # kernel rows only: an operator's row repeats its kernels' device time
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n
    per_step = sum(e.count for e in kern) / n
    # the host's waits for the device (a copy from pageable host memory
    # synchronizes its stream)
    waits = [e for e in prof.key_averages()
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaEventSynchronize")]
    log(f"[profile] {label}: {prof_ms:.4f} ms/step under the profiler, "
        f"device busy {busy:.4f} ms/step ({100 * busy / prof_ms:.1f}%), "
        f"{per_step:.0f} kernels/step; host waits for the device "
        f"{sum(e.count for e in waits) / n:.1f}/step, "
        f"{sum(e.cpu_time_total for e in waits) / 1e3 / n:.4f} ms/step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:8.4f} ms/step "
            f"{e.count / n:6.1f}/step  {e.key[:90]}")
    return dict(ms=prof_ms, busy_ms=busy, busy_share=busy / prof_ms,
                kernels=per_step,
                by_kernel={e.key: e.self_device_time_total / 1e3 / n
                           for e in kern})


def profile_steps(tr, n: int, data: dict, metrics: list, label: str,
                  top: int = 12) -> dict:
    """``profile_run`` over n steps of ``tr`` fed by the input pipeline."""
    return profile_run(lambda: run_steps(tr, n, data, metrics), n, label,
                       top)


def state_tensors(a, b):
    """(name, tensor of a, tensor of b) over two TrainStates' modules, EMA
    and optimizer states, on the CPU."""
    sa, sb = a.state_dict(), b.state_dict()
    for part in ("g", "d", "g_ema"):
        for k, t in (sa[part] or {}).items():
            yield f"{part}.{k}", t.cpu(), sb[part][k].cpu()
    for part in ("opt_g", "opt_d"):
        for i, st in sa[part]["state"].items():
            for k, t in st.items():
                yield f"{part}.{i}.{k}", t.cpu(), sb[part]["state"][i][k].cpu()


def max_state_diff(a, b) -> float:
    """The largest |difference| between two TrainStates' tensors."""
    return max((ta.float() - tb.float()).abs().max().item()
               for _, ta, tb in state_tensors(a, b))


def states_equal(a, b) -> bool:
    """Two TrainStates hold the same bits: every parameter and buffer, the
    EMA, both optimizers' moments, counts and LRs, ADA's p and r_t, the key
    and the step."""
    import torch

    sa, sb = a.state_dict(), b.state_dict()
    ada = all((sa[k] is None and sb[k] is None)
              or (sa[k] is not None and sb[k] is not None
                  and torch.equal(sa[k].cpu(), sb[k].cpu()))
              for k in ("ada_p", "ada_rt"))
    return ((sa["step"], sa["rng"]) == (sb["step"], sb["rng"]) and ada
            and all(sa[p]["param_groups"] == sb[p]["param_groups"]
                    for p in ("opt_g", "opt_d"))
            and all(torch.equal(ta, tb) for _, ta, tb in state_tensors(a, b)))


def gen_work(z, head, blocks, s0, c0, out_elems):
    """(flops, bytes) of one megakernel call: the head and every ConvT
    layer's multiply-adds; z, weights, affines read once, the fp32 image
    written once."""
    n = z.shape[0]
    wh = head[0]
    flops = 2 * n * wh.shape[0] * wh.shape[1]
    hs, cin = s0, c0
    for w, _, _ in blocks:
        flops += 2 * n * 16 * hs * hs * cin * w.shape[3]
        hs, cin = 2 * hs, w.shape[3]
    read = z.numel() * 2 + wh.numel() * 2 + nbytes(head[1], head[2])
    read += sum(w.numel() * 2 + nbytes(a, b) for w, a, b in blocks)
    return flops, read + out_elems * 4


def make_generator(preset: str, dev, overrides=None):
    """(cfg, eval-mode generator) of ``preset`` at its full width on ``dev``:
    random weights from a ``torch.Generator`` seeded 0, BN running stats
    from three train-mode forwards at batch ``BATCH``."""
    import torch

    from tpugan_torch.configs import get_preset
    from tpugan_torch.models.registry import build_generator

    cfg = get_preset(preset).override(overrides or {})
    gen = torch.Generator(device=dev).manual_seed(0)
    g = build_generator(cfg.model, cfg.train.precision, device=dev,
                        generator=gen)
    cond = cfg.model.arch == "cdcgan"
    with torch.no_grad():
        g.train()
        for _ in range(3):
            z = torch.randn(BATCH, cfg.model.nz, device=dev, generator=gen)
            if cond:
                y = torch.randint(0, cfg.model.n_classes, (BATCH,),
                                  device=dev, generator=gen)
                g(z, y)
            else:
                g(z)
    return cfg, g.eval()


def run_cli(dev, *argv) -> str:
    """``tpugan_torch.cli.main`` in process on ``dev``; returns what it
    printed and logs its last line."""
    from tpugan_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", dev.type, *argv])
    text = buf.getvalue()
    log(f"[cli] {' '.join(argv[:1])}: {text.strip().splitlines()[-1]}")
    return text


def serve_once(dev, ckpt: str, request: dict) -> dict:
    """``serve --ckpt`` on 127.0.0.1: serve_forever on this (main) thread,
    a client thread that waits for /healthz, posts ``request`` to /sample
    (npy) and then sends SIGTERM, the server's own shutdown path.  Returns
    what the client read ("health", "npy")."""
    import socket

    import numpy as np

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    served = {}

    def client():
        try:
            for _ in range(600):
                try:
                    with urllib.request.urlopen(url + "/healthz",
                                                timeout=5) as r:
                        served["health"] = json.loads(r.read())
                    break
                except OSError:
                    time.sleep(0.1)
            req = urllib.request.Request(
                url + "/sample", method="POST", data=json.dumps(
                    {**request, "format": "npy"}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                served["npy"] = np.load(io.BytesIO(r.read()))
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    th = threading.Thread(target=client, daemon=True)
    th.start()
    run_cli(dev, "serve", "--ckpt", ckpt, "--host", "127.0.0.1", "--port",
            str(port))
    th.join(timeout=60)
    require(not th.is_alive() and "npy" in served, "serve --ckpt: no answer")
    return served


def cli_phase(dev, zero_counts, read_counts) -> dict:
    """Phase 15, the CLI and the exported generator: ``dcgan_celeba64`` at
    full width driven in process through ``tpugan_torch.cli.main``, each
    command a path counted from zero.  Returns the phase's numbers."""
    import statistics
    import warnings

    import numpy as np
    import torch

    from tpugan_torch import cli
    from tpugan_torch.export import load_generator
    from tpugan_torch.ops import convs
    from tpugan_torch.sample.sampler import Sampler, seeded_noise

    out_dir = RUNS / "cli"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    sets = ["data.dataset=synthetic",
            f"data.synthetic_size={10 * TRAIN_BATCH}",
            f"data.batch_size={TRAIN_BATCH}", "train.kernels=pallas",
            "train.fuse_stats=on", "train.total_steps=10",
            "train.ckpt_every=10", "train.log_every=10",
            "train.sample_every=10"]
    flags = [a for x in sets for a in ("--set", x)]
    ckpt = str(out_dir / "run" / "ckpt")
    found = {}

    def run(*argv) -> str:
        return run_cli(dev, *argv)

    # train: 10 steps, kernel 5 in the three BN blocks of each D forward
    zero_counts()
    run("train", "dcgan_celeba64", "--out", str(out_dir / "run"), *flags)
    counts = read_counts("cli train dcgan_celeba64")
    require(counts["conv_stats"] == 9 * 10,
            f"cli train: {counts['conv_stats']} kernel-5 launches, not 90")
    cfg, g, step = cli._load_generator_from_ckpt(ckpt, dev)
    g.eval()
    require(step == 10, f"checkpoint at step {step}, not 10")
    require(cfg.model.nz == 100 and cfg.model.ngf == 64
            and cfg.data.batch_size == TRAIN_BATCH,
            "cli train: not full-width dcgan_celeba64")

    # sample: one v2 launch a batch
    zero_counts()
    run("sample", "--ckpt", ckpt, "--n", str(BATCH), "--batch-size",
        str(BATCH), "--out", str(out_dir / "samples.png"))
    counts = read_counts("cli sample")
    require(counts["v2"] == 1, f"cli sample: {counts['v2']} v2 launches")

    # export: a symbolic-batch artifact under "pallas", and a fixed batch
    art_path, art64_path = out_dir / "g.tpugan", out_dir / "g64.tpugan"
    run("export", "--ckpt", ckpt, "--out", str(art_path))
    run("export", "--ckpt", ckpt, "--out", str(art64_path), "--batch",
        str(BATCH // 4))
    art = load_generator(str(art_path), device=dev)
    zn = seeded_noise(cfg.model.nz, BATCH, seed=0)
    zero_counts()
    img = art.generate(zn)
    counts = read_counts("artifact generate")
    require(counts["convt_affine_act"] == 4 and counts["v2"] == 0,
            f"artifact generate({BATCH}): launches {counts}")
    require(img.shape == (BATCH, 64, 64, 3) and bool(np.isfinite(img).all()),
            f"artifact image {img.shape}")
    with torch.no_grad(), convs.using_impl("pallas"):
        live = g(torch.from_numpy(zn).to(dev)).float().cpu().numpy()
    require(np.array_equal(img, live),
            f"artifact vs live module path under pallas: max "
            f"{np.abs(img - live).max()}")
    # against v2, phase 3's bound for the module path: the per-layer path
    # rounds each activation to bf16 where v2 keeps fp32
    sampler = Sampler(cfg, g)
    d = np.abs(art.sample(BATCH, seed=0) - sampler.sample(BATCH, seed=0))
    require(d.max() <= 5e-2 and d.mean() <= 2e-3,
            f"artifact vs Sampler (v2): max {d.max()}, mean {d.mean()}")
    found["artifact_vs_v2"] = {"max": float(d.max()), "mean": float(d.mean())}
    for n in (1, 37, BATCH):
        out = art.generate(zn[:n])
        require(out.shape[0] == n and bool(np.isfinite(out).all()),
                f"artifact at batch {n}")
    art64 = load_generator(str(art64_path), device=dev)
    tail = 100
    zero_counts()
    padded = art64.generate(zn[:tail])
    counts = read_counts("fixed-batch artifact, a tail")
    chunks = -(-tail // (BATCH // 4))
    require(counts["convt_affine_act"] == 4 * chunks,
            f"fixed-batch artifact: launches {counts}, {chunks} chunks")
    require(image_err(torch.from_numpy(padded),
                      torch.from_numpy(img[:tail]))[1],
            "fixed batch with a padded tail differs")
    n_cpu = 16
    on_cpu = load_generator(str(art_path), device="cpu").generate(zn[:n_cpu])
    err, ok = image_err(torch.from_numpy(img[:n_cpu]),
                        torch.from_numpy(on_cpu))
    require(ok, f"artifact on the card vs on the CPU: max err {err}")
    found["card_vs_cpu_max_err"] = err

    # serve --ckpt on 127.0.0.1, answering one request
    zero_counts()
    served = serve_once(dev, ckpt, {"n": 16, "seed": 4})
    counts = read_counts("cli serve --ckpt")
    require(counts["convt_affine_act"] == 4 and counts["v2"] == 0,
            f"serve --ckpt launches {counts}")
    require(np.array_equal(served["npy"], art.sample(16, seed=4)),
            "served npy pixels differ from artifact.sample")

    # export-torch then import-torch: the state bit for bit, moments warm
    pth = str(out_dir / "model.pth")
    zero_counts()
    run("export-torch", "--ckpt", ckpt, "--out", pth)
    text = run("import-torch", "dcgan_celeba64", "--ckpt", pth, "--out",
               str(out_dir / "back"), *flags)
    require("restored warm for G+D" in text, "import-torch: moments cold")
    _, a = cli._load_state(ckpt, dev)
    _, b = cli._load_state(str(out_dir / "back"), dev)
    b.rng = a.rng  # the key is not part of a .pth
    require(states_equal(a, b), f".pth round trip differs by "
            f"{max_state_diff(a, b)}")
    require(any(float(st["exp_avg"].abs().max()) > 0
                for st in a.opt_d.state.values()), "moments all zero")
    read_counts("cli export-torch + import-torch")
    del a, b

    # profile: counted FLOPs and bytes, measured ms per step
    zero_counts()
    prof = json.loads(run("profile", "dcgan_celeba64", "--iters", "5",
                          *flags).strip().splitlines()[-1])
    counts = read_counts("cli profile")
    require(prof["ms_per_step"] > 0 and prof["images_per_sec"] > 0
            and prof["flops_per_step"] > 0, f"profile: {prof}")
    require(counts["conv_stats"] == 9 * (5 + 2),
            f"profile: {counts['conv_stats']} kernel-5 launches, not 63")
    found["profile"] = prof

    # unroll: "xla" as one CUDA graph replay of 4 batches, bit for bit
    xs = Sampler(cfg.override({"train.kernels": "xla"}), g)
    n_u = 4 * BATCH
    one = xs.sample(n_u, seed=2, batch_size=BATCH)
    four = xs.sample(n_u, seed=2, batch_size=BATCH, unroll=4)
    require(np.array_equal(one, four), f"unroll=4 vs unroll=1: max "
            f"{np.abs(one - four).max()}")
    # in alternating rounds, the medians: the host's noise draw and the
    # copy of the images back to the host are most of a call, and vary by
    # tens of ms from round to round on a shared host
    rounds = {1: [], 4: []}
    for _ in range(5):
        for u in rounds:
            rounds[u].append(time_ms(lambda: xs.sample(
                n_u, seed=2, batch_size=BATCH, unroll=u), 2))
    found["unroll1_ms"] = statistics.median(rounds[1])
    found["unroll4_ms"] = statistics.median(rounds[4])
    found["copy_back_ms"] = time_ms(lambda: torch.empty(
        (n_u, 64, 64, 3), device=dev).cpu(), 3)
    zero_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        seq = sampler.sample(n_u, seed=2, batch_size=BATCH, unroll=4)
    counts = read_counts("sample unroll=4 under pallas")
    require(any("unroll" in str(w.message) for w in caught),
            "unroll under pallas: no warning")
    require(counts["v2"] == 4, f"unroll under pallas: {counts}")
    require(np.array_equal(seq, sampler.sample(n_u, seed=2,
                                               batch_size=BATCH)),
            "unroll under pallas differs from sequential")

    # the artifact's per-layer kernel-1 path against the Sampler's v2
    found["artifact_generate_ms"] = time_ms(lambda: art.generate(zn), 5)
    found["sampler_generate_ms"] = time_ms(lambda: sampler.generate(zn), 5)
    found["artifact_sample_ms"] = time_ms(
        lambda: art.sample(BATCH, seed=0), 5)
    found["sampler_sample_ms"] = time_ms(
        lambda: sampler.sample(BATCH, seed=0), 5)
    log(f"[cli] {json.dumps(found)}")
    return found


def f32_bound(route: str, flops: float, nbytes: float) -> tuple[float, str]:
    """The least time of an fp32 kernel's work on its route: three TF32
    passes at ``PEAK_TF32_FLOPS`` ("tf32", "tf32_narrow") or FFMA at
    ``PEAK_FP32_FLOPS`` ("ffma"), or its bytes."""
    if route.startswith("tf32"):
        return bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)
    return bound_ms(flops, nbytes, PEAK_FP32_FLOPS)


def f32_case(kernel: str, shape: str, route: str, run, plain, plain_tf32,
             library, check, flops, byt, **extra) -> dict:
    """One layer of an fp32 kernel on ``route`` (the one the wrapper takes:
    ``kernel_common.f32_route``, kernel 4's ``cuda_conv.f32_path``; "tf32",
    "tf32_narrow" or "ffma"): ``run()`` (the kernel)
    against ``plain()`` (its plain version) by ``check(got, ref)`` -> (max
    err, scale, ok).  Beside it, by the same check, two TF32 runs of the
    same function: ``library()`` (one PyTorch call, its result in the
    kernel's layout) with cuDNN's TF32 on, where cuDNN may pick a kernel
    that does not round (it does not for the RGB layers), and
    ``plain_tf32()`` (the plain version on ``tf32_round``-ed x and w),
    which rounds on every layer and must err beyond the limit, so that the
    limit tells one TF32 pass from the route's three.  Times: the kernel's
    and the library call's with TF32 off (``timed``), the plain version's,
    and the bound on the route (``f32_bound``), with the FFMA rate's
    beside it (``bound_ffma_ms``, the FFMA mainloop's bound)."""
    import torch

    got, ref = run(), plain()
    with cudnn_tf32(True):
        t32 = library()
    t32_ops = plain_tf32()
    torch.cuda.synchronize()
    err, scale, ok = check(got, ref)
    t32_err = check(t32, ref)[0]
    t32_ops_err = check(t32_ops, ref)[0]
    require(ok, f"{kernel} fp32 {shape}: max err {err} (largest |ref| "
            f"{scale}; the limit is 1e-5 of it)")
    require(t32_ops_err > 1e-5 * scale,
            f"{kernel} fp32 {shape}: one TF32 pass errs {t32_ops_err}, "
            f"within the limit: it cannot tell TF32 from fp32")
    bms, by = f32_bound(route, flops, byt)
    c = dict(**extra, shape=shape, dtype="float32", route=route,
             **timed(run, library), plain_ms=time_ms(plain, 5),
             bound_ms=bms, bound_by=by,
             bound_ffma_ms=f32_bound("ffma", flops, byt)[0],
             flops=flops, bytes=byt, max_abs_err=err, scale=scale,
             tf32_max_abs_err=t32_err, tf32_operands_max_abs_err=t32_ops_err)
    log(f"[fp32] {kernel} {json.dumps(c)}")
    log(f"[fp32] {kernel} {shape}: max err {err:.3e} ({err / scale:.2e} of "
        f"the largest |ref|; limit 1e-5), cuDNN TF32 {t32_err:.3e} "
        f"({t32_err / scale:.2e}), TF32 operands {t32_ops_err:.3e} "
        f"({t32_ops_err / scale:.2e}); {rate(c)}")
    return c


def f32_summary(cases: list, main: int) -> dict:
    """A kernel's fp32 case for the ``kernels`` line: the sums of its
    first ``main`` layer cases (the main path's layers, one forward), the
    largest errors over all of them, and every case."""
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_ffma_ms", "flops", "bytes")
    out = {k: sum(c[k] for c in cases[:main]) for k in keys}
    routes = sorted({c["route"] for c in cases[:main]})
    out["route"] = "+".join(routes)
    out["bound_by"] = f32_bound(routes[-1], out["flops"], out["bytes"])[1]
    out["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    out["max_rel_err"] = max(c["max_abs_err"] / c["scale"] for c in cases)
    for key in ("tf32", "tf32_operands"):  # the least over the layers
        out[f"{key}_min_rel_err"] = min(c[f"{key}_max_abs_err"] / c["scale"]
                                        for c in cases)
    return dict(case="fp32", dtype="float32", **out, layers=cases)


def fp32_kernels(dev, real) -> dict:
    """Phase 21 (a): kernels 1, 4 and 5 on fp32 operands at the fp32 path's
    shapes, each on the route its wrapper takes (three TF32 passes: kernel
    4's RGB layers on its narrow tile) against its plain version
    (``f32_check``), with the error of a TF32 run of its library call
    beside: kernel 1 at the four layers of the fp32 ``dcgan_celeba64``
    generator at batch 256, on its own activations; kernel 4 at the four
    layers of its discriminator at batch 128 (``real``, fp32 images) and
    the conditional D's first layer (Cin 4); kernel 5 at the three BN
    layers at batches 128 and 64.  Every kernel gives the same bits on a
    second run.  Returns each kernel's ``f32_summary``."""
    import torch
    import torch.nn.functional as F

    from tpugan_torch.configs import get_preset
    from tpugan_torch.models.registry import build_discriminator
    from tpugan_torch.ops import cuda_conv, cuda_conv_stats, cuda_convt
    from tpugan_torch.ops import cuda_gen
    from tpugan_torch.ops.fused import bn_affine
    from tpugan_torch.ops.kernel_common import f32_route
    from tpugan_torch.sample.sampler import seeded_noise

    f32 = torch.float32
    out = {}

    def twice(name, run):
        """``run``, after two runs of it gave the same bits (no atomics, a
        fixed order)."""
        runs = [run() for _ in range(2)]
        runs = [(r,) if torch.is_tensor(r) else r for r in runs]
        require(all(torch.equal(u, v) for u, v in zip(*runs)),
                f"{name}: two runs differ")
        return run
    cfg, g = make_generator("dcgan_celeba64", dev,
                            {"train.precision": "fp32"})
    require(cfg.model.nz == 100 and cfg.model.ngf == 64
            and g.head.dense.dtype == f32, "not the fp32 full-width G")
    z = torch.from_numpy(seeded_noise(cfg.model.nz, BATCH, seed=0)).to(dev)
    _, blocks, _ = cuda_gen.fold_generator(g)
    cases = []
    with torch.no_grad():
        x = g.head(z)  # fp32 activations, not bf16-valued ones
        for i, (w, a, b) in enumerate(blocks):
            act = "tanh" if i == len(blocks) - 1 else "relu"
            w = w.float().contiguous()
            xl = x.permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW
            wl = w.permute(2, 3, 0, 1).contiguous()

            def library(xl=xl, wl=wl, a=a, b=b, act=act):
                y = F.conv_transpose2d(xl, wl, stride=2, padding=1)
                y = y * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
                y = torch.tanh(y) if act == "tanh" else torch.relu(y)
                return y.permute(0, 2, 3, 1)

            n, h, wd, cin = x.shape
            cout = w.shape[3]
            shape = f"{n}x{h}x{wd}x{cin}->{2 * h}x{2 * wd}x{cout}"
            cases.append(f32_case(
                "convt_affine_act", shape, f32_route(cin),
                twice(f"convt_affine_act fp32 {shape}",
                      lambda x=x, w=w, a=a, b=b, act=act:
                      cuda_convt.convt_affine_act(x, w, a, b, act=act)),
                lambda x=x, w=w, a=a, b=b, act=act:
                    cuda_convt.convt_affine_act_plain(x, w, a, b, act=act),
                lambda x=x, w=w, a=a, b=b, act=act:
                    cuda_convt.convt_affine_act_plain(
                        tf32_round(x), tf32_round(w), a, b, act=act),
                library, f32_check, 2 * n * 16 * h * wd * cin * cout,
                nbytes(x, w, a, b) + n * 4 * h * wd * cout * 4))
            x = cuda_convt.convt_affine_act_plain(x, w, a, b, act=act)
    out["convt_affine_act"] = f32_summary(cases, len(blocks))
    del g

    dcfg = get_preset("dcgan_celeba64")
    d = build_discriminator(dcfg.model, "fp32", device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1)).eval()
    ccfg = get_preset("cdcgan_celeba64")
    cd = build_discriminator(ccfg.model, "fp32", device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(2)).eval()
    # the conditional D's first layer: the image and a label plane
    plane = (torch.arange(real.shape[0], device=dev) % 2).float()
    x4 = torch.cat([real, plane.view(-1, 1, 1, 1).expand(
        *real.shape[:3], 1)], dim=-1).contiguous()

    def conv_one(x, w, a, b, leak, **extra):
        n, h, wd, cin = x.shape
        cout = w.shape[3]
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            y = F.conv2d(xl, wl, stride=2, padding=1)
            y = y * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
            return F.leaky_relu(y, leak).permute(0, 2, 3, 1)

        flops, byt = conv_work(x, w, n * (h // 2) * (wd // 2) * cout * 4)
        shape = f"{n}x{h}x{wd}x{cin}->{h // 2}x{wd // 2}x{cout}"
        return f32_case(
            "conv_affine_act", shape, cuda_conv.f32_path(cin, cout),
            twice(f"conv_affine_act fp32 {shape}",
                  lambda: cuda_conv.conv_affine_act(x, w, a, b, leak=leak)),
            lambda: cuda_conv.conv_affine_act_plain(x, w, a, b, leak=leak),
            lambda: cuda_conv.conv_affine_act_plain(
                tf32_round(x), tf32_round(w), a, b, leak=leak),
            library, f32_check, flops, byt + nbytes(a, b), **extra)

    def stats_one(x, w):
        n, h, wd, cin = x.shape
        cout = w.shape[3]
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            y = F.conv2d(xl, wl, stride=2, padding=1)
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            return y.permute(0, 2, 3, 1), mean, var

        flops, byt = conv_work(x, w, (n * (h // 2) * (wd // 2) + 2) * cout
                               * 4)
        shape = f"{n}x{h}x{wd}x{cin}->{h // 2}x{wd // 2}x{cout}"
        return f32_case(
            "conv_stats", shape, f32_route(cin),
            twice(f"conv_stats fp32 {shape}",
                  lambda: cuda_conv_stats.conv_stats(x, w)),
            lambda: cuda_conv_stats.conv_stats_plain(x, w),
            lambda: cuda_conv_stats.conv_stats_plain(tf32_round(x),
                                                     tf32_round(w)),
            library, f32_stats_check,
            flops + 3 * n * (h // 2) * (wd // 2) * cout, byt)

    def folded(blk):
        """(w, a, b) of a DBlock in eval mode: BN folded, or (1, bias)."""
        w = blk.conv.w.float().contiguous()
        if blk.bn is None:
            return w, torch.ones_like(w[0, 0, 0]), blk.conv.b.float()
        return (w, *bn_affine(blk.bn.scale, blk.bn.bias, blk.bn.mean,
                              blk.bn.var, blk.bn.eps))

    def chain(x):
        """(block, its input, w, a, b) down D from images ``x``, each input
        the plain version's output of the block before."""
        out = []
        for blk in d.blocks:
            w, a, b = folded(blk)
            out.append((blk, x, w, a, b))
            x = cuda_conv.conv_affine_act_plain(x, w, a, b,
                                                leak=blk.act.slope)
        return out

    with torch.no_grad():
        layers = chain(real)
        conv_cases = [conv_one(x, w, a, b, blk.act.slope)
                      for blk, x, w, a, b in layers]
        blk0 = cd.d.block0
        conv_cases.append(conv_one(x4, *folded(blk0), blk0.act.slope,
                                   path="narrow"))
        # kernel 5 at 128, then at a grad_accum=2 microbatch of 64
        stats_cases = [stats_one(x, w) for batch in (layers, chain(real[:64]))
                       for blk, x, w, _, _ in batch if blk.bn is not None]
    out["conv_affine_act"] = f32_summary(conv_cases, len(d.blocks))
    n_bn = sum(blk.bn is not None for blk in d.blocks)
    out["conv_stats"] = f32_summary(stats_cases, n_bn)
    return out


def fp32_phase(dev, train_data, zero_counts, read_counts) -> dict:
    """Phase 21, ``train.precision="fp32"`` with ``train.kernels="pallas"``
    on the card: the fp32 kernels at the path's shapes (``fp32_kernels``);
    full-width ``dcgan_celeba64`` trained with ``fuse_stats`` on and off
    from one seed (step 1's losses within 1e-3; exactly 9 kernel-5
    launches a step; steps timed in turns); the trained D in eval mode
    under "pallas" against "xla" (4 kernel-4 launches a forward); the eval
    G's module path under "pallas" against "xla" (4 kernel-1 launches);
    the exported fp32 artifact's ``generate(256)`` (4 kernel-1 launches,
    the module path's bits) and ``Sampler.sample(256)`` (one v2 launch,
    against v2's plain version); the CLI's ``train`` / ``sample`` / ``serve
    --ckpt`` with ``tests/test_torch_port_cli.py``'s settings
    (``dcgan_mnist``, fp32, pallas).  Each path counted from zero, its
    name starting "fp32 ".  Returns each kernel's fp32 case."""
    import numpy as np
    import torch

    from tpugan_torch import cli
    from tpugan_torch.configs import get_preset
    from tpugan_torch.export import export_generator, load_generator
    from tpugan_torch.ops import convs, cuda_gen2
    from tpugan_torch.sample.sampler import Sampler
    from tpugan_torch.train.trainer import Trainer

    t0 = time.time()
    real = torch.from_numpy(train_data["images"][:TRAIN_BATCH]).to(dev)
    real = real.float() / 127.5 - 1.0
    found = fp32_kernels(dev, real)
    log(f"[fp32] kernels in {time.time() - t0:.1f}s")

    # -- training, fuse_stats on and off from one seed -----------------
    base = get_preset("dcgan_celeba64").override({
        "data.dataset": "synthetic", "data.synthetic_size": 10 * TRAIN_BATCH,
        "train.precision": "fp32", "train.kernels": "pallas",
        "train.ckpt_every": 0, "train.log_every": 1,
        "train.sample_every": 10})
    require(base.model.nz == 100 and base.model.ngf == 64
            and base.model.ndf == 64 and base.data.batch_size == TRAIN_BATCH
            and base.model.d_batchnorm,
            "not the full-width dcgan_celeba64 configuration")
    cfgs = {m: base.override({
        "train.fuse_stats": m,
        "train.out_dir": str(ROOT / "chiprun_out" / f"smoke_fp32_{m}"),
        "train.ckpt_dir": str(RUNS / f"fp32_{m}")}) for m in ("off", "on")}
    zero_counts()
    trs = {m: Trainer(cfgs[m], data=train_data, device=dev) for m in cfgs}
    require(trs["on"].d.blocks[1].conv.dtype == torch.float32,
            "the fp32 run's D is not fp32")
    first = {m: trs[m].train(1) for m in ("off", "on")}
    # fp32 sums in another order in three BN blocks: ~1e-6 relative in the
    # logits; loss_g is taken after D's first Adam update, which moves
    # weights whose gradient is sum-order noise by up to lr: 1e-3
    for k in ("loss_d", "loss_g", "d_real", "d_fake"):
        log(f"[fp32] step 1 {k}: fuse on {first['on'][k]:.7f} off "
            f"{first['off'][k]:.7f}")
        require(abs(first["on"][k] - first["off"][k]) <= 1e-3,
                f"fp32 step 1 {k}: fuse on {first['on'][k]} vs off "
                f"{first['off'][k]}")
    metrics, times = [], {"on": [], "off": []}
    for mode in ("off", "on", "on", "off"):  # in turns, on one card
        times[mode].append(run_steps(trs[mode], 10, train_data, metrics))
    require(bool(torch.isfinite(torch.stack(
        [v for m in metrics for v in m.values()])).all()),
        "non-finite fp32 step metrics")
    counts = read_counts("fp32 train dcgan_celeba64")
    steps_on = trs["on"].state.step
    require(counts["conv_stats"] == 9 * steps_on,
            f"{counts['conv_stats']} kernel-5 launches in {steps_on} fp32 "
            f"steps, not 9 a step")
    # where an fp32 step's device time goes (5 more steps, not counted):
    # kernel 5's is its conv tiles', its weight splits' and its reduce's
    prof = profile_steps(trs["on"], 5, train_data, metrics,
                         "fp32 dcgan_celeba64 fuse_stats=on")
    found["train_on_busy_share"] = prof["busy_share"]
    found["train_on_busy_ms"] = prof["busy_ms"]
    found["train_on_kernel5_ms"] = sum(
        ms for key, ms in prof["by_kernel"].items()
        if any(k in key for k in ("conv_stats", "stats_reduce",
                                  "split_weight")))
    log(f"[fp32] profiled step: {prof['ms']:.4f} ms/step, device busy "
        f"{prof['busy_ms']:.4f} ms ({100 * prof['busy_share']:.1f}%), "
        f"kernel 5 {found['train_on_kernel5_ms']:.4f} ms/step")
    for mode in ("on", "off"):
        ms = sum(times[mode]) / len(times[mode])
        found[f"train_{mode}_ms"] = ms
        log(f"[fp32] train fuse_stats={mode}: {ms:.4f} ms/step "
            f"({TRAIN_BATCH * 1e3 / ms:.1f} images/s; runs "
            f"{', '.join(f'{t:.4f}' for t in times[mode])} ms/step)")

    # -- the trained D in eval mode, "pallas" against "xla" ------------
    g, d, cfg = trs["on"].g.eval(), trs["on"].d.eval(), cfgs["on"]
    sampler = Sampler(cfg, g)
    fake = torch.from_numpy(sampler.sample(TRAIN_BATCH, seed=1)).to(dev)
    zero_counts()
    scores = {}
    with torch.no_grad():
        for impl in ("pallas", "xla"):
            with convs.using_impl(impl):
                scores[impl] = [d(x).float() for x in (real, fake)]
    counts = read_counts("fp32 eval D dcgan_celeba64")
    require(counts["conv_affine_act"] == 2 * len(d.blocks) == 8,
            f"fp32 eval D: {counts['conv_affine_act']} kernel-4 launches "
            f"for 2 forwards")
    for got, ref in zip(scores["pallas"], scores["xla"]):
        err = (got - ref).abs()
        # fp32 sums in another order and BN folded into the epilogue
        require(bool(torch.isfinite(got).all()
                     and (err <= 1e-4 * (1 + ref.abs())).all()),
                f"fp32 eval D: pallas and xla differ by {err.max().item()}")
    found["eval_d_err"] = max((a - b).abs().max().item()
                              for a, b in zip(scores["pallas"],
                                              scores["xla"]))

    # -- the eval G: module path, artifact, Sampler ---------------------
    zn = sampler.noise(BATCH, seed=0)
    zd = torch.from_numpy(zn).to(dev)
    zero_counts()
    with torch.no_grad(), convs.using_impl("pallas"):
        img_p = g(zd).float()
    counts = read_counts("fp32 eval G module path")
    require(counts["convt_affine_act"] == 4, f"fp32 module path: {counts}")
    with torch.no_grad(), convs.using_impl("xla"):
        img_x = g(zd).float()
    found["module_path_err"] = (img_p - img_x).abs().max().item()
    # tanh images: fp32 sums in another order through five layers
    require(found["module_path_err"] <= 1e-4,
            f"fp32 module path pallas vs xla: {found['module_path_err']}")
    art = load_generator(export_generator(cfg, g), device=dev)
    zero_counts()
    img = art.generate(zn)
    counts = read_counts("fp32 artifact generate")
    require(counts["convt_affine_act"] == 4 and counts["v2"] == 0,
            f"fp32 artifact generate({BATCH}): {counts}")
    require(np.array_equal(img, img_p.cpu().numpy()),
            "fp32 artifact vs the module path under pallas")
    found["artifact_generate_ms"] = time_ms(lambda: art.generate(zn), 5)
    zero_counts()
    s_img = sampler.sample(BATCH, seed=0)
    counts = read_counts("fp32 Sampler.sample")
    require(counts["v2"] == 1, f"fp32 Sampler.sample: {counts}")
    with torch.no_grad():
        hd, bl, (ss, cc), zz = cuda_gen2.fold_inputs(g, zd)
        ref = cuda_gen2.depth_to_space(cuda_gen2.generator_forward_plain(
            zz, hd, bl, ss, cc))
    err, ok = image_err(torch.from_numpy(s_img).to(dev), ref)
    require(ok, f"fp32 Sampler.sample against v2's plain version: {err}")
    found["sampler_err"] = err
    found["sampler_sample_ms"] = time_ms(
        lambda: sampler.sample(BATCH, seed=0), 5)
    del trs, g, d, art, sampler

    # -- the CLI test's settings on the card -----------------------------
    out_dir = RUNS / "fp32_cli"
    shutil.rmtree(out_dir, ignore_errors=True)
    sets = ["data.dataset=synthetic", "data.batch_size=8",
            "data.synthetic_size=32", "model.ngf=8", "model.ndf=8",
            "model.nz=8", "train.total_steps=3", "train.log_every=3",
            "train.sample_every=0", "train.ckpt_every=3",
            "train.precision=fp32", "train.kernels=pallas"]
    flags = [a for x in sets for a in ("--set", x)]
    ckpt = str(out_dir / "run" / "ckpt")
    zero_counts()
    final = json.loads(run_cli(dev, "train", "dcgan_mnist", "--out",
                               str(out_dir / "run"), *flags
                               ).strip().splitlines()[-1])["final"]
    read_counts("fp32 cli train dcgan_mnist")
    require(np.isfinite(final["loss_d"]) and np.isfinite(final["loss_g"]),
            f"fp32 cli train: {final}")
    zero_counts()
    run_cli(dev, "sample", "--ckpt", ckpt, "--n", "4", "--seed", "5",
            "--out", str(out_dir / "g.png"))
    counts = read_counts("fp32 cli sample")
    require(counts["v2"] == 1, f"fp32 cli sample: {counts}")
    mcfg, mg, _ = cli._load_generator_from_ckpt(ckpt, dev)
    mg.eval()
    zero_counts()
    served = serve_once(dev, ckpt, {"n": 16, "seed": 4})
    counts = read_counts("fp32 cli serve --ckpt")
    require(counts["convt_affine_act"] == len(mg.blocks) + 1
            and counts["v2"] == 0, f"fp32 serve --ckpt: {counts}")
    local = Sampler(mcfg.override({"train.kernels": "xla"}), mg).sample(
        16, seed=4)
    found["serve_err"] = float(np.abs(served["npy"] - local).max())
    require(found["serve_err"] <= 1e-4,
            f"fp32 serve --ckpt against the module path under xla: "
            f"{found['serve_err']}")
    log(f"[fp32] phase 21 in {time.time() - t0:.1f}s: "
        f"{json.dumps({k: v for k, v in found.items() if not isinstance(v, dict)})}")
    return found


def measure_v2(tree: str) -> int:
    """``--measure-v2 TREE``: megakernel v2 of the port in checkout TREE on
    phase 2's main-path input (``dcgan_celeba64``, batch 256, the seeded
    weights and noise): one JSON line with the image's sha256, the launch's
    ``ms`` and ``device_ms`` on operands made once, and the registers
    ``ptxas`` gave the library's kernels."""
    import hashlib

    import torch

    sys.path.insert(0, str(Path(tree).resolve()))
    from tpugan_torch.ops import _build, cuda_gen2
    from tpugan_torch.sample.sampler import seeded_noise

    require(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    secs, out = _build.build_all()["cuda_gen2"]
    regs = [line.strip() for line in out.splitlines()
            if "registers" in line or "spill" in line]
    cfg, g = make_generator("dcgan_celeba64", dev)
    z = torch.from_numpy(seeded_noise(cfg.model.nz, BATCH, seed=0)).to(dev)
    with torch.no_grad():
        img = cuda_gen2.generator_forward(g, z)
        hd, bl, (ss, cc), zz = cuda_gen2.fold_inputs(g, z)
        zb, hb, bb, cp = cuda_gen2.kernel_operands(
            zz, hd, bl, ss, cc, cuda_gen2.layer_kinds(
                ss, cc, [w.shape[3] for w, _, _ in bl]))
        t = timed(lambda: cuda_gen2.launch(zb, hb, bb, ss, cp), iters=10)
    print(json.dumps(dict(
        tree=str(tree), source=cuda_gen2.__file__, build_s=secs,
        sha256=hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest(),
        **t, ptxas=regs)))
    return 0


def measure_convs(tree: str) -> int:
    """``--measure-convs TREE``: the conv kernels of the port in checkout
    TREE, by layer, on seeded inputs (TF32 off in cuDNN): kernel 4 at fp32
    and bf16 at the four layers of the full-width ``dcgan_celeba64`` eval
    D at batch ``TRAIN_BATCH`` (seeded images in [-1, 1], each layer's
    input the plain version's output of the one before) and the
    conditional D's Cin-4 layer, each with its error against the plain
    version and cuDNN's fp32 call beside; kernel 5 at fp32 and bf16 at the
    three BN layers; kernel 1 at fp32 at the generator's four layers at
    ``BATCH``.  One JSON line of device ms (``graph_ms``) and kernel 4's
    eager ms (``time_ms``)."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(tree).resolve()))
    from tpugan_torch.configs import get_preset
    from tpugan_torch.models.registry import build_discriminator
    from tpugan_torch.ops import (_build, cuda_conv, cuda_conv_stats,
                                  cuda_convt, cuda_gen)
    from tpugan_torch.ops.fused import bn_affine

    require(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    secs = _build.build_all()["cuda_conv"][0]
    gen = torch.Generator(device=dev).manual_seed(0)
    d = build_discriminator(get_preset("dcgan_celeba64").model, "fp32",
                            device=dev, generator=torch.Generator(device=dev)
                            .manual_seed(1)).eval()
    rows = []
    with torch.no_grad():
        x = torch.rand((TRAIN_BATCH, 64, 64, 3), generator=gen,
                       device=dev) * 2 - 1
        x4 = torch.cat([x, torch.ones_like(x[..., :1])], -1).contiguous()
        layers = []
        for blk in d.blocks:
            w = blk.conv.w.float().contiguous()
            if blk.bn is None:
                a, b = torch.ones_like(w[0, 0, 0]), blk.conv.b.float()
            else:
                a, b = bn_affine(blk.bn.scale, blk.bn.bias, blk.bn.mean,
                                 blk.bn.var, blk.bn.eps)
            layers.append((x, w, a, b, blk.act.slope))
            x = cuda_conv.conv_affine_act_plain(x, w, a, b,
                                                leak=blk.act.slope)
        w0, a0, b0, leak0 = layers[0][1:]
        layers.append((x4, torch.cat([w0, w0[:, :, :1]], 2).contiguous(), a0,
                       b0, leak0))
        for x, w, a, b, leak in layers:
            xl = x.permute(0, 3, 1, 2)
            wl = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            xb, wb = x.bfloat16(), w.bfloat16()

            def k4(x=x, w=w, a=a, b=b, leak=leak):
                return cuda_conv.conv_affine_act(x, w, a, b, leak=leak)

            def library(xl=xl, wl=wl, a=a, b=b, leak=leak):
                y = F.conv2d(xl, wl, stride=2, padding=1)
                return F.leaky_relu(y * a.view(1, -1, 1, 1)
                                    + b.view(1, -1, 1, 1), leak)

            ref = cuda_conv.conv_affine_act_plain(x, w, a, b, leak=leak)
            row = dict(
                shape=list(x.shape) + [w.shape[3]],
                k4_f32_device_ms=graph_ms(k4, 20), k4_f32_ms=time_ms(k4, 20),
                cudnn_f32_device_ms=graph_ms(library, 20),
                k4_f32_rel_err=((k4() - ref).abs().max()
                                / ref.abs().max()).item(),
                k4_bf16_device_ms=graph_ms(
                    lambda: cuda_conv.conv_affine_act(xb, wb, a, b,
                                                      leak=leak), 20))
            if x.shape[3] % 64 == 0:  # a BN layer: kernel 5 too
                row["k5_f32_device_ms"] = graph_ms(
                    lambda: cuda_conv_stats.conv_stats(x, w), 20)
                row["k5_bf16_device_ms"] = graph_ms(
                    lambda: cuda_conv_stats.conv_stats(xb, wb), 20)
            rows.append(row)
        cfg, g = make_generator("dcgan_celeba64", dev,
                                {"train.precision": "fp32"})
        _, blocks, _ = cuda_gen.fold_generator(g)
        x = g.head(torch.randn((BATCH, cfg.model.nz), generator=gen,
                               device=dev))
        k1 = []
        for i, (w, a, b) in enumerate(blocks):
            act = "tanh" if i == len(blocks) - 1 else "relu"
            w = w.float().contiguous()
            k1.append(graph_ms(lambda: cuda_convt.convt_affine_act(
                x, w, a, b, act=act), 20))
            x = cuda_convt.convt_affine_act_plain(x, w, a, b, act=act)
    sums = {f"{k}_sum": sum(r[k] for r in rows[:4] if k in r)
            for k in ("k4_f32_device_ms", "k4_f32_ms", "cudnn_f32_device_ms",
                      "k4_bf16_device_ms", "k5_f32_device_ms",
                      "k5_bf16_device_ms")}
    print(json.dumps(dict(tree=str(tree), source=cuda_conv.__file__,
                          card=card(), build_s=secs, **sums,
                          k1_f32_device_ms_sum=sum(k1), k1_f32_device_ms=k1,
                          layers=rows)))
    return 0


def against(other: str) -> int:
    """``--against DIR``: the kernels of the checkout in DIR (the parent
    commit, say) and of this one, in turns on one card (DIR, this, this,
    DIR), each measurement in a process of its own: megakernel v2
    (``--measure-v2``: the same image bits on the same seeded input, each
    run's times and registers) and the conv kernels by layer
    (``--measure-convs``)."""
    runs, convs = [], []
    for tree in (other, ROOT, ROOT, other):
        for mode, into in (("--measure-v2", runs), ("--measure-convs", convs)):
            proc = subprocess.run([sys.executable, __file__, mode, str(tree)],
                                  capture_output=True, text=True, timeout=900)
            require(proc.returncode == 0,
                    f"{mode} {tree} failed:\n{proc.stdout}{proc.stderr}")
            into.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            log(f"[against] {json.dumps(into[-1])}")
    require(len({r["sha256"] for r in runs}) == 1,
            "v2's image differs between the two checkouts")
    for label, pick in (("other", (0, 3)), ("this", (1, 2))):
        log(f"[against] {label}: v2 ms "
            f"{', '.join(str(runs[i]['ms']) for i in pick)}; device_ms "
            f"{', '.join(str(runs[i]['device_ms']) for i in pick)}")
        for key in sorted(k for k in convs[0] if k.endswith("_sum")):
            log(f"[against] {label}: {key} "
                f"{', '.join(str(convs[i][key]) for i in pick)}")
    log("[against] the same image bits in all four runs")
    return 0


# ---------------------------------------------------------------------------
# Phases 16-19: meshes of ranks (``tpugan_torch/parallel``).  The rank
# functions run in processes that ``parallel.multihost.spawn`` starts (they
# import this file as a module); each returns its own launch counts.
# ---------------------------------------------------------------------------

KERNEL_MODS = ("cuda_convt", "cuda_gen", "cuda_gen2", "cuda_conv",
               "cuda_conv_stats", "cuda_threefry")
COUNT_KEYS = ("convt_affine_act", "v1", "v2", "conv_affine_act",
              "conv_stats", "threefry")


def _rank_setup():
    """A rank's process: the package importable, the main process's fp32
    references (no TF32), the launch counters at zero."""
    import importlib

    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = [importlib.import_module(f"tpugan_torch.ops.{m}")
            for m in KERNEL_MODS]
    for m in mods:
        m.launches = 0

    def counts():
        return dict(zip(COUNT_KEYS, (m.launches for m in mods)))

    return counts


def _state_bytes(state) -> int:
    """Bytes this rank holds of G's and D's parameters and both optimizers'
    moments (the EMA is off in these runs)."""
    import torch

    total = 0
    for m, opt in ((state.g, state.opt_g), (state.d, state.opt_d)):
        total += sum(p.numel() * p.element_size() for p in m.parameters())
        for st in opt.state.values():
            total += sum(t.numel() * t.element_size() for t in st.values()
                         if torch.is_tensor(t) and t.dim() > 0)
    return total


def _params(state) -> dict:
    """{name: fp32 numpy} of G's and D's parameters, dense (a collective
    under FSDP: every rank calls it)."""
    sd = state.state_dict()
    return {f"{part}.{k}": v.float().cpu().numpy()
            for part in ("g", "d") for k, v in sd[part].items()}


def _collective_share(tr, batches) -> float:
    """The share of these steps' wall time this rank spends inside
    ``torch.distributed``'s all_reduce, all_gather and broadcast (each
    blocks until its peers arrive: waiting included), by the host's
    clock."""
    import torch
    import torch.distributed as dist

    spent = [0.0]
    names = ("all_reduce", "all_gather", "broadcast")
    saved = {n: getattr(dist, n) for n in names}

    def timed(fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t
        return run

    for n in names:
        setattr(dist, n, timed(saved[n]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            tr.state, _ = tr.step_fn(tr.state, b)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(dist, n, saved[n])
    return spent[0] / total


# Phases 17-18's limits on a mesh run against the single card at steps 1
# and 3 (``held``), by phase: the most share of parameters beyond 1e-5,
# the least cosine of the two runs' updates, and the largest loss
# difference relative to max(1, |loss|).  Each sits between the correct
# mesh run's reading and the nearest planted fault's (``--mesh-tolerance``
# on an H100, PERF.md; the single card run again reads 0 and 1 exactly):
# DP step 1 share 1.2% / 5.6% (local BatchNorm statistics), cosine
# 0.977 / 0.888; step 3 cosine 0.987 / 0.940; spatial step 1 share 2.3% /
# 23.6% (statistics not reduced over space), cosine 0.956 / 0.530, step 3
# cosine 0.963 / 0.633.
MESH_LIMITS = {
    "dp": {1: dict(share=0.03, cos=0.93, loss=1e-2),
           3: dict(share=1.0, cos=0.965, loss=1e-2)},
    "spatial": {1: dict(share=0.05, cos=0.9, loss=1e-2),
                3: dict(share=1.0, cos=0.9, loss=1e-2)},
}

# Faults planted in a mesh run to show what the mesh checks of phases
# 17-18 can see (``--mesh-tolerance``): each replaces one collective of the
# port in the rank's process only.
FAULTS = {
    # each rank steps on its own rows' gradients
    "no gradient all-reduce": ("tpugan_torch.parallel.collectives",
                               "all_reduce_grads", lambda params, group: None),
    # BatchNorm normalizes with each rank's rows' statistics
    "local BatchNorm statistics": ("tpugan_torch.nn.layers", "batch_group",
                                   lambda: None),
    # a weight in sharded compute gets this rank's part of its gradient
    "weight gradients not summed over space": (
        "tpugan_torch.parallel.collectives", "feed_sharded",
        lambda x, group: x),
    # BatchNorm over a shard normalizes with the shard's statistics
    "BatchNorm statistics not reduced over space": (
        "tpugan_torch.parallel.spatial", "bn_groups", lambda x: []),
}


def _plant(fault) -> None:
    import importlib

    if fault is not None:
        module, name, value = FAULTS[fault]
        setattr(importlib.import_module(module), name, value)


def _train_rank(rank, preset, over, held_at, timed_steps, grid,
                fault=None):
    """Phases 17-18 on one rank: the Trainer with the mesh of ``over``,
    trained to each step of ``held_at`` (rank 0 returns the dense
    parameters and the metrics there), then ``timed_steps`` timed steps
    on its rows of each batch (none: not timed), and a grid (the
    Trainer's, or the spatial Sampler against the dense one on the same
    generator); ``fault`` plants one of ``FAULTS`` first."""
    import numpy as np
    import torch

    counts = _rank_setup()
    _plant(fault)
    from tpugan_torch.data.datasets import load_dataset
    from tpugan_torch.sample.sampler import Sampler
    from tpugan_torch.configs import get_preset
    from tpugan_torch.train.trainer import Trainer

    cfg = get_preset(preset).override(over)
    data = load_dataset("synthetic", "", image_size=cfg.model.image_size,
                        channels=3, synthetic_size=cfg.data.synthetic_size,
                        seed=cfg.train.seed)
    tr = Trainer(cfg, data=data, device="cuda")
    out = {"rank": rank, "device": str(tr.device),
           "mesh": tuple((tr.mesh or tr.spatial_mesh).mesh_dim_names),
           "fuse": tr._fuse_mode, "held": {}}
    for step in held_at:
        metrics = tr.train(step)
        params = _params(tr.state)  # (collective under FSDP)
        if rank == 0:
            out["held"][step] = (params, metrics)
    # the moments exist once the optimizers have stepped
    out["state_bytes"] = _state_bytes(tr.state)
    out["memory_allocated"] = torch.cuda.memory_allocated(tr.device)
    out["counts"] = counts()
    if not timed_steps:
        return out
    it = iter(tr._batches(data))
    batches = [next(it) for _ in range(timed_steps)]
    getattr(it, "close", lambda: None)()
    # the step outside train(): under spatial sharding it needs the
    # Trainer's spatial context, which train() holds only while it runs
    with tr._spatial():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            tr.state, m = tr.step_fn(tr.state, b)
        torch.cuda.synchronize()
        out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / timed_steps
        out["collective_share"] = _collective_share(tr, batches[:3])
    out["finite"] = bool(all(np.isfinite(float(v)) for v in m.values()))
    if grid:
        z = Sampler(cfg, tr.g).noise(64, 0)
        imgs = tr._grid(z, None)
        if rank == 0 and tr.spatial_mesh is not None:
            # the same generator through the dense Sampler
            dense = Sampler(cfg.override({"train.spatial_shards": 0}),
                            tr.g).sample_fixed(z)
            out["grid_vs_dense"] = image_err(torch.from_numpy(imgs),
                                             torch.from_numpy(dense))
        out["grid_shape"] = None if imgs is None else imgs.shape
    out["counts"] = counts()
    return out


def _against(got, want, start) -> dict:
    """{step: (max |diff|, share of elements beyond 1e-5, update cosine,
    {loss: (got, want)})} of one run's parameters and metrics
    (``{step: (params, metrics)}``) against another's at each step of
    ``want``, both runs from the parameters ``start``; the cosine is that
    of the two runs' updates since ``start``, all parameters as one
    vector."""
    import numpy as np

    out = {}
    for step, (want_p, want_m) in sorted(want.items()):
        got_p, got_m = got[step]
        names = [k for k in want_p if k in start]  # parameters
        diff = [np.abs(got_p[k] - want_p[k]) for k in names]
        du = np.concatenate([(got_p[k] - start[k]).ravel() for k in names])
        dw = np.concatenate([(want_p[k] - start[k]).ravel() for k in names])
        out[step] = (
            max(float(d.max()) for d in diff),
            sum(int((d > 1e-5).sum()) for d in diff)
            / sum(d.size for d in diff),
            float(du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))),
            {k: (got_m[k], want_m[k]) for k in ("loss_d", "loss_g")})
    return out


def _single_card(cfg, steps, name):
    """The single card's Trainer on ``cfg`` (the synthetic set): (its
    parameters at the start, {step: (parameters, metrics)}, its bytes of
    parameters and moments)."""
    import torch

    from tpugan_torch.data.datasets import load_dataset
    from tpugan_torch.train.trainer import Trainer

    tr = Trainer(cfg.override({"train.ckpt_dir": str(RUNS / name),
                               "train.out_dir": str(RUNS / f"{name}_out")}),
                 data=load_dataset("synthetic", "",
                                   image_size=cfg.model.image_size,
                                   channels=3,
                                   synthetic_size=cfg.data.synthetic_size,
                                   seed=cfg.train.seed),
                 device=torch.device("cuda", 0))
    start = {f"{part}.{k}": p.detach().float().cpu().numpy()
             for part, m in (("g", tr.state.g), ("d", tr.state.d))
             for k, p in m.named_parameters()}
    held = {}
    for step in steps:
        m = tr.train(step)
        held[step] = (_params(tr.state), m)
    state_bytes = _state_bytes(tr.state)
    del tr
    torch.cuda.empty_cache()
    return start, held, state_bytes


def _serve_rank(rank, n, seed):
    """Phase 19 on one rank: ``ShardedSampler`` over every rank under
    "pallas" (rank 0 samples ``n`` images; the others serve its round)."""
    import torch

    counts = _rank_setup()
    from tpugan_torch.parallel import ShardedSampler, make_mesh
    from tpugan_torch.parallel.multihost import rank_device

    dev = rank_device("cuda")
    cfg, g = make_generator("dcgan_celeba64", dev,
                            {"train.kernels": "pallas"})
    s = ShardedSampler(cfg, g, make_mesh(None, "cuda"))
    out = {"rank": rank, "device": str(dev)}
    if rank != 0:
        s.serve()
    else:
        imgs = s.sample(n, seed)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = s.sample(n, seed)
        out["ms"] = (time.perf_counter() - t0) * 1e3
        s.close()
        out["images"] = imgs
    out["counts"] = counts()
    return out


# Phases 17's and 18's runs: full-width ``dcgan_celeba64`` and
# ``dcgan_256_spatial`` at batch 128 on the synthetic set (a mesh forces
# fuse_stats off); each single card reference sets fuse_stats off and no
# spatial sharding.
PHASE17 = {"data.dataset": "synthetic",
           "data.synthetic_size": 10 * TRAIN_BATCH,
           "train.kernels": "pallas", "train.ckpt_every": 0,
           "train.log_every": 1, "train.sample_every": 0,
           "train.fuse_stats": "on"}
PHASE18 = {"data.dataset": "synthetic",
           "data.synthetic_size": 2 * TRAIN_BATCH,
           "data.batch_size": TRAIN_BATCH, "train.ckpt_every": 0,
           "train.log_every": 1, "train.sample_every": 0,
           "train.spatial_shards": 2}


def mesh_tolerance() -> int:
    """``--mesh-tolerance``: the readings that phases 17-18's
    mesh limits sit between.  At steps 1 and 3 of their runs (``PHASE17``
    with ``mesh_shape=2``, ``PHASE18``), against the single card's
    (``_against``): the single card run again from the same seed (cuDNN
    left nondeterministic, as in every run), the correct mesh run, and the
    same mesh run with each fault of ``FAULTS`` planted.  One JSON line a
    reading."""
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpugan_torch.configs import get_preset
    from tpugan_torch.parallel import multihost

    backend2 = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    log(f"[tolerance] {card()}, 2 ranks on {backend2}")
    # (preset, the mesh run's overrides, the single card's)
    runs = (
        ("dcgan_celeba64", {**PHASE17, "train.mesh_shape": 2},
         {**PHASE17, "train.fuse_stats": "off"},
         (None, "no gradient all-reduce", "local BatchNorm statistics")),
        ("dcgan_256_spatial", PHASE18,
         {**PHASE18, "train.spatial_shards": 0},
         (None, "weight gradients not summed over space",
          "BatchNorm statistics not reduced over space")))
    for preset, over, single, faults in runs:
        cfg = get_preset(preset).override(single)
        start, want, _ = _single_card(cfg, (1, 3), "tol_a")
        _, again, _ = _single_card(cfg, (1, 3), "tol_b")
        rows = [("single card, again", _against(again, want, start))]
        for fault in faults:
            ranks = multihost.spawn(
                _train_rank, 2, (preset, {
                    **over, "train.ckpt_dir": str(RUNS / "tol"),
                    "train.out_dir": str(RUNS / "tol_out")}, (1, 3), 0,
                    False, fault), backend=backend2, device="cuda",
                timeout=600)
            rows.append((f"mesh {fault or 'correct'}",
                         _against(ranks[0]["held"], want, start)))
        for label, by_step in rows:
            for step, (worst, share, cos, losses) in by_step.items():
                print(json.dumps({
                    "preset": preset, "run": label, "step": step,
                    "max_abs_diff": worst, "share_beyond_1e-5": share,
                    "update_cosine": cos, "losses": losses}), flush=True)
    log(f"[tolerance] {card()}")
    return 0


def parallel_phases(dev, zero_counts, read_counts, add_counts) -> dict:
    """Phases 16-19 (module docstring); returns their numbers."""
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from tpugan_torch import cli
    from tpugan_torch.configs import get_preset
    from tpugan_torch.data.datasets import load_dataset
    from tpugan_torch.ops import convs, cuda_convt
    from tpugan_torch.parallel import multihost
    from tpugan_torch.sample.sampler import seeded_noise
    from tpugan_torch.train.trainer import Trainer

    found = {}
    cards = torch.cuda.device_count()
    # two ranks: NCCL, one a card, where there are two cards; else gloo,
    # both ranks on the one card, asked for explicitly
    backend2 = "nccl" if cards >= 2 else "gloo"

    def held(label, got, want, cfg, start, limits):
        """A run's parameters and losses against the single card's
        (``_against``) at steps 1 and 3, within ``limits`` (of
        ``MESH_LIMITS``); after step 1 every parameter within 2 lr (Adam's
        first update is +-lr)."""
        lr = max(cfg.optim.lr_g, cfg.optim.lr_d)
        for step, (worst, share, cos, loss) in _against(
                got, want, start).items():
            log(f"[mesh] {label}: step {step} against the single card: "
                f"parameters max |diff| {worst:.3e}, {100 * share:.4f}% "
                f"beyond 1e-5, update cosine {cos:.6f}; losses (run, "
                f"single) {loss}")
            lim = limits[step]
            require((step > 1 or worst <= 2 * lr * 1.001)
                    and share <= lim["share"] and cos >= lim["cos"]
                    and all(abs(a - b) <= lim["loss"] * max(1, abs(b))
                            for a, b in loss.values()),
                    f"{label} step {step}: max {worst}, {share:.4%} beyond "
                    f"1e-5, update cosine {cos}, losses {loss}: outside "
                    f"{lim}")

    # -- 16. world 1: the Trainer in a one-rank NCCL group ----------------
    t0 = time.time()
    cfg16 = get_preset("dcgan_celeba64").override({
        **PHASE17, "train.out_dir": str(RUNS / "mesh1_out")})
    data16 = load_dataset("synthetic", "", image_size=64, channels=3,
                          synthetic_size=cfg16.data.synthetic_size,
                          seed=cfg16.train.seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rdzv = tempfile.mkdtemp(prefix="smoke_rdzv_")
    multihost.initialize_multihost("file://" + rdzv + "/store", 1, 0,
                                   device="cuda")
    require(dist.get_backend() == "nccl", f"phase 16 on {dist.get_backend()}")
    try:
        plain = Trainer(cfg16.override({"train.ckpt_dir":
                                        str(RUNS / "mesh1_plain")}),
                        data=data16, device=dev)
        plain.train(10)
        zero_counts()
        tr16 = Trainer(cfg16.override({"train.mesh_shape": 1,
                                       "train.ckpt_dir":
                                       str(RUNS / "mesh1")}),
                       data=data16, device=dev)
        require(tr16.mesh is not None and tr16._fuse_mode == "on",
                "phase 16: no one-rank mesh, or fuse_stats changed")
        tr16.train(10)
        counts = read_counts("train dcgan_celeba64 mesh_shape=1 (NCCL, "
                             "world 1)")
        require(counts["conv_stats"] == 9 * 10,
                f"world 1: {counts['conv_stats']} kernel-5 launches in 10 "
                f"steps, not 90")
        require(states_equal(plain.state, tr16.state),
                f"world 1: the state differs from the plain Trainer's by "
                f"{max_state_diff(plain.state, tr16.state)}")
        torch.backends.cudnn.deterministic = False
        ms16 = run_steps(tr16, 10, data16)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_ms = run_steps(tr16, 5, data16)
        ev = prof.key_averages()
        kern = [e for e in ev
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern)
        nccl = sum(e.self_device_time_total for e in kern
                   if "nccl" in e.key.lower())
        host_ar = sum(e.count for e in ev if e.key == "c10d::allreduce_")
        found["world1"] = dict(ms_per_step=ms16, prof_ms=prof_ms,
                               nccl_device_share=nccl / max(busy, 1e-9),
                               allreduce_per_step=host_ar / 5)
        log(f"[mesh] 16 world 1, backend nccl, 1 card ({card()}): "
            f"{ms16:.4f} ms/step; kernel 5 {counts['conv_stats'] // 10} "
            f"launches a step; state bit for bit the plain Trainer's after "
            f"10 steps (cuDNN deterministic); profiler: "
            f"{host_ar / 5:.1f} c10d::allreduce_ a step on the host, NCCL "
            f"kernels {nccl / 1e3 / 5:.4f} ms/step of {busy / 1e3 / 5:.4f} "
            f"ms/step device time ({100 * nccl / max(busy, 1e-9):.2f}%: a "
            f"one-rank all-reduce launches no kernel)")
        del plain, tr16
    finally:
        torch.backends.cudnn.deterministic = False
        multihost.shutdown()
        shutil.rmtree(rdzv, ignore_errors=True)
    log(f"[mesh] phase 16 in {time.time() - t0:.1f}s")

    # -- 17. DP and FSDP on 2 ranks ----------------------------------------
    t0 = time.time()
    cfg17 = get_preset("dcgan_celeba64").override(PHASE17)
    require(cfg17.model.ngf == 64 and cfg17.model.ndf == 64
            and cfg17.data.batch_size == TRAIN_BATCH,
            "phase 17: not full-width dcgan_celeba64")
    # the single card's steps 1 and 3: fuse_stats off, as the mesh runs
    # force it
    start17, want17, single_bytes = _single_card(
        cfg17.override({"train.fuse_stats": "off"}), (1, 3), "dp_ref")
    runs17 = {}
    for label, extra in (("DP mesh_shape=2", {"train.mesh_shape": 2}),
                         ("FSDP mesh_shape=1 fsdp_shards=2",
                          {"train.mesh_shape": 1, "train.fsdp_shards": 2})):
        over = {**PHASE17, **extra,
                "train.ckpt_dir": str(RUNS / f"mesh17_{len(runs17)}"),
                "train.out_dir": str(RUNS / f"mesh17_{len(runs17)}_out")}
        ranks = multihost.spawn(_train_rank, 2,
                                ("dcgan_celeba64", over, (1, 3), 10, True),
                                backend=backend2, device="cuda",
                                timeout=600)
        r0 = ranks[0]
        require(all(r["fuse"] == "off" for r in ranks)
                and all(r["finite"] for r in ranks),
                f"{label}: fuse_stats {[r['fuse'] for r in ranks]} or "
                f"non-finite metrics")
        held(label, r0["held"], want17, cfg17, start17, MESH_LIMITS["dp"])
        total = {k: sum(r["counts"][k] for r in ranks) for k in COUNT_KEYS}
        add_counts(f"train dcgan_celeba64 {label} (2 ranks, "
                   f"{backend2})", total)
        require(r0["counts"]["v2"] == 1 and ranks[1]["counts"]["v2"] == 0,
                f"{label}: v2 launches by rank "
                f"{[r['counts']['v2'] for r in ranks]}: the grid is rank "
                f"0's")
        runs17[label] = ranks
        log(f"[mesh] 17 {label}, backend {backend2}, world 2 on "
            f"{min(cards, 2)} card(s) {[r['device'] for r in ranks]} "
            f"({card()}): ms/step by rank "
            f"{[round(r['ms_per_step'], 4) for r in ranks]} (global batch "
            f"{TRAIN_BATCH}); in collectives (host clock, waits "
            f"included) {[round(r['collective_share'], 4) for r in ranks]} "
            f"of a step; parameters + moments held by rank "
            f"{[r['state_bytes'] for r in ranks]} bytes (single card "
            f"{single_bytes}); memory_allocated after step 3 by rank "
            f"{[r['memory_allocated'] for r in ranks]}; launches by rank "
            f"{[r['counts'] for r in ranks]}")
    dp_b = runs17["DP mesh_shape=2"][0]["state_bytes"]
    fsdp_b = runs17["FSDP mesh_shape=1 fsdp_shards=2"][0]["state_bytes"]
    require(fsdp_b < 0.6 * dp_b, f"FSDP holds {fsdp_b} bytes a rank against "
            f"DP's {dp_b}: the shards are not ~half")
    found["dp"] = runs17
    log(f"[mesh] phase 17 in {time.time() - t0:.1f}s")

    # -- 18. spatial: dcgan_256_spatial, spatial_shards=2 -----------------
    t0 = time.time()
    cfg18 = get_preset("dcgan_256_spatial").override(PHASE18)
    require(cfg18.model.image_size == 256 and cfg18.model.ngf == 32
            and cfg18.model.ndf == 32, "phase 18: not full-width "
            "dcgan_256_spatial")
    start18, want18, _ = _single_card(
        cfg18.override({"train.spatial_shards": 0}), (1, 3), "sp_ref")
    m_dense = want18[1][1]
    ranks = multihost.spawn(
        _train_rank, 2, ("dcgan_256_spatial", {
            **PHASE18, "train.ckpt_dir": str(RUNS / "sp"),
            "train.out_dir": str(RUNS / "sp_out")},
            (1, 3), 5, True), backend=backend2, device="cuda", timeout=600)
    r0 = ranks[0]
    require(r0["mesh"] == ("space",) and all(r["finite"] for r in ranks)
            and all(r["collective_share"] > 0 for r in ranks),
            f"phase 18: mesh {r0['mesh']}, collectives' shares "
            f"{[r['collective_share'] for r in ranks]}")
    got_m = r0["held"][1][1]
    for k in ("loss_d", "loss_g", "d_real", "d_fake"):
        log(f"[mesh] 18 step 1 {k}: spatial {got_m[k]:.6f} dense "
            f"{m_dense[k]:.6f}")
        # bf16 activations through 6 + 6 layers: phase 5's 1e-2 bound
        require(abs(got_m[k] - m_dense[k]) <= 1e-2,
                f"phase 18 step 1 {k}: {got_m[k]} vs {m_dense[k]}")
    held("spatial_shards=2", r0["held"], want18, cfg18, start18,
         MESH_LIMITS["spatial"])
    err, ok = r0["grid_vs_dense"]
    require(ok and r0["grid_shape"] == (64, 256, 256, 3),
            f"phase 18: the spatial grid against the dense one: {err}")
    add_counts(f"train dcgan_256_spatial spatial_shards=2 (2 ranks, "
               f"{backend2})",
               {k: sum(r["counts"][k] for r in ranks) for k in COUNT_KEYS})
    found["spatial"] = ranks
    log(f"[mesh] 18 spatial_shards=2, backend {backend2}, world 2 on "
        f"{min(cards, 2)} card(s) ({card()}): ms/step by rank "
        f"{[round(r['ms_per_step'], 4) for r in ranks]} (256 px, batch "
        f"{TRAIN_BATCH}, 5 steps), in collectives "
        f"{[round(r['collective_share'], 4) for r in ranks]} of a step "
        f"(host clock, waits included); a 64-image grid through the spatial "
        f"Sampler against the dense Sampler: max err {err:.3e}; phase 18 in "
        f"{time.time() - t0:.1f}s")

    # -- 19. sharded serving: ShardedSampler, then serve --shards ----------
    t0 = time.time()
    ranks = multihost.spawn(_serve_rank, 2, (BATCH, 0), backend=backend2,
                            device="cuda", timeout=600)
    cfg19, g19 = make_generator("dcgan_celeba64", dev,
                                {"train.kernels": "pallas"})
    z = torch.from_numpy(seeded_noise(cfg19.model.nz, BATCH, 0)).to(dev)
    before = cuda_convt.launches
    with convs.using_impl("pallas"), torch.no_grad():
        want = g19(z).float().cpu().numpy()
    require(cuda_convt.launches - before == 4,
            "the single-card module path: not 4 kernel-1 launches")
    got = ranks[0]["images"]
    exact = bool(np.array_equal(got, want))
    err, ok = image_err(torch.from_numpy(got), torch.from_numpy(want))
    require(ok, f"ShardedSampler.sample({BATCH}) against the module path: "
            f"{err}")
    require(all(r["counts"]["convt_affine_act"] == 2 * 4 for r in ranks),
            f"kernel 1 launches by rank {[r['counts'] for r in ranks]}: "
            f"not 4 a GBlock pass, two passes (warm + timed) a rank")
    add_counts(f"ShardedSampler.sample({BATCH}) pallas (2 ranks, "
               f"{backend2})",
               {k: sum(r["counts"][k] for r in ranks) for k in COUNT_KEYS})
    log(f"[mesh] 19 ShardedSampler, backend {backend2}, world 2 on "
        f"{min(cards, 2)} card(s) ({card()}): sample({BATCH}) "
        f"{ranks[0]['ms']:.4f} ms; kernel 1 launches by rank "
        f"{[r['counts']['convt_affine_act'] for r in ranks]} (4 a GBlock "
        f"pass of {BATCH // 2} images, warm + timed); pixels "
        f"{'bit for bit' if exact else f'within {err:.3e} of'} the "
        f"single-card module path under pallas")
    # serve --shards 2 --ckpt (phase 15's checkpoint): 3 POST /sample
    ckpt = str(RUNS / "cli" / "run" / "ckpt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    served = {"npy": []}

    def client():
        try:
            for _ in range(1200):
                try:
                    with urllib.request.urlopen(url + "/healthz",
                                                timeout=5) as r:
                        served["health"] = json.loads(r.read())
                    break
                except OSError:
                    time.sleep(0.1)
            for seed in range(3):
                req = urllib.request.Request(
                    url + "/sample", method="POST", data=json.dumps(
                        {"n": 16, "seed": seed, "format": "npy"}).encode())
                with urllib.request.urlopen(req, timeout=120) as r:
                    served["npy"].append(np.load(io.BytesIO(r.read())))
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    th = threading.Thread(target=client, daemon=True)
    th.start()
    argv = ["--device", "cuda", "serve", "--ckpt", ckpt, "--shards", "2",
            "--host", "127.0.0.1", "--port", str(port)]
    if backend2 == "gloo":
        argv = ["--backend", "gloo", *argv]
    cli.main(argv)
    th.join(timeout=60)
    require(not th.is_alive() and len(served["npy"]) == 3,
            f"serve --shards 2: {len(served['npy'])} answers of 3")
    cfg_c, g_c, _ = cli._load_generator_from_ckpt(ckpt, dev)
    errs = []
    for seed, img in enumerate(served["npy"]):
        zc = torch.from_numpy(seeded_noise(cfg_c.model.nz, 16, seed)).to(dev)
        with convs.using_impl("pallas"), torch.no_grad():
            ref = g_c.eval()(zc).float().cpu().numpy()
        e, ok = image_err(torch.from_numpy(img), torch.from_numpy(ref))
        require(ok, f"serve --shards: seed {seed} max err {e}")
        errs.append(e)
    log(f"[mesh] 19 serve --shards 2 --ckpt ({backend2}): 3 POST /sample "
        f"answered, each within {max(errs):.3e} of the module path; phase "
        f"19 in {time.time() - t0:.1f}s")
    found["serve_err"] = max(errs)
    return found


# ---------------------------------------------------------------------------
# Phase 20: the six ``examples_torch`` scripts, run as a user runs them
# ---------------------------------------------------------------------------

def _run_example(path: str, argv, cwd: str) -> str:
    """Run the example script at ``path`` as ``__main__`` with ``argv``
    from ``cwd`` in this process; returns what it printed (also echoed)."""
    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    buf = Tee()
    saved = sys.argv, os.getcwd()
    os.chdir(cwd)
    sys.argv = [path, *map(str, argv)]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved[0]
        os.chdir(saved[1])
    return buf.getvalue()


def _counted_rank(rank, fn, args):
    """An example's rank function ``fn``, with this rank's launch counts."""
    counts = _rank_setup()
    return fn(rank, *args), counts()


def _example_process(path, argv, cwd, out):
    """One process of a multi-process example: (ok, what it printed, its
    launch counts) on the queue ``out``."""
    counts = _rank_setup()
    try:
        text = _run_example(path, argv, cwd)
    except BaseException:
        out.put((False, traceback.format_exc(), counts()))
        raise
    out.put((True, text, counts()))


def examples_phase(zero_counts, add_counts) -> None:
    """Phase 20 (module docstring)."""
    import ast
    import socket

    import numpy as np
    import torch

    import chip_smoke as this  # its functions pickle by this name
    from tpugan_torch.ops import (cuda_conv, cuda_conv_stats, cuda_convt,
                                  cuda_gen, cuda_gen2, cuda_threefry)
    from tpugan_torch.parallel import multihost

    work = RUNS / "examples"
    cards = torch.cuda.device_count()
    # two ranks: NCCL, one a card, where there are two cards; else gloo,
    # both on the one card, asked for explicitly
    shared = [] if cards >= 2 else ["--backend", "gloo"]
    mods = dict(zip(COUNT_KEYS, (cuda_convt, cuda_gen, cuda_gen2, cuda_conv,
                                 cuda_conv_stats, cuda_threefry)))
    rank_counts = []
    spawn = multihost.spawn

    def counted_spawn(fn, world, args=(), **kw):
        out = spawn(this._counted_rank, world, (fn, tuple(args)), **kw)
        rank_counts.extend(c for _, c in out)
        return [r for r, _ in out]

    def rate(cwd):
        """(ms/step, steps) of the run's last log window under ``cwd``:
        the global batch over its ``images_per_sec``."""
        recs = [json.loads(line) for line in next(cwd.rglob(
            "metrics.jsonl")).read_text().splitlines()]
        train = [r for r in recs if "images_per_sec" in r]
        bsz = json.loads(next(cwd.rglob("config.json")).read_text())[
            "data"]["batch_size"]
        window = train[-1]["step"] - (train[-2]["step"] if len(train) > 1
                                      else 0)
        return 1e3 * bsz / train[-1]["images_per_sec"], window

    def run(name, argv, check, processes=0):
        """One example from ``work/name``: its wall time, launch deltas
        (this process's and its ranks' or processes', summed) and, where
        it trains, ms/step; ``check(text, cwd)`` holds its output."""
        cwd = work / name
        cwd.mkdir(parents=True)
        path = str(ROOT / "examples_torch" / f"{name}.py")
        zero_counts()
        rank_counts.clear()
        t0 = time.time()
        if processes:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            ctx = multihost.rank_context()
            q = ctx.Queue()
            procs = [ctx.Process(target=this._example_process, args=(
                path, [*argv, "--num-processes", processes, "--process-id",
                       i, "--coordinator", f"127.0.0.1:{port}"],
                str(cwd), q)) for i in range(processes)]
            for p in procs:
                p.start()
            outs, t_end = [], time.time() + 600
            try:
                while len(outs) < processes:
                    try:
                        outs.append(q.get(timeout=1.0))
                    except queue.Empty:
                        require(time.time() < t_end
                                and not any(p.exitcode for p in procs),
                                f"{name}: no result; exit codes "
                                f"{[p.exitcode for p in procs]}")
            finally:
                for p in procs:
                    p.join(timeout=60)
                    if p.is_alive():
                        p.kill()
            require(all(ok for ok, _, _ in outs)
                    and all(p.exitcode == 0 for p in procs),
                    f"{name}: a process failed: "
                    f"{[t for ok, t, _ in outs if not ok]}")
            text = "".join(t for _, t, _ in outs)
            rank_counts.extend(c for _, _, c in outs)
        else:
            multihost.spawn = counted_spawn
            try:
                text = _run_example(path, argv, str(cwd))
            finally:
                multihost.spawn = spawn
        wall = time.time() - t0
        counts = {k: m.launches + sum(c[k] for c in rank_counts)
                  for k, m in mods.items()}
        add_counts(f"example {name}", counts)
        require("False" not in text, f"{name} printed False:\n{text}")
        check(text, cwd)
        ms, window = rate(cwd) if name != "serve_and_query" else (None, 0)
        log(f"[examples] 20 {name} {' '.join(map(str, argv))}: wall "
            f"{wall:.2f}s"
            + (f", {ms:.4f} ms/step over the last log window of {window} "
               f"step(s)" if ms else "")
            + f"; launches {counts}; card {card()}")

    def trained(text, cwd):
        metrics = ast.literal_eval(  # the dict the script prints last
            text.strip().splitlines()[-1].split("final: ")[-1])
        require(all(np.isfinite(v) for v in metrics.values()),
                f"non-finite metrics {metrics}")

    t0 = time.time()
    mnist = work / "train_dcgan_mnist" / "mnist"
    run("train_dcgan_mnist", ["--steps", 20, "--out", mnist],
        lambda text, cwd: (trained(text, cwd), require(
            (mnist / "final_grid.png").is_file(), "no final_grid.png")))
    run("train_wgan_gp_cifar10", ["--steps", 20, "--out", "wgan"],
        lambda text, cwd: (trained(text, cwd), require(
            '"fid"' in (cwd / "wgan" / "metrics.jsonl").read_text(),
            "no eval at the last step")))
    run("data_parallel_training", ["--steps", 20, "--world", 2, *shared],
        trained)
    run("train_256px_spatial", ["--steps", 20, "--width", 32, "--world", 2,
                                *shared], trained)

    def agree(text, cwd):
        done = dict(re.findall(r"\[process (\d)\] done: loss_d=(\S+)",
                               text))
        require(sorted(done) == ["0", "1"] and done["0"] == done["1"],
                f"train_multihost: loss_d by process {done}")

    run("train_multihost", ["--steps", 20, "--out", "mh", *shared], agree,
        processes=2)
    run("serve_and_query", ["--ckpt", mnist / "ckpt"],
        lambda text, cwd: require(
            "served == local for seed 7: True" in text,
            "serve_and_query: no 'served == local ... True'"))
    log(f"[examples] phase 20 in {time.time() - t0:.1f}s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "tpugan_torch" / "csrc").is_dir():
        print(f"chip_smoke: no tpugan_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch.nn.functional as F

    from tpugan_torch.configs import get_preset
    from tpugan_torch.data.datasets import load_dataset
    from tpugan_torch.models.registry import build_discriminator
    from tpugan_torch.ops import (_build, convs, cuda_conv, cuda_conv_stats,
                                  cuda_convt, cuda_gen, cuda_gen2,
                                  cuda_threefry)
    from tpugan_torch.ops.fused import bn_affine
    from tpugan_torch.sample import threefry
    from tpugan_torch.sample.sampler import Sampler, seeded_noise
    from tpugan_torch.ckpt.checkpoint import CheckpointManager
    from tpugan_torch.serve.server import BatchingEngine, make_server
    from tpugan_torch.train import trainer as trainer_mod
    from tpugan_torch.train.trainer import NonFiniteLossError, Trainer

    kernel_mods = (cuda_convt, cuda_gen, cuda_gen2, cuda_conv, cuda_conv_stats,
                   cuda_threefry)

    def zero_counts():
        for mod in kernel_mods:
            mod.launches = 0

    # each path's launches by kernel: counted from zero, read after it
    path_counts = {}

    def add_counts(path: str, counts: dict) -> dict:
        path_counts[path] = counts
        log(f"[paths] launches on {path}: {counts}")
        return counts

    def read_counts(path: str) -> dict:
        return add_counts(path, {
            "convt_affine_act": cuda_convt.launches,
            "v1": cuda_gen.launches, "v2": cuda_gen2.launches,
            "conv_affine_act": cuda_conv.launches,
            "conv_stats": cuda_conv_stats.launches,
            "threefry": cuda_threefry.launches})

    # the plain versions are the references: full fp32 matmuls and convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.time()
    shutil.rmtree(RUNS, ignore_errors=True)  # no earlier run's checkpoints
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.time()
    outputs = _build.build_all()
    log(f"[build] {len(outputs)} kernel libraries in {time.time() - t0:.1f}s")
    for name, (secs, out) in outputs.items():
        log(f"[build] {name}: nvcc {secs:.1f}s")
        for line in out.splitlines():
            if "entry function" in line:  # the kernel's mangled name
                log(f"[build] {name}: {line.split(chr(39))[1][:110]}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}:   {line.strip()}")
    for name in _build.SOURCES:
        _build.load(name)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for mod in (cuda_gen, cuda_gen2):
        res = mod.resident(dev)
        name = mod.__name__.rsplit(".", 1)[1]
        log(f"[build] {name}: {res} blocks resident ({res / sms:g} a SM)")
        require(res >= sms, f"the {name} kernel does not fit one block a SM")

    # -- set-up: the full-width generators --------------------------------
    cfg, g = make_generator("dcgan_celeba64", dev)
    require(cfg.model.nz == 100 and cfg.model.ngf == 64, "not full width")
    require(cfg.train.kernels == "xla", "the preset's sampler runs PyTorch ops")
    log(f"[setup] dcgan_celeba64 nz={cfg.model.nz} ngf={cfg.model.ngf} "
        f"params={sum(p.numel() for p in g.parameters())}")
    z = torch.from_numpy(seeded_noise(cfg.model.nz, BATCH, seed=0)).to(dev)
    head, blocks, (s0, c0) = cuda_gen.fold_generator(g)
    report = {}

    # -- 2. each kernel against its plain version --------------------------
    bf = torch.bfloat16
    with torch.no_grad():
        # (a) per-layer kernel at the four layer shapes, on real activations
        x = cuda_gen.head_plain(z, head, s0, c0).to(bf)
        cases, tot = [], dict(ms=0.0, device_ms=0.0, plain_ms=0.0,
                              library_ms=0.0, library_device_ms=0.0,
                              bound_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
        for i, (w, a, b) in enumerate(blocks):
            act = "tanh" if i == len(blocks) - 1 else "relu"
            wb = w.to(bf).contiguous()
            got = cuda_convt.convt_affine_act(x, wb, a, b, act=act,
                                              out_dtype=bf)
            ref = cuda_convt.convt_affine_act_plain(x, wb, a, b, act=act,
                                                    out_dtype=bf)
            torch.cuda.synchronize()
            err, ok = bf16_err(got, ref)
            require(ok, f"convt layer {i}: max err {err}")
            wl = wb.permute(2, 3, 0, 1).contiguous()
            xl = x.permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW

            def library(xl=xl, wl=wl, a=a, b=b, act=act):
                y = F.conv_transpose2d(xl, wl, stride=2, padding=1)
                y = y * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
                return torch.tanh(y) if act == "tanh" else torch.relu(y)

            n, h, wd, cin = x.shape
            cout = w.shape[3]
            flops = 2 * n * 16 * h * wd * cin * cout
            byt = nbytes(x, wb, a, b) + n * 4 * h * wd * cout * 2
            bms, by = bound_ms(flops, byt)
            c = dict(shape=f"{n}x{h}x{wd}x{cin}->{2 * h}x{2 * wd}x{cout}",
                     **timed(lambda: cuda_convt.convt_affine_act(
                         x, wb, a, b, act=act, out_dtype=bf), library),
                     plain_ms=time_ms(
                         lambda: cuda_convt.convt_affine_act_plain(
                             x, wb, a, b, act=act, out_dtype=bf), 5),
                     bound_ms=bms,
                     bound_by=by, flops=flops, bytes=byt, max_abs_err=err)
            # the wrapper's host time through the registered op against
            # the route without the dispatcher (checks, then the launch)
            c["direct_ms"] = time_ms(lambda: (
                cuda_convt._check(x, wb, a, b, act, bf),
                cuda_convt._launch(x, wb, a, b, act, 0.2, bf)), 20)
            cases.append(c)
            log(f"[kernel] convt_affine_act {json.dumps(c)}")
            log(f"[kernel] convt_affine_act {c['shape']}: {rate(c)}")
            for k in ("ms", "device_ms", "plain_ms", "library_ms",
                      "library_device_ms", "bound_ms"):
                tot[k] += c[k]
            tot["flops"] += flops
            tot["bytes"] += byt
            tot["err"] = max(tot["err"], c["max_abs_err"])
            x = ref

        # the four layers chained, each reading what the one before wrote
        # (as the module path and v2 run them), on the device alone: the
        # yardstick of v2's ConvT layers beside the sum of the replays above
        x0 = cuda_gen.head_plain(z, head, s0, c0).to(bf)
        wbs = [w.to(bf).contiguous() for w, _, _ in blocks]

        def chain():
            y = x0
            for i, (wb, (_, a, b)) in enumerate(zip(wbs, blocks)):
                y = cuda_convt.convt_affine_act(
                    y, wb, a, b, act="tanh" if i == len(blocks) - 1
                    else "relu", out_dtype=bf)
            return y

        host = {k: [round(c[k] - c["device_ms"], 4) for c in cases]
                for k in ("ms", "direct_ms")}
        log(f"[kernel] convt_affine_act host ms a layer (ms - device_ms): "
            f"through the op {host['ms']}, direct {host['direct_ms']}")
        chained = graph_ms(chain, 10)
        log(f"[kernel] convt_affine_act: the {len(blocks)} layers chained "
            f"{chained:.4f} ms on the device; replayed one by one "
            f"{tot['device_ms']:.4f}")
        report["convt_affine_act"] = dict(
            name="convt_affine_act", route="cuda",
            source="tpugan_torch/csrc/cuda_convt.cu",
            replaces="tpugan/ops/pallas_convt.py:108",
            max_abs_err=tot["err"], ms=tot["ms"], device_ms=tot["device_ms"],
            plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
            bound_by=bound_ms(tot["flops"], tot["bytes"])[1],
            library_ms=tot["library_ms"],
            library_device_ms=tot["library_device_ms"], cases=cases)

        # (b) megakernels against their plain versions
        def check_gen(label, module, gz, y, versions):
            hd, bl, (ss, cc), zz = cuda_gen2.fold_inputs(module, gz, y)
            # both kernels' operands, made once, so that "ms" times the
            # launch alone (not the fold, the casts or the depth-to-space)
            zb, hb, bb, cp = cuda_gen.kernel_operands(
                zz, hd, bl, ss, cc, cuda_gen.layer_kinds(
                    ss, cc, [w.shape[3] for w, _, _ in bl]))
            out, images = {}, {}
            for key in versions:
                if key == "v1":
                    mod, image = cuda_gen, lambda t: t  # noqa: E731
                    got = cuda_gen.generator_forward(module, gz)
                    plain = lambda: cuda_gen.generator_forward_plain(  # noqa: E731
                        zz, hd, bl, ss, cc)
                    ref = plain()
                else:
                    mod, image = cuda_gen2, cuda_gen2.depth_to_space
                    got = cuda_gen2.generator_forward(module, gz, y)
                    plain = lambda: cuda_gen2.generator_forward_plain(  # noqa: E731
                        zz, hd, bl, ss, cc)
                    ref = image(plain())
                run = lambda: mod.launch(zb, hb, bb, ss, cp)  # noqa: E731
                torch.cuda.synchronize()
                require(got.shape == ref.shape, f"{key} {label}: shape")
                require(bool(torch.isfinite(got).all()), f"{key}: non-finite")
                err = (got - ref).abs()
                require(image_err(got, ref)[1],
                        f"{key} {label}: max err {err.max().item()} "
                        f"(largest value {ref.abs().max().item()}; limit "
                        f"2^-7 |ref| + 1e-2 max|ref|)")
                # repeated launches: the same bits
                again = [run() for _ in range(3)]
                torch.cuda.synchronize()
                require(all(torch.equal(a, again[0]) for a in again)
                        and torch.equal(image(again[0]), got),
                        f"{key} {label}: repeated launches differ")
                images[key] = got
                flops, byt = gen_work(zz, hd, bl, ss, cc, got.numel())
                bms, by = bound_ms(flops, byt)
                c = dict(case=label, **timed(run, iters=10),
                         **gen_layers(mod, zb, hb, bb, ss, cp),
                         plain_ms=time_ms(plain, 3), library_ms=None,
                         library_device_ms=None,
                         bound_ms=bms, bound_by=by,
                         max_abs_err=err.max().item(),
                         mean_abs_err=err.mean().item(),
                         scale=ref.abs().max().item())
                log(f"[kernel] {key} {json.dumps(c)}")
                out[key] = c
            if "v1" in images:
                # v1 runs v2's tiles in v2's sum order and rounds the image
                # to bf16 (to nearest, ties to even, as torch rounds): a
                # difference is a fault in one of the two instantiations
                v1, v2r = images["v1"], images["v2"].to(bf).float()
                off = (v1 - v1.to(bf).float()).abs()
                require(torch.equal(v1, v1.to(bf).float()),
                        f"v1 {label}: {int((off > 0).sum())} values are not "
                        f"a bf16's (up to {off.max().item()} from one)")
                require(torch.equal(v1, v2r),
                        f"v1 {label}: not v2's image rounded to bf16 "
                        f"({int((v1 != v2r).sum())} values differ, by up to "
                        f"{(v1 - v2r).abs().max().item()})")
                log(f"[kernel] v1 {label}: every value a bf16's, and bit "
                    f"for bit v2's image rounded to bf16")
            return out

        # Both megakernels round the activations to bf16 as the plain
        # versions do (v1 between layers, v2 as matmul operands), v1 its
        # image too; each is held to a limit at the image's own scale
        # (image_err), which a dropped depth stage fails.
        main64 = check_gen("dcgan_celeba64 64px b256", g, z, None,
                           ["v1", "v2"])
        _, g128 = make_generator("cdcgan_celeba128", dev,
                                 {"model.arch": "dcgan", "model.n_classes": 0})
        z128 = torch.from_numpy(seeded_noise(100, 16, seed=1)).to(dev)
        c128 = check_gen("dcgan 128px ngf64 b16", g128, z128, None,
                         ["v1", "v2"])
        del g128
        ccfg, gc = make_generator("cdcgan_celeba64", dev)
        yc = torch.arange(BATCH, device=dev) % ccfg.model.n_classes
        cond64 = check_gen("cdcgan_celeba64 64px b256", gc, z, yc, ["v2"])
        del gc
        # the 32 px generator of sngan_cifar10 / wgan_gp_cifar10 (three
        # ConvT layers) at the Trainer's grid size
        _, g32 = make_generator("sngan_cifar10", dev)
        z32 = torch.from_numpy(seeded_noise(100, 64, seed=2)).to(dev)
        c32 = check_gen("sngan_cifar10 32px b64", g32, z32, None, ["v2"])
        del g32
        # a Trainer grid of dcgan_celeba64 (64 images)
        grid64 = check_gen("dcgan_celeba64 64px b64", g, z[:64], None,
                           ["v2"])
    for key, mod, line, src in (
            ("v1", cuda_gen, "tpugan/ops/pallas_gen.py:194", "cuda_gen.cu"),
            ("v2", cuda_gen2, "tpugan/ops/pallas_gen2.py:209",
             "cuda_gen2.cu")):
        m = main64[key]
        extra = [c128[key]] + ([cond64["v2"], c32["v2"], grid64["v2"]]
                               if key == "v2" else [])
        report[key] = dict(
            name=f"{mod.__name__.rsplit('.', 1)[1]}.generator_forward",
            route="cuda", source=f"tpugan_torch/csrc/{src}", replaces=line,
            max_abs_err=max([m["max_abs_err"]]
                            + [c["max_abs_err"] for c in extra]),
            ms=m["ms"], device_ms=m["device_ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=None,
            library_device_ms=None, cases=[m] + extra)

    # -- 2b. the discriminator's kernels at its four layer shapes ----------
    # dcgan_celeba64 at full width (ndf=64), batch 128, on the synthetic
    # images the train phase uses and a seeded D's activations
    tcfg = get_preset("dcgan_celeba64").override({
        "data.dataset": "synthetic", "data.synthetic_size": 10 * TRAIN_BATCH,
        "train.ckpt_every": 0, "train.kernels": "pallas",
        "train.ckpt_dir": str(RUNS / "train"),
        "train.fuse_stats": "on", "train.log_every": 1,
        "train.sample_every": 10, "train.out_dir": str(ROOT / "chiprun_out"
                                                       / "smoke_train")})
    require(tcfg.model.ndf == 64 and tcfg.data.batch_size == TRAIN_BATCH
            and tcfg.train.precision == "bf16" and tcfg.data.hflip,
            "not the full-width dcgan_celeba64 train configuration")
    train_data = load_dataset("synthetic", "", image_size=64, channels=3,
                              synthetic_size=tcfg.data.synthetic_size,
                              seed=tcfg.train.seed)
    real = torch.from_numpy(train_data["images"][:TRAIN_BATCH]).to(dev)
    real = (real.float() / 127.5 - 1.0).to(bf)
    d0 = build_discriminator(tcfg.model, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1)).eval()
    conv_cases, stats_cases = [], []
    with torch.no_grad():
        x = real
        for i, blk in enumerate(d0.blocks):
            wb = blk.conv.w.to(bf).contiguous()
            cout = wb.shape[3]
            if blk.bn is not None:
                a, b = bn_affine(blk.bn.scale, blk.bn.bias, blk.bn.mean,
                                 blk.bn.var, blk.bn.eps)
            else:
                a, b = torch.ones(cout, device=dev), blk.conv.b.float()
            c, ref = conv_case(x, wb, a, b, model="dcgan_celeba64",
                               layer=i)
            conv_cases.append(c)
            if blk.bn is not None:
                stats_cases.append(stats_case(x, wb, model="dcgan_celeba64",
                                              layer=i))
            x = ref
    # kernel 5 at this slice's new batches: 256 (the flagship,
    # dcgan_celeba64_fast) and 64 (a grad_accum=2 microbatch of 128), on
    # the same seeded D's activations (its eval layers' plain versions)
    batch_stats_cases = []
    with torch.no_grad():
        for nb in (256, 64):
            x = torch.from_numpy(train_data["images"][:nb]).to(dev)
            x = (x.float() / 127.5 - 1.0).to(bf)
            for i, blk in enumerate(d0.blocks):
                wb = blk.conv.w.to(bf).contiguous()
                if blk.bn is not None:
                    batch_stats_cases.append(stats_case(
                        x, wb, model="dcgan_celeba64", layer=i, batch=nb))
                    a, b = bn_affine(blk.bn.scale, blk.bn.bias, blk.bn.mean,
                                     blk.bn.var, blk.bn.eps)
                else:
                    a = torch.ones(wb.shape[3], device=dev)
                    b = blk.conv.b.float()
                x = cuda_conv.conv_affine_act_plain(x, wb, a, b,
                                                    act="leaky_relu")
    # the new paths' kernel-4 shapes: the conditional D's first layer (the
    # image and its label plane, Cin 4: the narrow path) at 64 px, and the
    # spectrally normalized 32 px D's three layers on W / sigma (sigma from
    # a u that two train-mode forwards moved), batch 128, on synthetic
    # images and seeded D's own activations
    data32 = load_dataset("synthetic", "", image_size=32, channels=3,
                          synthetic_size=10 * TRAIN_BATCH,
                          seed=tcfg.train.seed)
    real32 = torch.from_numpy(data32["images"][:TRAIN_BATCH]).to(dev)
    real32 = (real32.float() / 127.5 - 1.0).to(bf)
    new_conv_cases = []
    with torch.no_grad():
        cd0 = build_discriminator(
            get_preset("cdcgan_celeba64").model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(1)).eval()
        y0 = torch.arange(TRAIN_BATCH, device=dev) % 2
        plane = cd0.proj(cd0.embed(y0)).reshape(-1, 64, 64, 1)
        x4 = torch.cat([real, plane.to(bf)], dim=-1)
        c4 = cd0.d.blocks[0].conv
        c, _ = conv_case(x4, c4.w.to(bf).contiguous(),
                         torch.ones(c4.cout, device=dev), c4.b.float(),
                         model="cdcgan_celeba64", layer=0)
        require(c["path"] == "narrow",
                f"the Cin 4 layer runs the {c['path']} path, not narrow")
        new_conv_cases.append(c)
        sd0 = build_discriminator(
            get_preset("sngan_cifar10").model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
        sd0.train()
        for _ in range(2):  # u moves: sigma is the one a trained D uses
            sd0(real32)
        sd0.eval()
        x = real32
        for i, blk in enumerate(sd0.blocks):
            conv = blk.conv
            c, x = conv_case(x, conv.weight().to(bf).contiguous(),
                             torch.ones(conv.cout, device=dev),
                             conv.b.float(), model="sngan_cifar10", layer=i,
                             spectral_norm=True)
            new_conv_cases.append(c)
        del cd0, sd0
    for key, cases, line, src in (
            ("conv_affine_act", conv_cases, "tpugan/ops/pallas_conv.py:86",
             "cuda_conv.cu"),
            ("conv_stats", stats_cases, "tpugan/ops/pallas_conv_stats.py:95",
             "cuda_conv_stats.cu")):
        tot = {k: sum(c[k] for c in cases)
               for k in ("ms", "device_ms", "plain_ms", "library_ms",
                         "library_device_ms", "bound_ms", "flops", "bytes")}
        report[key] = dict(
            name=key, route="cuda", source=f"tpugan_torch/csrc/{src}",
            replaces=line, max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=tot["ms"], device_ms=tot["device_ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=bound_ms(tot["flops"], tot["bytes"])[1],
            library_ms=tot["library_ms"],
            library_device_ms=tot["library_device_ms"], cases=cases)
    # the totals stay dcgan_celeba64's layers at batch 128; the new shapes
    # and batches are cases
    report["conv_affine_act"]["cases"] += new_conv_cases
    report["conv_stats"]["cases"] += batch_stats_cases

    # conv_bn_stats's backward (PyTorch's conv gradients of the unfused VJP)
    # against autograd through the plain composition, at the first BN
    # layer's shape; the plain side takes the same bf16 values in fp32
    with torch.no_grad():
        c0 = d0.blocks[0].conv
        xin = cuda_conv.conv_affine_act_plain(
            real, c0.w.to(bf), torch.ones(c0.cout, device=dev), c0.b.float())
        wb = d0.blocks[1].conv.w.to(bf)
    cw = torch.randn(wb.shape[3], device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))

    def pulled(y, m, v):
        return ((torch.tanh(y.float()) * cw).sum() + (m * cw ** 2).sum()
                + torch.sqrt(v + 1.0).sum())

    xk, wk = xin.clone().requires_grad_(), wb.clone().requires_grad_()
    gx, gw = torch.autograd.grad(
        pulled(*cuda_conv_stats.conv_bn_stats(xk, wk)), (xk, wk))
    xr = xin.float().requires_grad_()
    wr = wb.float().requires_grad_()
    yr = cuda_conv.conv421_plain(xr, wr)
    mr = yr.mean(dim=(0, 1, 2))
    vr = torch.clamp((yr * yr).mean(dim=(0, 1, 2)) - mr * mr, min=0.0)
    gxr, gwr = torch.autograd.grad(pulled(yr, mr, vr), (xr, wr))
    torch.cuda.synchronize()
    # the fused side rounds y, the cotangent and the gradients to bf16
    # (2^-8 relative each): 3e-2 of each gradient's largest entry
    for label, got, ref in (("x", gx, gxr), ("w", gw, gwr)):
        e = (got.float() - ref).abs().max().item()
        log(f"[kernel] conv_bn_stats backward d{label}: max err {e:.3e} "
            f"(scale {ref.abs().max().item():.3e})")
        require(e <= 3e-2 * ref.abs().max().item(),
                f"conv_bn_stats backward d{label}: max err {e}")
    del d0, xk, wk, xr, wr, gx, gw, gxr, gwr

    # -- 2c. the train step's draws: the threefry kernel ------------------
    # a flagship step's three draws (batch 1024, nz 100: the resident
    # batch's indices, the hflip bits, z_d), one launch each, against
    # threefry.py's host draw: randint and bernoulli bit for bit, normal
    # within 3 ulps (the kernel rounds log1p once from double, numpy's
    # float32 log1p is an ulp off that on some inputs, and the erf_inv
    # polynomial carries an ulp of log1p to at most 3); ``plain_ms`` is the
    # host draw with its copy to the card, as the step made it before, on
    # the host's clock; the bound is the bytes written alone
    def ordered(v):
        i = v.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    k_step = threefry.split(threefry.prng_key(3_180_000_007), 8)
    nb = 4 * BATCH
    draws = (
        ("randint", (nb,), k_step[7],
         lambda k, sh: cuda_threefry.randint(k, 0, 202599, sh, dev),
         lambda k, sh: threefry.randint(k, 0, 202599, sh).astype(np.int64)),
        ("bernoulli", (nb, 1, 1, 1), k_step[6],
         lambda k, sh: cuda_threefry.bernoulli(k, 0.5, sh, dev),
         lambda k, sh: threefry.bernoulli(k, 0.5, sh)),
        ("normal", (nb, 100), k_step[1],
         lambda k, sh: cuda_threefry.normal(k, sh, dev),
         lambda k, sh: threefry.normal(k, sh)))
    draw_cases = []
    for label, shape, k, card_draw, host_draw in draws:
        got = card_draw(k, shape)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), host_draw(k, shape)
        require(got.dtype == want.dtype and got.shape == want.shape,
                f"threefry {label}: {got.dtype} {got.shape} against "
                f"{want.dtype} {want.shape}")
        if label == "normal":
            off = np.abs(ordered(got) - ordered(want))
            err, apart = int(off.max()), int((off > 0).sum())
            require(err <= 3, f"threefry normal: {err} ulps from threefry.py")
        else:
            err = apart = int((got != want).sum())
            require(err == 0, f"threefry {label}: {err} values differ")
        byt = got.nbytes
        bms, by = bound_ms(0.0, byt)
        c = dict(case=f"{label} {'x'.join(map(str, shape))}",
                 **timed(lambda k=k, sh=shape: card_draw(k, sh), iters=20),
                 plain_ms=time_host(lambda k=k, sh=shape: torch.from_numpy(
                     host_draw(k, sh)).to(dev), 10),
                 library_ms=None, library_device_ms=None, bound_ms=bms,
                 bound_by=by, flops=0, bytes=byt, max_abs_err=err,
                 values_apart=apart)
        log(f"[kernel] threefry {json.dumps(c)}")
        draw_cases.append(c)
    report["threefry"] = dict(
        name="cuda_threefry draws", route="cuda",
        source="tpugan_torch/csrc/cuda_threefry.cu",
        replaces="tpugan/train/steps.py:462 (jax.random in the jitted step)",
        max_abs_err=max(c["max_abs_err"] for c in draw_cases),
        **{k: sum(c[k] for c in draw_cases)
           for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
        bound_by="bytes", library_ms=None, library_device_ms=None,
        cases=draw_cases)
    tf = report["threefry"]
    log(f"[kernel] threefry: a flagship step's three draws {tf['ms']:.4f} "
        f"ms eagerly, {tf['device_ms']:.4f} ms on the device, against "
        f"{tf['plain_ms']:.4f} ms drawn on the host and copied (normal: "
        f"{draw_cases[2]['max_abs_err']} ulps from threefry.py at most, "
        f"{draw_cases[2]['values_apart']} of {nb * 100} values apart)")

    # -- 3. main path (serving), with the launch counters from zero ---------
    zero_counts()
    t0 = time.time()
    sampler = Sampler(cfg.override({"train.kernels": "pallas"}), g)
    imgs = sampler.sample(BATCH, seed=0)
    t_sample = time.time() - t0
    require(imgs.shape == (BATCH, 64, 64, 3) and imgs.dtype == np.float32,
            f"sample shape {imgs.shape} {imgs.dtype}")
    require(bool(np.isfinite(imgs).all()) and np.abs(imgs).max() <= 1.0,
            "samples not finite in [-1, 1]")
    require(np.array_equal(sampler.sample(BATCH, seed=0), imgs),
            "same seed, different pixels")
    require(np.array_equal(sampler.sample(BATCH, seed=0, batch_size=64),
                           imgs), "batch_size 64 changed the pixels")
    require(not np.array_equal(sampler.sample(8, seed=1), imgs[:8]),
            "another seed gave the same pixels")
    convs.set_default_impl("pallas")
    per_layer = Sampler(cfg, g).sample(BATCH, seed=0)
    convs.set_default_impl("xla")
    torch_ops = Sampler(cfg, g).sample(BATCH, seed=0)
    with torch.no_grad():
        v1 = cuda_gen.generator_forward(g, z).cpu().numpy()
    # the module paths and v1 round activations to bf16 between layers
    # where v2 keeps fp32: 5e-2 max (as the JAX megakernel test), 2e-3 mean
    for label, other in (("per-layer kernel", per_layer), ("v1", v1),
                         ("PyTorch ops", torch_ops)):
        d = np.abs(other - imgs)
        log(f"[main] Sampler(pallas) vs {label}: max {d.max():.3e} "
            f"mean {d.mean():.3e}")
        require(d.max() <= 5e-2 and d.mean() <= 2e-3,
                f"Sampler(pallas) disagrees with {label}")
    log(f"[main] sample(256) first call {t_sample:.2f}s")

    # -- 4. serve -----------------------------------------------------------
    engine = BatchingEngine(sampler, max_batch=64, linger_ms=5)
    srv = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        reqs = [{"n": 16, "seed": 1, "format": "png", "nrow": 4},
                {"n": 8, "seed": 2, "format": "npy"},
                {"n": 40, "seed": 3, "format": "npy"},
                {"n": 5, "seed": 4, "format": "npy"}]
        results = {}

        def post(i, body):
            req = urllib.request.Request(url + "/sample",
                                         data=json.dumps(body).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = (r.status, r.read())

        threads = [threading.Thread(target=post, args=(i, b))
                   for i, b in enumerate(reqs)]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            require(not t.is_alive(), "request hung")
        t_serve = time.time() - t0
        require(len(results) == len(reqs), "a request failed")
        for i, body in enumerate(reqs):
            code, data = results[i]
            require(code == 200, f"request {i}: HTTP {code}")
            if body["format"] == "png":
                require(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
            else:
                got = np.load(io.BytesIO(data))
                want = sampler.sample(body["n"], seed=body["seed"])
                require(np.array_equal(got, want),
                        f"served pixels differ from Sampler.sample for seed "
                        f"{body['seed']}")
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        require(health["ok"] and health["model"]["image_size"] == 64,
                "healthz")
        log(f"[serve] {len(reqs)} concurrent requests in {t_serve:.2f}s; "
            f"stats {health['stats']} latency {health['latency']}")
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()

    counts = read_counts("serving dcgan_celeba64")
    for key in ("convt_affine_act", "v1", "v2"):
        require(counts[key] > 0, f"{key} never launched on the serving path")

    # warm serving, after the serving path's launches are counted (these
    # calls are measurements'): Sampler.sample(256) by CUDA events over
    # warm calls, and each part of it as Sampler.generate runs them: the
    # host's numpy noise draw, z's copy to the card, the fold and the
    # kernel's operands, the v2 launch, the depth-to-space, the copy back
    # and the concatenation of the result (host clock for the numpy parts);
    # beside it the per-layer module path's forward (head on PyTorch ops,
    # four ConvT kernel launches), v2's yardstick
    reps = 5
    mean = lambda v: sum(v) / len(v)  # noqa: E731

    def host_ms(fn):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / reps, out

    def warm_ms(fn):
        return mean([events_ms(fn) for _ in range(reps)])

    total = warm_ms(lambda: sampler.sample(BATCH, seed=0))
    parts = {}
    parts["noise draw"], zn = host_ms(lambda: sampler.noise(BATCH, seed=0))
    parts["z to the card"] = warm_ms(lambda: torch.as_tensor(
        np.array(zn, np.float32), device=dev))
    zd = torch.as_tensor(zn, device=dev)
    with torch.no_grad():
        def operands():
            hd, bl, (ss, cc), zz = cuda_gen2.fold_inputs(g, zd)
            cuda_gen.check_folded(zz, hd, bl, ss, cc)
            kinds = cuda_gen2.layer_kinds(ss, cc,
                                          [w.shape[3] for w, _, _ in bl])
            return cuda_gen2.kernel_operands(zz, hd, bl, ss, cc, kinds), ss

        parts["fold + operands"] = warm_ms(operands)
        (zb, hb, bb, cp), ss = operands()
        parts["v2 launch"] = warm_ms(lambda: cuda_gen2.launch(zb, hb, bb, ss,
                                                              cp))
        phased = cuda_gen2.launch(zb, hb, bb, ss, cp)
        parts["depth-to-space"] = warm_ms(
            lambda: cuda_gen2.depth_to_space(phased))
        img = cuda_gen2.depth_to_space(phased)
        parts["copy back"] = warm_ms(lambda: img.cpu().numpy())
        arr = img.cpu().numpy()
        parts["concatenate"], _ = host_ms(
            lambda: np.concatenate([arr], axis=0))
        gen_ms = warm_ms(lambda: cuda_gen2.generator_forward(g, zd))
        convs.set_default_impl("pallas")
        mod_ms = warm_ms(lambda: g(zd))
        mod_device_ms = graph_ms(lambda: g(zd), 3)
        convs.set_default_impl("xla")
    v2 = main64["v2"]
    log(f"[main] warm Sampler.sample({BATCH}): {total:.4f} ms "
        f"({BATCH * 1e3 / total:.1f} images/s) over {reps} calls; by part: "
        + ", ".join(f"{k} {t:.4f}" for k, t in parts.items())
        + f"; the parts sum to {sum(parts.values()):.4f}, unattributed "
        f"{total - sum(parts.values()):.4f}")
    log(f"[main] generate on the card (cuda_gen2.generator_forward: fold, "
        f"operands, launch, depth-to-space) {gen_ms:.4f} ms; the v2 kernel "
        f"alone {v2['ms']:.4f} ms eager, {v2['device_ms']:.4f} on the device")
    log(f"[main] yardstick: Generator forward under convs \"pallas\" (the "
        f"per-layer module path) {mod_ms:.4f} ms for {BATCH} images, "
        f"{mod_device_ms:.4f} ms on the device (a CUDA graph's replay)")

    # -- 5. train, with the launch counters from zero -----------------------
    zero_counts()

    def trainer(mode):
        c = tcfg.override({"train.fuse_stats": mode, "train.out_dir":
                           str(ROOT / "chiprun_out" / f"smoke_train_{mode}"),
                           "train.ckpt_dir": str(RUNS / f"train_{mode}")})
        return Trainer(c, data=train_data, device=dev)

    t_off, t_on = trainer("off"), trainer("on")
    m_off, m_on = t_off.train(1), t_on.train(1)
    # step 1 from one seed: the same weights, batch and noise.  The fused
    # side takes the BN statistics of the fp32 sums where the unfused side
    # takes them of the bf16-rounded conv output, and the two convs round
    # different elements of y to bf16 (2^-8 relative); through four blocks
    # that moves a logit's mean by ~1e-3: 1e-2 absolute
    for k in ("loss_d", "loss_g", "d_real", "d_fake"):
        log(f"[train] step 1 {k}: fuse on {m_on[k]:.6f} off {m_off[k]:.6f}")
        require(abs(m_on[k] - m_off[k]) <= 1e-2,
                f"step 1 {k}: fuse on {m_on[k]} vs off {m_off[k]}")
    warm = [t.train(3) for t in (t_on, t_off)]  # each ends with a grid
    step_metrics = []

    times = {"on": [], "off": []}
    for mode in ("off", "on", "on", "off"):  # in turns, on one card
        times[mode].append(run_steps(t_on if mode == "on" else t_off, 10,
                                     train_data, step_metrics))
    profile_steps(t_on, 5, train_data, step_metrics,
                  "dcgan_celeba64 fuse_stats=on")
    last = t_on.train(t_on.state.step + 1)  # a logged step and a grid
    for m in [m_on, m_off, last, *warm]:
        require(all(np.isfinite(v) for v in m.values()),
                f"non-finite logged metrics {m}")
    require(bool(torch.isfinite(torch.stack(
        [v for m in step_metrics for v in m.values()])).all()),
        "non-finite step metrics")
    train_counts = {"conv_stats": cuda_conv_stats.launches,
                    "v2": cuda_gen2.launches}
    log(f"[train] launches on the train path: {train_counts} over "
        f"{t_on.state.step} fused steps")
    require(cuda_conv_stats.launches == 9 * t_on.state.step,
            f"{cuda_conv_stats.launches} conv_stats launches in "
            f"{t_on.state.step} steps, not 9 a step")
    require(cuda_gen2.launches > 0, "no sample grid on the train path")
    read_counts("train dcgan_celeba64")
    for mode in ("on", "off"):
        ms = sum(times[mode]) / len(times[mode])
        log(f"[train] fuse_stats={mode}: {ms:.4f} ms/step "
            f"({TRAIN_BATCH * 1e3 / ms:.1f} images/s; runs "
            f"{', '.join(f'{t:.4f}' for t in times[mode])} ms/step)")

    # -- 6. the trained D in eval mode, with the launch counters from zero ---
    def eval_scores(d, inputs, n_blocks, path):
        """Score each (label, D's arguments) of ``inputs`` with the eval-mode
        D ``d`` under the "pallas" impl (one kernel-4 launch a block) and
        the "xla" impl; the logits must agree.  Counters from zero."""
        zero_counts()
        d.eval()
        scores = {}
        with torch.no_grad():
            for impl in ("pallas", "xla"):
                convs.set_default_impl(impl)
                try:
                    scores[impl] = [d(*args).float() for _, args in inputs]
                finally:
                    convs.set_default_impl("xla")
        log(f"[eval] {path}: conv launches: {cuda_conv.launches} for "
            f"{len(inputs)} D forwards")
        require(cuda_conv.launches == len(inputs) * n_blocks,
                f"{cuda_conv.launches} conv launches, not one per block")
        read_counts(path)
        for i, (label, _) in enumerate(inputs):
            got, ref = scores["pallas"][i], scores["xla"][i]
            err = (got - ref).abs()
            log(f"[eval] {path} D({label}) pallas vs xla: max "
                f"{err.max().item():.3e}, mean logit {ref.mean().item():.4f}")
            require(bool(torch.isfinite(got).all()), f"D({label}) non-finite")
            # each block rounds to bf16 at other places (2^-8 relative): the
            # fused kernel rounds once after BN and LeakyReLU, the "xla"
            # impl after the conv, after BN and after the activation
            require(bool((err <= 3e-2 * (1 + ref.abs())).all()),
                    f"D({label}): pallas and xla disagree by "
                    f"{err.max().item()}")

    zero_counts()
    fake = torch.from_numpy(Sampler(tcfg, t_on.g).sample(TRAIN_BATCH, seed=1)
                            ).to(dev)
    eval_scores(t_on.d, [("real", (real,)), ("generated", (fake,))],
                len(t_on.d.blocks), "eval D dcgan_celeba64")

    def slice_cfg(preset: str, run: str, **over):
        """``preset`` at its full width on the synthetic dataset, as phase
        5 runs dcgan_celeba64: a checkpoint at the end of each train() call
        only (under runs/smoke/RUN), grids by megakernel v2, every step
        logged to chiprun_out/smoke_RUN."""
        return get_preset(preset).override({
            "data.dataset": "synthetic",
            "data.synthetic_size": 10 * TRAIN_BATCH,
            "train.ckpt_every": 0, "train.kernels": "pallas",
            "train.log_every": 1,
            "train.out_dir": str(ROOT / "chiprun_out" / f"smoke_{run}"),
            "train.ckpt_dir": str(RUNS / run),
            **{f"train.{k}": v for k, v in over.items()}})

    def logged(cfg) -> list:
        with open(Path(cfg.train.out_dir) / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    def finite(metrics: list, what: str) -> None:
        require(bool(torch.isfinite(torch.stack(
            [v for m in metrics for v in m.values()])).all()),
            f"non-finite step metrics in {what}")

    # -- 7. SNGAN: sngan_cifar10 at full width, then its D in eval mode -----
    zero_counts()
    scfg = slice_cfg("sngan_cifar10", "sngan", sample_every=4)
    require(scfg.model.nz == 100 and scfg.model.ngf == 64
            and scfg.model.ndf == 64 and scfg.data.batch_size == TRAIN_BATCH
            and scfg.model.d_spectral_norm and not scfg.model.d_batchnorm
            and scfg.loss.kind == "hinge" and scfg.loss.n_critic == 1,
            "not the full-width sngan_cifar10 configuration")
    ts = Trainer(scfg, data=data32, device=dev)
    us0 = {k: v.clone() for k, v in ts.d.state_dict().items()
           if k.endswith(".u")}
    require(len(us0) == len(ts.d.blocks) + 1, f"u buffers: {sorted(us0)}")
    sn_logged = ts.train(4)  # a grid after step 4
    sn_metrics = []
    sn_ms = [run_steps(ts, 10, data32, sn_metrics) for _ in range(2)]
    profile_steps(ts, 5, data32, sn_metrics, "sngan_cifar10", top=8)
    require(all(np.isfinite(v) for v in sn_logged.values()),
            f"non-finite logged metrics {sn_logged}")
    finite(sn_metrics, "sngan_cifar10")
    for k, u0 in us0.items():
        # the tail's u has one entry: a unit vector in R^1 stays +-1
        u = ts.d.state_dict()[k]
        require(u.numel() == 1 or not torch.equal(u, u0),
                f"{k} did not move in training")
        require(abs(u.norm().item() - 1.0) <= 1e-5,
                f"{k}: |u| = {u.norm().item()}, not 1")
    counts = read_counts("train sngan_cifar10")
    require(counts["v2"] > 0, "no sample grid on the sngan train path")
    require(counts["conv_affine_act"] == 0 and counts["conv_stats"] == 0,
            "a D kernel launched in the sngan train steps")
    log(f"[sngan] {ts.state.step} steps; ms/step {sn_ms} "
        f"({TRAIN_BATCH * 1e3 / (sum(sn_ms) / len(sn_ms)):.1f} images/s); "
        f"last logged {sn_logged}")
    us1 = {k: ts.d.state_dict()[k].clone() for k in us0}
    fake32 = torch.from_numpy(Sampler(scfg, ts.g).sample(TRAIN_BATCH, seed=1)
                              ).to(dev)
    eval_scores(ts.d, [("real", (real32,)), ("generated", (fake32,))],
                len(ts.d.blocks), "eval D sngan_cifar10")
    for k, u in us1.items():
        require(torch.equal(ts.d.state_dict()[k], u),
                f"{k} moved in an eval-mode forward")
    del ts

    # -- 8. WGAN-GP: wgan_gp_cifar10 at full width under the "pallas" impl --
    zero_counts()
    wcfg = slice_cfg("wgan_gp_cifar10", "wgan_gp", sample_every=10)
    require(wcfg.model.nz == 100 and wcfg.model.ndf == 64
            and wcfg.data.batch_size == TRAIN_BATCH
            and wcfg.loss.kind == "wgan_gp" and wcfg.loss.lambda_gp == 10.0
            and wcfg.loss.n_critic == 5 and not wcfg.model.d_batchnorm
            and wcfg.optim.lr_d == 1e-4 and wcfg.optim.beta2 == 0.9,
            "not the full-width wgan_gp_cifar10 configuration")
    n_critic = wcfg.loss.n_critic
    # the whole run under "pallas": a penalty D that reached kernel 4
    # (forward-only) would raise
    convs.set_default_impl("pallas")
    try:
        tw = Trainer(wcfg, data=data32, device=dev)
        tw.train(2 * n_critic)
        wgp_metrics = []
        wgp_ms = [run_steps(tw, 2 * n_critic, data32, wgp_metrics)
                  for _ in range(2)]
        profile_steps(tw, n_critic, data32, wgp_metrics, "wgan_gp_cifar10",
                      top=8)
    finally:
        convs.set_default_impl("xla")
    counts = read_counts("train wgan_gp_cifar10")
    require(counts["conv_affine_act"] == 0,
            f"{counts['conv_affine_act']} kernel-4 launches in the WGAN-GP "
            f"train steps")
    require(counts["v2"] > 0, "no sample grid on the wgan_gp train path")
    finite(wgp_metrics, "wgan_gp_cifar10")
    rows = logged(wcfg)[-2 * n_critic:]
    require([r["step"] for r in rows] == list(range(1, 2 * n_critic + 1)),
            f"logged steps {[r['step'] for r in rows]}")
    for r in rows:
        require(np.isfinite(r["gp"]) and r["gp"] > 0, f"gp {r}")
        g_step = r["step"] % n_critic == 0
        require((r["loss_g"] != 0.0) == g_step and np.isfinite(r["loss_g"]),
                f"loss_g logged {r['loss_g']} at step {r['step']}")
    require(all(m["gp"].item() > 0 for m in wgp_metrics), "gp not > 0")
    log(f"[wgan_gp] {tw.state.step} steps under \"pallas\"; ms/step "
        f"{wgp_ms} (one D update a step, a G update every {n_critic}); gp "
        f"{[round(r['gp'], 4) for r in rows]}")
    del tw

    # -- 9. conditional: cdcgan_celeba64 at full width, fuse_stats on / off -
    zero_counts()
    cdata = load_dataset("synthetic", "", image_size=64, channels=3,
                         synthetic_size=10 * TRAIN_BATCH,
                         seed=tcfg.train.seed, n_classes=2)
    ccfgs = {m: slice_cfg("cdcgan_celeba64", f"cdcgan_{m}", fuse_stats=m,
                          sample_every=10) for m in ("off", "on")}
    cc = ccfgs["on"]
    require(cc.model.nz == 100 and cc.model.ngf == 64 and cc.model.ndf == 64
            and cc.model.n_classes == 2 and cc.model.embed_dim == 50
            and cc.data.batch_size == TRAIN_BATCH and cc.data.hflip
            and cc.model.d_batchnorm and cc.train.precision == "bf16",
            "not the full-width cdcgan_celeba64 configuration")
    c_tr = {m: Trainer(ccfgs[m], data=cdata, device=dev) for m in ccfgs}
    c_first = {m: c_tr[m].train(1) for m in ("off", "on")}  # and a grid
    for k in ("loss_d", "loss_g", "d_real", "d_fake"):
        log(f"[cdcgan] step 1 {k}: fuse on {c_first['on'][k]:.6f} off "
            f"{c_first['off'][k]:.6f}")
        # phase 5's bound: the two paths round y and take BN's statistics
        # at different places
        require(abs(c_first["on"][k] - c_first["off"][k]) <= 1e-2,
                f"step 1 {k}: fuse on {c_first['on'][k]} vs off "
                f"{c_first['off'][k]}")
    c_metrics = []
    c_times = {"on": [], "off": []}
    for mode in ("off", "on", "on", "off"):  # in turns, on one card
        c_times[mode].append(run_steps(c_tr[mode], 5, cdata, c_metrics))
    profile_steps(c_tr["on"], 5, cdata, c_metrics,
                  "cdcgan_celeba64 fuse_stats=on", top=8)
    finite(c_metrics, "cdcgan_celeba64")
    counts = read_counts("train cdcgan_celeba64")
    steps_on = c_tr["on"].state.step
    require(counts["conv_stats"] == 9 * steps_on,
            f"{counts['conv_stats']} conv_stats launches in {steps_on} "
            f"steps, not 9 a step")
    require(counts["v2"] > 0, "no conditional sample grid")
    require(counts["conv_affine_act"] == 0,
            "kernel 4 launched in the cdcgan train steps")
    for mode in ("on", "off"):
        ms = sum(c_times[mode]) / len(c_times[mode])
        log(f"[cdcgan] fuse_stats={mode}: {ms:.4f} ms/step "
            f"({TRAIN_BATCH * 1e3 / ms:.1f} images/s; runs "
            f"{', '.join(f'{t:.4f}' for t in c_times[mode])} ms/step)")
    cd = c_tr["on"].d
    yr = torch.from_numpy(cdata["labels"][:TRAIN_BATCH]).to(dev).long()
    require(bool((yr == 0).any() and (yr == 1).any()), "one class only")
    cs = Sampler(cc, c_tr["on"].g)
    yf = torch.from_numpy(cs.labels(TRAIN_BATCH, 1)).to(dev).long()
    fake_c = torch.from_numpy(cs.sample(TRAIN_BATCH, seed=1)).to(dev)
    first_in = []
    hook = cd.d.block0.register_forward_pre_hook(
        lambda mod, args: first_in.append(args[0]))
    eval_scores(cd, [("real", (real, yr)), ("generated", (fake_c, yf))],
                len(cd.d.blocks), "eval D cdcgan_celeba64")
    hook.remove()
    x_first = first_in[0].to(bf)
    require(x_first.shape[3] == 4 and cuda_conv.plan(
        x_first, cd.d.block0.conv.cout)[0] == "narrow",
        f"the conditional D's first layer ({tuple(x_first.shape)}) is not "
        f"on the narrow path")
    del c_tr, cd

    # -- 10. the flagship: dcgan_celeba64_fast at full width ----------------
    # FusedProp, 50 steps a call, the dataset resident on the card, batch
    # 256; two calls, a checkpoint after each, the second call profiled
    zero_counts()
    k_fast = 50
    fcfg = get_preset("dcgan_celeba64_fast").override({
        "data.dataset": "synthetic", "data.synthetic_size": 20 * BATCH,
        "train.total_steps": 2 * k_fast, "train.ckpt_every": k_fast,
        "train.profile_steps": 1, "train.log_every": k_fast,
        "train.fuse_stats": "on", "train.kernels": "pallas",
        "train.out_dir": str(RUNS / "fast"),
        "train.ckpt_dir": str(RUNS / "fast_ckpt")})
    require(fcfg.model.nz == 100 and fcfg.model.ngf == 64
            and fcfg.model.ndf == 64 and fcfg.data.batch_size == BATCH
            and fcfg.train.fused_prop and fcfg.data.device_resident
            and fcfg.train.steps_per_call == k_fast
            and fcfg.data.sampling == "replacement"
            and fcfg.train.precision == "bf16" and fcfg.data.hflip,
            "not the full-width dcgan_celeba64_fast configuration")
    fdata = load_dataset("synthetic", "", image_size=64, channels=3,
                         synthetic_size=fcfg.data.synthetic_size,
                         seed=fcfg.train.seed)
    log(f"[fast] resident dataset {fdata['images'].shape} "
        f"{fdata['images'].nbytes / 1e6:.1f} MB")
    ftr = Trainer(fcfg, data=fdata, device=dev)

    def no_pipeline(*args, **kwargs):
        raise AssertionError("the resident run built the host pipeline")

    # no image batch crosses from the host after the upload: the host
    # pipeline is never built
    host_pipeline = trainer_mod.make_input_pipeline
    trainer_mod.make_input_pipeline = no_pipeline
    try:
        fast_logged = ftr.train()
    finally:
        trainer_mod.make_input_pipeline = host_pipeline
    counts = read_counts("train dcgan_celeba64_fast")
    require(ftr.state.step == 2 * k_fast, f"step {ftr.state.step}")
    require(counts["conv_stats"] == 6 * ftr.state.step,
            f"{counts['conv_stats']} conv_stats launches in "
            f"{ftr.state.step} FusedProp steps, not 6 a step")
    # the resident batch's indices, its hflip bits and z_d, on the card
    require(counts["threefry"] == 3 * ftr.state.step,
            f"{counts['threefry']} threefry launches in {ftr.state.step} "
            f"FusedProp steps, not 3 a step")
    require(counts["v2"] > 0, "no sample grid on the flagship's path")
    require(all(np.isfinite(v) for v in fast_logged.values()),
            f"non-finite logged metrics {fast_logged}")
    fast_steps = CheckpointManager(fcfg.train.ckpt_dir).all_steps()
    require(fast_steps == [k_fast, 2 * k_fast],
            f"flagship checkpoints {fast_steps}")
    traces = sorted((RUNS / "fast" / "prof").glob("*.json.gz"))
    require(len(traces) == 1 and traces[0].stat().st_size > 0,
            f"profiler traces {traces}")
    log(f"[fast] {ftr.state.step} steps in {2} calls; checkpoints "
        f"{fast_steps}; trace {traces[0].name} "
        f"{traces[0].stat().st_size / 1e6:.2f} MB; last logged "
        f"{fast_logged}")
    # one call of 50 steps by CUDA events, in turns with a second, then
    # under the profiler (the measurements' launches are not the path's)
    resident = next(iter(ftr._batches(fdata)))
    fast_ms = [events_ms(lambda: ftr.step_fn(ftr.state, resident)) / k_fast
               for _ in range(2)]
    fast_prof = profile_run(lambda: events_ms(
        lambda: ftr.step_fn(ftr.state, resident)) / k_fast, k_fast,
        "dcgan_celeba64_fast", top=10)
    log(f"[fast] {sum(fast_ms) / 2:.4f} ms/step "
        f"({BATCH * 1e3 / (sum(fast_ms) / 2):.1f} images/s; calls "
        f"{', '.join(f'{t:.4f}' for t in fast_ms)} ms/step); under the "
        f"profiler device busy {100 * fast_prof['busy_share']:.1f}%, "
        f"{fast_prof['kernels']:.0f} kernels/step; card {card()}")
    # one FusedProp step's D against one alternating step's from one seed:
    # the same batch and z_d, so the same D update (the G updates differ:
    # FusedProp's uses the pre-update D; and the alternating G step's D
    # forward moves D's BatchNorm statistics a third time, so the
    # parameters are compared)
    one = fcfg.override({"train.steps_per_call": 1, "train.total_steps": 1,
                         "train.profile_steps": 0})
    pair = {m: Trainer(one.override({"train.fused_prop": m == "fused"}),
                       data=fdata, device=dev) for m in ("fused", "alt")}
    zf = torch.from_numpy(seeded_noise(100, BATCH, seed=3)).to(dev)
    fb = {"image": torch.from_numpy(fdata["images"][:BATCH]).to(dev),
          "z_d": zf, "z_g": zf}
    one_m = {m: {k: v.item() for k, v in tr.step_fn(tr.state, fb)[1].items()}
             for m, tr in pair.items()}
    d_diff = max((p - q).abs().max().item() for p, q in zip(
        pair["fused"].d.parameters(), pair["alt"].d.parameters()))
    for k in ("loss_d", "d_real", "d_fake"):
        require(abs(one_m["fused"][k] - one_m["alt"][k]) <= 1e-2,
                f"FusedProp vs alternating step 1 {k}: {one_m}")
    # phase 5's bound, 1e-2, on D's parameters
    require(d_diff <= 1e-2, f"FusedProp's D differs by {d_diff}")
    log(f"[fast] one FusedProp step vs one alternating step, same batch "
        f"and z_d: D's parameters max diff {d_diff:.3e}; losses {one_m}")
    del ftr, pair, resident, fdata

    # -- 11. state and resume: EMA, linear LR, checkpoints -----------------
    # full-width dcgan_celeba64 at batch 128: ema 0.999 and a linear LR that
    # decays from step 5 of 10; a checkpoint every 5 steps.  cuDNN in its
    # deterministic mode, and kernel 5 has no atomics, so a resumed run is
    # the uninterrupted one bit for bit
    zero_counts()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    scfg = tcfg.override({
        "train.ema": 0.999, "optim.schedule": "linear",
        "train.total_steps": 10, "train.ckpt_every": 5,
        "train.sample_every": 0, "train.out_dir": str(RUNS / "state"),
        "train.ckpt_dir": str(RUNS / "state_ckpt")})
    live = Trainer(scfg, data=train_data, device=dev)
    live.train()
    state_steps = CheckpointManager(scfg.train.ckpt_dir).all_steps()
    require(state_steps == [5, 10], f"checkpoints {state_steps}")
    fresh = Trainer(scfg, data=train_data, device=dev)
    require(fresh.restore(scfg.train.ckpt_dir) == 10, "restored step")
    require(states_equal(live.state, fresh.state),
            f"the restored step-10 state differs from the live one by "
            f"{max_state_diff(live.state, fresh.state)}")
    resumed = Trainer(scfg.override({
        "train.ckpt_dir": str(RUNS / "state_resumed")}), data=train_data,
        device=dev)
    require(resumed.restore(scfg.train.ckpt_dir, step=5) == 5, "step 5")
    resumed.train(10)
    lrs = {m: [(tr.state.opt_g.param_groups[0]["lr"],
                tr.state.opt_d.param_groups[0]["lr"])]
           for m, tr in (("live", live), ("resumed", resumed))}
    resume_diff = max_state_diff(live.state, resumed.state)
    require(resumed.state.step == live.state.step == 10
            and np.array_equal(resumed.state.rng, live.state.rng),
            "resumed step or key")
    require(lrs["live"] == lrs["resumed"]
            and 0 < lrs["live"][0][1] < scfg.optim.lr_d,
            f"LRs after the run {lrs}")
    log(f"[state] resume from step 5 to 10 vs the uninterrupted run: key, "
        f"step and LRs {lrs['live']} exact; tensors max diff "
        f"{resume_diff:.3e}")
    require(states_equal(live.state, resumed.state),
            f"the resumed run differs from the uninterrupted one by "
            f"{resume_diff}")
    # grids from the EMA of G (with G's live BN statistics) and from G,
    # both through megakernel v2
    v2_before = cuda_gen2.launches
    gz = Sampler(scfg, live.g).noise(64, seed=0)
    ema_grid = live.sampler().sample_fixed(gz)
    g_grid = Sampler(scfg, live.g).sample_fixed(gz)
    require(cuda_gen2.launches == v2_before + 2, "grids not on v2")
    grid_diff = float(np.abs(ema_grid - g_grid).max())
    require(grid_diff > 0 and np.isfinite(ema_grid).all(),
            f"the EMA grid and G's differ by {grid_diff}")
    log(f"[state] grid from g_ema vs from G: max |diff| {grid_diff:.4f}")
    del fresh, resumed
    # halt_on_nonfinite: one D weight poisoned with NaN
    hcfg = scfg.override({"train.halt_on_nonfinite": True,
                          "train.ckpt_every": 0, "train.log_every": 1,
                          "train.ckpt_dir": str(RUNS / "halt")})
    ht = Trainer(hcfg, data=train_data, device=dev)
    ht.train(2)
    with torch.no_grad():
        ht.d.blocks[1].conv.w[0, 0, 0, 0] = float("nan")
    try:
        ht.train(6)
        halted = ""
    except NonFiniteLossError as e:
        halted = str(e)
    halt_step = CheckpointManager(hcfg.train.ckpt_dir).latest_step()
    require(bool(halted) and halt_step == 3,
            f"halt: {halted!r}, checkpoint at {halt_step}")
    log(f"[state] halt_on_nonfinite: {halted}")
    del ht
    # SIGTERM from a thread mid-run: a checkpoint, train() returns, resume
    pcfg = scfg.override({"train.total_steps": 100_000,
                          "train.ckpt_every": 0, "train.log_every": 0,
                          "train.ckpt_dir": str(RUNS / "preempt")})
    pt = Trainer(pcfg, data=train_data, device=dev)
    handler = signal.getsignal(signal.SIGTERM)

    def preempt():
        while pt.state.step < 3:
            time.sleep(0.01)
        os.kill(os.getpid(), signal.SIGTERM)

    sender = threading.Thread(target=preempt, daemon=True)
    sender.start()
    pt.train()
    sender.join(timeout=60)
    stopped = pt.state.step
    require(not sender.is_alive() and 3 <= stopped < 100_000,
            f"SIGTERM: stopped at {stopped}")
    require(signal.getsignal(signal.SIGTERM) is handler,
            "the SIGTERM handler was not put back")
    require(CheckpointManager(pcfg.train.ckpt_dir).latest_step() == stopped,
            "no checkpoint at the preempted step")
    rt = Trainer(pcfg.override({"train.resume": pcfg.train.ckpt_dir}),
                 data=train_data, device=dev)
    rt.train(stopped + 2)
    require(rt.state.step == stopped + 2, f"resumed to {rt.state.step}")
    log(f"[state] SIGTERM at step {stopped}: checkpoint saved, train() "
        f"returned; resumed to {rt.state.step}")
    del pt, rt
    # the card's step-10 checkpoint restores into a CPU Trainer
    cpu_tr = Trainer(scfg, data=train_data, device="cpu")
    require(cpu_tr.restore(scfg.train.ckpt_dir, step=10) == 10, "CPU step")
    require(states_equal(live.state, cpu_tr.state),
            "the card's checkpoint restored on the CPU differs")
    log("[state] the card's step-10 checkpoint restored into a CPU Trainer "
        "bit for bit")
    torch.backends.cudnn.deterministic = False
    counts = read_counts("train dcgan_celeba64 ema + linear + resume")
    require(counts["conv_stats"] > 0 and counts["v2"] > 0,
            "phase 11 launched no kernel 5 or no v2")
    del live, cpu_tr

    # -- 12. grad_accum and remat: dcgan_celeba64, batch 128 ---------------
    zero_counts()
    acfg = tcfg.override({"train.grad_accum": 2, "train.sample_every": 0,
                          "train.out_dir": str(RUNS / "accum"),
                          "train.ckpt_dir": str(RUNS / "accum_ckpt")})
    at = Trainer(acfg, data=train_data, device=dev)
    accum_logged = at.train(3)
    counts = read_counts("train dcgan_celeba64 grad_accum=2")
    require(counts["conv_stats"] == 18 * at.state.step,
            f"{counts['conv_stats']} conv_stats launches in "
            f"{at.state.step} steps under grad_accum=2, not 18 a step")
    require(all(np.isfinite(v) for v in accum_logged.values()),
            f"non-finite logged metrics {accum_logged}")
    del at
    mem, first = {}, {}
    rtr = {}
    for mode in ("plain", "remat"):
        zero_counts()
        rtr[mode] = Trainer(tcfg.override({
            "train.remat": mode == "remat", "train.sample_every": 0,
            "train.out_dir": str(RUNS / mode),
            "train.ckpt_dir": str(RUNS / f"{mode}_ckpt")}),
            data=train_data, device=dev)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        first[mode] = rtr[mode].train(1)
        peak = torch.cuda.max_memory_allocated(dev)
        mem[mode] = (peak, peak - before)
        counts = read_counts(f"train dcgan_celeba64 {mode}")
    # remat: 9 launches in the forwards and 9 in the recomputed ones (the
    # D step's real and fake forwards, the G step's fake forward)
    require(counts["conv_stats"] == 18,
            f"{counts['conv_stats']} conv_stats launches in a remat step, "
            f"not 9 + 9 recomputed")
    for k in ("loss_d", "loss_g", "d_real", "d_fake"):
        require(abs(first["remat"][k] - first["plain"][k]) <= 1e-2,
                f"remat step 1 {k}: {first}")
    p_diff = max((p - q).abs().max().item() for p, q in zip(
        rtr["remat"].d.state_dict().values(),
        rtr["plain"].d.state_dict().values()))
    p_diff = max(p_diff, max((p - q).abs().max().item() for p, q in zip(
        rtr["remat"].g.state_dict().values(),
        rtr["plain"].g.state_dict().values())))
    require(p_diff <= 1e-2, f"remat's step 1 differs by {p_diff}")
    log(f"[remat] step 1 remat vs plain: losses {first}; G and D max diff "
        f"{p_diff:.3e}; 18 conv_stats launches (9 + 9 recomputed)")
    log(f"[remat] peak memory (max_memory_allocated, then above what was "
        f"allocated before the step): plain {mem['plain'][0] / 2**20:.1f} / "
        f"{mem['plain'][1] / 2**20:.1f} MiB, remat "
        f"{mem['remat'][0] / 2**20:.1f} / {mem['remat'][1] / 2**20:.1f} MiB; "
        f"card {card()}")
    del rtr

    # -- 13. data: the dataset files on the card's machine ------------------
    # MNIST idx, CIFAR-10 pickles and a CelebA-layout folder of PNGs at the
    # aligned 178 x 218 geometry, written from the synthetic set under
    # runs/smoke/data, then read back through the port's readers
    from concurrent.futures import ThreadPoolExecutor
    import gzip
    import pickle
    import struct

    from PIL import Image

    from tpugan_torch.data import native
    from tpugan_torch.utils.images import encode_png

    ddir = RUNS / "data"
    ddir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    mn = load_dataset("synthetic", "", image_size=28, channels=1,
                      synthetic_size=N_FILES, seed=3, n_classes=10)
    for fname, arr, magic in (
            ("train-images-idx3-ubyte.gz", mn["images"][..., 0], 0x803),
            ("train-labels-idx1-ubyte.gz",
             mn["labels"].astype(np.uint8), 0x801)):
        with gzip.open(ddir / fname, "wb") as f:
            f.write(struct.pack(">I", magic))
            f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
            f.write(arr.tobytes())
    cf = load_dataset("synthetic", "", image_size=32, channels=3,
                      synthetic_size=5 * 1024, seed=4, n_classes=10)
    cdir = ddir / "cifar-10-batches-py"
    cdir.mkdir(exist_ok=True)
    for i in range(5):
        part = slice(1024 * i, 1024 * (i + 1))
        with open(cdir / f"data_batch_{i + 1}", "wb") as f:
            pickle.dump({b"data": cf["images"][part].transpose(
                0, 3, 1, 2).reshape(1024, -1), b"labels": [
                    int(v) for v in cf["labels"][part]]}, f)
    # CelebA: synthetic images made at 218 px, cropped to 178 wide, and
    # their two classes as the attribute file's Male column
    ce = load_dataset("synthetic", "", image_size=218, channels=3,
                      synthetic_size=N_FILES, seed=5, n_classes=2)
    celeb = np.ascontiguousarray(ce["images"][:, :, 20:198])
    fdir = ddir / "img_align_celeba"
    fdir.mkdir(exist_ok=True)
    names = [f"{i:06d}.png" for i in range(N_FILES)]

    def write_png(i):
        (fdir / names[i]).write_bytes(encode_png(celeb[i]))

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_png, range(N_FILES)))
    with open(ddir / "list_attr_celeba.txt", "w") as f:
        f.write(f"{N_FILES}\nSmiling Male Young\n")
        for name, y in zip(names, ce["labels"]):
            f.write(f"{name} -1 {1 if y else -1} 1\n")
    log(f"[data] wrote MNIST {mn['images'].shape}, CIFAR-10 "
        f"{cf['images'].shape}, {N_FILES} PNGs {celeb.shape[1:]} in "
        f"{time.time() - t0:.1f}s")
    got = load_dataset("mnist", str(ddir), image_size=28, channels=1)
    require(np.array_equal(got["images"], mn["images"])
            and np.array_equal(got["labels"], mn["labels"]),
            "MNIST read back differs")
    got = load_dataset("mnist", str(ddir), image_size=64, channels=3)
    m64 = got["images"]
    require(m64.shape == (N_FILES, 64, 64, 3)
            and np.array_equal(m64[..., 0], m64[..., 2])
            and abs(float(m64.mean()) - float(mn["images"].mean())) < 1.0,
            f"MNIST at 64 px x 3: {m64.shape}, mean {m64.mean()}")
    got = load_dataset("cifar10", str(ddir), image_size=32, channels=3)
    require(np.array_equal(got["images"], cf["images"])
            and np.array_equal(got["labels"], cf["labels"]),
            "CIFAR-10 read back differs")
    t0 = time.time()
    ram = load_dataset("celeba", str(ddir), image_size=64, channels=3,
                       streaming="off")
    ram_s = time.time() - t0
    require(np.array_equal(ram["labels"], ce["labels"]), "CelebA labels")
    # the reader's crop and resize are PIL's: the middle 178 rows, bilinear
    for i in (0, N_FILES // 2, N_FILES - 1):
        ref = np.asarray(Image.fromarray(celeb[i, 20:198]).resize(
            (64, 64), Image.BILINEAR))
        require(np.array_equal(ram["images"][i], ref), f"CelebA image {i}")
    stream = load_dataset("celeba", str(ddir), image_size=64, channels=3,
                          streaming="on")["images"]
    require(stream.decoded_count == 0, "the streaming folder decoded early")
    order = np.random.default_rng(6).permutation(N_FILES)
    for lo in range(0, N_FILES, TRAIN_BATCH):
        require(np.array_equal(stream.gather(order[lo:lo + TRAIN_BATCH]),
                               ram["images"][order[lo:lo + TRAIN_BATCH]]),
                f"streaming batch at {lo} differs from in RAM")
    require(stream.decoded_count == N_FILES, "decoded_count")
    idx = order[:TRAIN_BATCH]
    flip = (np.arange(TRAIN_BATCH) % 3 == 0).astype(np.uint8)
    require(np.array_equal(native.batch_gather(ram["images"], idx, flip),
                           native.batch_gather_plain(ram["images"], idx,
                                                     flip)),
            "the C++ gather differs from numpy")
    host_ms = {
        "streaming decode": time_host(lambda: stream.gather(idx), 5),
        "C++ gather": time_host(
            lambda: native.batch_gather(ram["images"], idx), 50),
        "numpy gather": time_host(
            lambda: native.batch_gather_plain(ram["images"], idx), 50)}
    stream.close()
    log(f"[data] read back bit for bit (MNIST, CIFAR-10, the folder in RAM "
        f"and streaming); in-RAM decode of {N_FILES} PNGs {ram_s:.2f}s; host "
        f"ms per batch of {TRAIN_BATCH}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in host_ms.items())
        + f" ({TRAIN_BATCH * 1e3 / host_ms['streaming decode']:.0f} "
        f"images/s decoded); card {card()}")
    del mn, cf, ce, celeb

    # -- 14. the small-data path: cdcgan_celeba64 from the PNG folder ------
    # full width, batch 128, hflip; DiffAugment + ADA (p moves 0.0128 a
    # step), FID (proxy, 2048 samples in 8 v2 launches) every 10 steps with
    # keep_best; streaming and in RAM, a resume from step 10 bit for bit
    from tpugan_torch.eval.evaluate import evaluate
    from tpugan_torch.eval.features import make_extractor
    from tpugan_torch.eval.fid import (fid_from_features, inception_score,
                                       kid_from_features)

    def small_cfg(run: str, **over):
        return get_preset("cdcgan_celeba64").override({
            "data.dataset": "celeba", "data.data_dir": str(ddir),
            "train.kernels": "pallas", "train.fuse_stats": "on",
            "train.augment": "color,translation,cutout",
            "train.ada_target": 0.6, "train.ada_kimg": 10,
            "train.eval_every": 10, "train.keep_best": True,
            "eval.fid_n": N_FILES, "eval.fid_batch": 256,
            "eval.metric": "proxy", "train.total_steps": 20,
            "train.log_every": 1, "train.sample_every": 10,
            "train.ckpt_every": 10,
            "train.out_dir": str(ROOT / "chiprun_out" / f"smoke_{run}"),
            "train.ckpt_dir": str(RUNS / run), **over})

    def check_small(tr, cfg, label):
        """The small-data run's logged record: finite losses and FIDs, ADA
        following its rule, best/ and the watermark."""
        rows = logged(cfg)
        train_rows = [r for r in rows if "loss_d" in r]
        fids = [r for r in rows if "fid" in r]
        require([r["step"] for r in train_rows] == list(range(1, 21)),
                f"{label}: logged steps {[r['step'] for r in train_rows]}")
        require(all(np.isfinite(r[k]) for r in train_rows
                    for k in ("loss_d", "loss_g", "ada_p", "ada_rt")),
                f"{label}: non-finite metrics")
        p_prev = 0.0
        for r in train_rows:  # p moves by sign(rt - target) * 0.0128
            want = min(max(p_prev + np.sign(r["ada_rt"] - 0.6) * 0.0128,
                           0.0), 1.0)
            require(abs(r["ada_p"] - want) <= 1e-6,
                    f"{label}: ada_p {r['ada_p']} at step {r['step']}, "
                    f"want {want}")
            p_prev = r["ada_p"]
        ps = [r["ada_p"] for r in train_rows]
        require(max(ps) > 0 and all(0 <= p <= 1 for p in ps),
                f"{label}: ada_p never moved off 0: {ps}")
        require([r["step"] for r in fids] == [10, 20]
                and all(np.isfinite(r["fid"]) for r in fids),
                f"{label}: FIDs {fids}")
        meta = tr._load_best_meta()
        best = Path(cfg.train.ckpt_dir) / "best"
        require(meta is not None and (best / f"{meta['step']}.pt").exists(),
                f"{label}: best/ {sorted(os.listdir(best))}, watermark "
                f"{meta}")
        log(f"[small] {label}: ada_p {ps[0]:.4f} -> {ps[-1]:.4f} (max "
            f"{max(ps):.4f}), r_t {train_rows[-1]['ada_rt']:.4f}; FID "
            f"{[round(r['fid'], 4) for r in fids]}; best {meta}")
        return train_rows

    zero_counts()
    scfg = small_cfg("small_stream", **{"data.streaming": "on"})
    require(scfg.model.nz == 100 and scfg.model.ngf == 64
            and scfg.model.ndf == 64 and scfg.model.embed_dim == 50
            and scfg.data.batch_size == TRAIN_BATCH and scfg.data.hflip
            and scfg.model.d_batchnorm and scfg.loss.kind == "bce",
            "not the full-width cdcgan_celeba64 configuration")
    t0 = time.time()
    st_tr = Trainer(scfg, device=dev)
    st_tr.train()
    st_s = time.time() - t0
    counts = read_counts("train cdcgan_celeba64 from files, streaming, "
                         "augment + ADA + FID")
    require(counts["conv_stats"] == 9 * 20,
            f"{counts['conv_stats']} conv_stats launches in 20 steps")
    require(counts["v2"] == 2 * (N_FILES // 256) + 2,
            f"{counts['v2']} v2 launches: not 8 a FID tick and a grid each "
            f"of 2 ticks")
    check_small(st_tr, scfg, "streaming")
    images = st_tr._dataset()["images"]
    log(f"[small] streaming: {images.decoded_count} PNGs decoded in 20 "
        f"steps and 2 FID ticks ({st_s:.1f}s with set-up)")
    images.close()
    del st_tr

    # in RAM, cuDNN deterministic: 10 steps, the run's checkpoint directory
    # copied, 10 more; then the copy resumed to 20
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    zero_counts()
    rcfg = small_cfg("small_ram", **{"data.streaming": "off"})
    ram_tr = Trainer(rcfg, device=dev)
    ram_tr.train(10)
    snap = RUNS / "small_resumed"
    shutil.copytree(rcfg.train.ckpt_dir, snap)
    ram_tr.train(20)
    counts = read_counts("train cdcgan_celeba64 from files, in RAM, "
                         "augment + ADA + FID")
    require(counts["conv_stats"] == 9 * 20 and counts["v2"] == 18,
            f"in-RAM run launches {counts}")
    check_small(ram_tr, rcfg, "in RAM")
    zero_counts()
    res_cfg = rcfg.override({"train.ckpt_dir": str(snap),
                             "train.resume": str(snap),
                             "train.out_dir": str(ROOT / "chiprun_out"
                                                  / "smoke_small_resumed")})
    res_tr = Trainer(res_cfg, device=dev)
    res_tr.train(20)
    counts = read_counts("train cdcgan_celeba64 resumed from step 10")
    require(counts["conv_stats"] == 9 * 10 and counts["v2"] == 9,
            f"resumed run launches {counts}")
    require(states_equal(ram_tr.state, res_tr.state),
            f"the run resumed from step 10 differs from the uninterrupted "
            f"one by {max_state_diff(ram_tr.state, res_tr.state)}")
    wm = (ram_tr._load_best_meta(), res_tr._load_best_meta())
    require(wm[0] == wm[1], f"watermarks differ: {wm}")
    log(f"[small] resumed from step 10 to 20: key, step, ada_p "
        f"{res_tr.state.ada_p.item():.4f}, ada_rt "
        f"{res_tr.state.ada_rt.item():.6f}, parameters, moments and the "
        f"watermark {wm[1]} bit for bit")
    torch.backends.cudnn.deterministic = False
    del res_tr

    # ms per step with augment + ADA against the same run without, in turns
    zero_counts()
    ram_data = ram_tr._dataset()
    plain_tr = Trainer(rcfg.override({
        "train.augment": "", "train.ada_target": 0.0, "train.eval_every": 0,
        "train.keep_best": False}), data=ram_data, device=dev)
    aug_ms = {"plain": [], "augment + ADA": []}
    small_metrics = []
    for mode in ("plain", "augment + ADA", "augment + ADA", "plain"):
        tr = plain_tr if mode == "plain" else ram_tr
        aug_ms[mode].append(run_steps(tr, 10, ram_data, small_metrics))
    finite(small_metrics, "cdcgan_celeba64 augment + ADA timing")
    profile_steps(ram_tr, 5, ram_data, small_metrics,
                  "cdcgan_celeba64 augment + ADA", top=10)
    read_counts("train cdcgan_celeba64 augment + ADA timed")
    mean_ms = {k: sum(v) / len(v) for k, v in aug_ms.items()}
    log(f"[small] ms/step: augment + ADA {mean_ms['augment + ADA']:.4f}, "
        f"plain {mean_ms['plain']:.4f} (+"
        f"{mean_ms['augment + ADA'] - mean_ms['plain']:.4f} ms; runs "
        f"{aug_ms}); card {card()}")
    del plain_tr

    # evaluate() by part: v2 sampling, features, host FID / KID / IS
    zero_counts()
    g_eval = ram_tr._gen_module()
    ext = make_extractor(3, "proxy", device=dev)
    ecfg = rcfg
    parts = {}
    t0 = time.perf_counter()
    fake = Sampler(ecfg, g_eval).sample(N_FILES, seed=0, batch_size=256)
    parts["v2 sampling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feat_fake, probs_fake = ext(fake, batch=256)
    feat_real, _ = ext(ram_data["images"][:N_FILES].astype(np.float32)
                       / 127.5 - 1.0, batch=256)
    parts["features (fake + real)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid_val = fid_from_features(feat_real, feat_fake)
    kid_from_features(feat_real, feat_fake)
    inception_score(probs_fake)
    parts["host FID + KID + IS"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = evaluate(ecfg, g_eval, seed=0, real_images=ram_data["images"])
    parts["evaluate() (real features cached)"] = time.perf_counter() - t0
    counts = read_counts("evaluate cdcgan_celeba64")
    require(counts["v2"] == 2 * (N_FILES // 256), f"evaluate launches "
            f"{counts}")
    require(abs(scores["fid"] - fid_val) <= 1e-6 * max(1.0, abs(fid_val)),
            f"evaluate() FID {scores['fid']} vs its parts' {fid_val}")
    log(f"[small] evaluate() of {N_FILES} samples by part (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; FID {fid_val:.4f}; card {card()}")
    del ram_tr, g_eval

    # -- 14b. the extractors and the augmentation, card against CPU --------
    from tpugan_torch.eval import features, inception
    from tpugan_torch.ops import augment

    x256 = ram_data["images"][:256].astype(np.float32) / 127.5 - 1.0
    fc, pc = ext(x256, batch=256)
    fr, pr = make_extractor(3, "proxy", device="cpu")(x256, batch=256)
    err = float(np.abs(fc - fr).max() / np.abs(fr).max())
    require(err <= 1e-4 and float(np.abs(pc - pr).max()) <= 1e-3,
            f"proxy features card vs CPU: {err}")
    proxy_ms = time_host(lambda: ext(x256, batch=256), 5)
    params = inception.init_random(0)
    x64 = x256[:64]
    inc_c = features.inception_extractor(params, device=dev)
    ic, _ = inc_c(x64)
    ir, _ = features.inception_extractor(params, device="cpu")(x64)
    inc_err = float(np.abs(ic - ir).max() / np.abs(ir).max())
    require(inc_err <= 1e-4, f"InceptionV3 card vs CPU: {inc_err}")
    inc_ms = time_host(lambda: inc_c(x64), 3)
    xt = torch.from_numpy(x256[:TRAIN_BATCH])
    key = threefry.prng_key(7)
    policy = ("color", "translation", "cutout")
    aug_err = {}
    for dt in (torch.float32, bf):
        ref = augment.apply_policy(xt.to(dt), key, policy, 0.6).float()
        got = augment.apply_policy(xt.to(dt).to(dev), key, policy,
                                   torch.tensor(0.6, device=dev))
        aug_err[str(dt)] = (got.float().cpu() - ref).abs().max().item()
        tol = 1e-6 if dt == torch.float32 else 2.0 ** -7 * ref.abs().max()
        require(aug_err[str(dt)] <= tol, f"apply_policy {dt}: {aug_err}")
    aug_ms_batch = time_host(lambda: augment.apply_policy(
        xt.to(dev), key, policy, torch.tensor(0.6, device=dev)), 20)
    log(f"[extract] proxy card vs CPU on 256 images: max rel {err:.2e}, "
        f"{proxy_ms:.4f} ms per batch of 256; InceptionV3 (init_random) "
        f"on 64 images at 64 px -> 299: max rel {inc_err:.2e}, "
        f"{inc_ms:.4f} ms per batch of 64; apply_policy card vs CPU max "
        f"|diff| {aug_err}, {aug_ms_batch:.4f} ms per batch of "
        f"{TRAIN_BATCH} (host draws included); card {card()}")
    del ram_data

    # -- 15. the CLI and the exported generator ----------------------------
    t0 = time.time()
    cli_found = cli_phase(dev, zero_counts, read_counts)
    prof = cli_found["profile"]
    ms = {k: round(v, 4) for k, v in cli_found.items() if k.endswith("_ms")}
    log(f"[cli] phase 15 in {time.time() - t0:.1f}s; artifact generate("
        f"{BATCH}) {ms['artifact_generate_ms']} ms (4 kernel-1 launches) "
        f"against Sampler.generate {ms['sampler_generate_ms']} ms (one v2 "
        f"launch); artifact sample {ms['artifact_sample_ms']} ms, "
        f"Sampler.sample {ms['sampler_sample_ms']} ms; unroll=4 "
        f"{ms['unroll4_ms']} ms against unroll=1 {ms['unroll1_ms']} ms for "
        f"{4 * BATCH} images (xla; medians of 5 rounds), their copy back "
        f"alone {ms['copy_back_ms']} ms; profile {prof['ms_per_step']} ms/step, "
        f"{prof['images_per_sec']} images/s, "
        f"{prof['flops_per_step']:.4e} FLOPs/step; card {card()}")

    # -- 16-19. meshes of ranks --------------------------------------------
    t0 = time.time()
    torch.cuda.empty_cache()
    parallel_phases(dev, zero_counts, read_counts, add_counts)
    log(f"[mesh] phases 16-19 in {time.time() - t0:.1f}s; card {card()}")

    # -- 20. the six examples ----------------------------------------------
    torch.cuda.empty_cache()
    examples_phase(zero_counts, add_counts)

    # -- 21. fp32 operands: train.precision="fp32" under "pallas" ------------
    torch.cuda.empty_cache()
    fp32_found = fp32_phase(dev, train_data, zero_counts, read_counts)

    # -- 22. report ---------------------------------------------------------
    for key, rep_k in report.items():
        by_path = {p: c[key] for p, c in path_counts.items() if c[key]}
        rep_k["launches"] = sum(by_path.values())
        rep_k["launches_by_path"] = by_path
        if key in fp32_found:  # kernels 1, 4, 5: their fp32 case
            fp32_found[key]["launches"] = sum(
                n for p, n in by_path.items() if p.startswith("fp32 "))
            rep_k["cases"].append(fp32_found[key])
    order = ("name", "route", "source", "replaces", "launches",
             "launches_by_path", "max_abs_err", "ms", "device_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library_device_ms",
             "cases")
    kernels = [{k: report[key][k] for k in order}
               for key in ("convt_affine_act", "v1", "v2", "conv_affine_act",
                           "conv_stats", "threefry")]
    for k in kernels:  # the headers each source builds with
        k["includes"] = includes(k["source"].rsplit("/", 1)[1])
    log(f"[done] total {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--measure-v2"]:
        sys.exit(measure_v2(sys.argv[2]))
    if sys.argv[1:2] == ["--measure-convs"]:
        sys.exit(measure_convs(sys.argv[2]))
    if sys.argv[1:2] == ["--against"]:
        sys.exit(against(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-tolerance"]:
        sys.exit(mesh_tolerance())
    sys.exit(main())
