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
   layer's rate and share of its bound on both measures, and the conv +
   BN-statistics kernel's depth split against its alternatives;
3. drive the main path at full width (``dcgan_celeba64``: nz=100, ngf=64,
   random weights from a seeded ``torch.Generator``, BN running stats from a
   few train-mode forwards): ``Sampler.sample(256)`` under
   ``train.kernels="pallas"`` against the per-layer-kernel module path, the
   v1 megakernel and the PyTorch-ops module path, plus determinism;
4. serve it: ``BatchingEngine`` + ``make_server`` on 127.0.0.1, concurrent
   ``POST /sample`` (png and npy) and ``GET /healthz``; npy pixels must equal
   ``Sampler.sample`` for the same seed;
5. train: ``Trainer`` on full-width ``dcgan_celeba64`` (batch 128, the
   synthetic dataset, ``fuse_stats="on"``, ``kernels="pallas"``): step 1's
   losses against a ``fuse_stats="off"`` run from the same seed, then
   timed steps of both, in turns, exactly 9 conv + BN-stats launches per
   step (3 BN blocks x 3 train-mode D forwards), finite losses, and a
   ``torch.profiler`` window: device time by kernel and the device's busy
   share of a step;
6. score a real and a generated batch with the trained D in eval mode under
   ``set_default_impl("pallas")`` (one fused conv kernel per block) against
   the "xla" impl.

Phases 3-4, 5 and 6 are the three paths: each zeroes the launch counters
just before it and reads them just after, and every kernel must have
launched on its path.  The last lines are the ``kernels`` JSON, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.  Exits
non-zero without a CUDA device or without the ``tpugan_torch`` package
beside this file.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM dense peaks (NVIDIA data sheet), at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

BATCH = 256
TRAIN_BATCH = 128


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
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


def fp32_err(got, ref) -> tuple[float, bool]:
    """(max |got - ref|, within the limit) for two fp32 sums of the same
    bf16 products in another order: ~sqrt(depth) * 2^-24 of the layer's
    scale (depth <= 4096 here), so 1e-4 of its largest value."""
    err = (got - ref).abs().max().item()
    return err, err <= 1e-4 * ref.abs().max().item()


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
    from tpugan_torch.data.pipeline import make_input_pipeline
    from tpugan_torch.models.registry import (build_discriminator,
                                              build_generator)
    from tpugan_torch.ops import (_build, convs, cuda_conv, cuda_conv_stats,
                                  cuda_convt, cuda_gen, cuda_gen2)
    from tpugan_torch.ops.fused import bn_affine
    from tpugan_torch.sample import threefry
    from tpugan_torch.sample.sampler import Sampler, seeded_noise
    from tpugan_torch.serve.server import BatchingEngine, make_server
    from tpugan_torch.train.trainer import Trainer

    kernel_mods = (cuda_convt, cuda_gen, cuda_gen2, cuda_conv, cuda_conv_stats)

    def zero_counts():
        for mod in kernel_mods:
            mod.launches = 0

    # the plain versions are the references: full fp32 matmuls and convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.time()
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

    # -- set-up: the full-width generators --------------------------------
    def make(preset, overrides=None, seed=0):
        cfg = get_preset(preset).override(overrides or {})
        gen = torch.Generator(device=dev).manual_seed(seed)
        g = build_generator(cfg.model, cfg.train.precision, device=dev,
                            generator=gen)
        cond = cfg.model.arch == "cdcgan"
        with torch.no_grad():
            g.train()
            for i in range(3):  # BN running stats from train-mode forwards
                z = torch.randn(BATCH, cfg.model.nz, device=dev, generator=gen)
                if cond:
                    y = torch.randint(0, cfg.model.n_classes, (BATCH,),
                                      device=dev, generator=gen)
                    g(z, y)
                else:
                    g(z)
        return cfg, g.eval()

    cfg, g = make("dcgan_celeba64")
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
        def check_gen(label, module, gz, y, tol, versions):
            hd, bl, (ss, cc), zz = cuda_gen2.fold_inputs(module, gz, y)
            # the kernel's operands cast once, so that "ms" times the launch
            # alone (not the fold, the casts or the depth-to-space)
            zb = zz.to(bf).contiguous()
            hb = (hd[0].to(bf).contiguous(), hd[1], hd[2])
            bb = [(w.to(bf).contiguous(), a, b) for w, a, b in bl]
            n, cf, p = gz.shape[0], bl[-1][0].shape[3], 2 ** len(bl)
            out = {}
            for key in versions:
                if key == "v1":
                    got = cuda_gen.generator_forward(module, gz)
                    ref = cuda_gen.generator_forward_plain(zz, hd, bl, ss, cc)
                    lib, shape = "cuda_gen", (n, ss * p, ss * p, cf)
                    plain = lambda: cuda_gen.generator_forward_plain(  # noqa: E731
                        zz, hd, bl, ss, cc)
                else:
                    got = cuda_gen2.generator_forward(module, gz, y)
                    ref = cuda_gen2.depth_to_space(
                        cuda_gen2.generator_forward_plain(zz, hd, bl, ss, cc))
                    lib, shape = "cuda_gen2", (p, p, n, ss, ss, cf)
                    plain = lambda: cuda_gen2.generator_forward_plain(  # noqa: E731
                        zz, hd, bl, ss, cc)
                fn = lib.replace("cuda_", "tg_") + "_forward"
                run = lambda: cuda_gen.launch(  # noqa: E731
                    lib, fn, zb, hb, bb, ss, cc, shape)
                torch.cuda.synchronize()
                require(got.shape == ref.shape, f"{key} {label}: shape")
                require(bool(torch.isfinite(got).all()), f"{key}: non-finite")
                err = (got - ref).abs()
                require(err.max().item() <= tol,
                        f"{key} {label}: max err {err.max().item()} > {tol}")
                flops, byt = gen_work(zz, hd, bl, ss, cc, got.numel())
                bms, by = bound_ms(flops, byt)
                c = dict(case=label, **timed(run, iters=10),
                         plain_ms=time_ms(plain, 3), library_ms=None,
                         library_device_ms=None,
                         bound_ms=bms, bound_by=by,
                         max_abs_err=err.max().item(),
                         mean_abs_err=err.mean().item())
                log(f"[kernel] {key} {json.dumps(c)}")
                out[key] = c
            return out

        # v1 rounds every activation and the image to bf16, so one flipped
        # bf16 ulp deep in the net can move a pixel by ~1e-2: 5e-2, the JAX
        # megakernel test's bound.  v2 keeps fp32 activations (bf16 only as
        # matmul operands) and an fp32 image: 3e-2.
        main64 = check_gen("dcgan_celeba64 64px b256", g, z, None, 5e-2,
                           ["v1", "v2"])
        _, g128 = make("cdcgan_celeba128", {"model.arch": "dcgan",
                                            "model.n_classes": 0})
        z128 = torch.from_numpy(seeded_noise(100, 16, seed=1)).to(dev)
        c128 = check_gen("dcgan 128px ngf64 b16", g128, z128, None, 3e-2,
                         ["v2"])
        del g128
        ccfg, gc = make("cdcgan_celeba64")
        yc = torch.arange(BATCH, device=dev) % ccfg.model.n_classes
        cond64 = check_gen("cdcgan_celeba64 64px b256", gc, z, yc, 3e-2, ["v2"])
        del gc
    for key, mod, line, src in (
            ("v1", cuda_gen, "tpugan/ops/pallas_gen.py:194", "cuda_gen.cu"),
            ("v2", cuda_gen2, "tpugan/ops/pallas_gen2.py:209",
             "cuda_gen2.cu")):
        m = main64[key]
        extra = [c128["v2"], cond64["v2"]] if key == "v2" else []
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
        "train.fuse_stats": "on", "train.log_every": 1,
        "train.sample_every": 10, "train.out_dir": str(ROOT / "chiprun_out"
                                                       / "smoke_train")})
    require(tcfg.model.ndf == 64 and tcfg.data.batch_size == TRAIN_BATCH
            and tcfg.train.precision == "bf16" and tcfg.data.hflip,
            "not the full-width dcgan_celeba64 train configuration")
    train_data = load_dataset("synthetic", image_size=64, channels=3,
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
            got = cuda_conv.conv_affine_act(x, wb, a, b, act="leaky_relu")
            ref = cuda_conv.conv_affine_act_plain(x, wb, a, b,
                                                  act="leaky_relu")
            # the bare conv's fp32 output: the sums themselves, unrounded
            got32 = cuda_conv.conv2d(x, wb)
            ref32 = cuda_conv.conv421_plain(x, wb)
            torch.cuda.synchronize()
            err, ok = bf16_err(got, ref)
            err32, ok32 = fp32_err(got32, ref32)
            require(ok and ok32,
                    f"conv layer {i}: max err {err} (bf16 out, largest value "
                    f"{ref.float().abs().max().item()}), {err32} (fp32 out, "
                    f"largest value {ref32.abs().max().item()})")
            xl = x.permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW
            wl = wb.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)

            def library(xl=xl, wl=wl, a=a, b=b):
                y = F.conv2d(xl, wl, stride=2, padding=1)
                return F.leaky_relu(y * a.view(1, -1, 1, 1)
                                    + b.view(1, -1, 1, 1), 0.2)

            flops, byt = conv_work(x, wb, nbytes(a, b, got))
            bms, by = bound_ms(flops, byt)
            n, h, wd, cin = x.shape
            shape = f"{n}x{h}x{wd}x{cin}->{h // 2}x{wd // 2}x{cout}"
            c = dict(shape=shape, **timed(
                lambda: cuda_conv.conv_affine_act(x, wb, a, b), library),
                plain_ms=time_ms(lambda: cuda_conv.conv_affine_act_plain(
                    x, wb, a, b), 5),
                bound_ms=bms, bound_by=by,
                flops=flops, bytes=byt, max_abs_err=err,
                scale=ref.float().abs().max().item(), fp32_max_abs_err=err32,
                fp32_scale=ref32.abs().max().item())
            conv_cases.append(c)
            log(f"[kernel] conv_affine_act {json.dumps(c)}")
            log(f"[kernel] conv_affine_act {shape}: {rate(c)}")
            if blk.bn is not None:
                y, mean, var = cuda_conv_stats.conv_stats(x, wb)
                yr, mr, vr = cuda_conv_stats.conv_stats_plain(x, wb)
                torch.cuda.synchronize()
                ey, ok = bf16_err(y, yr)
                require(ok, f"conv_stats layer {i}: y max err {ey}")
                # statistics of the fp32 sums on both sides, summed in
                # another order; var = E[y^2] - mean^2 loses a few bits
                em = (mean - mr).abs()
                ev = (var - vr).abs()
                require(bool((em <= 1e-5 + 1e-4 * mr.abs()).all()),
                        f"conv_stats layer {i}: mean max err {em.max()}")
                require(bool((ev <= 1e-5 + 1e-3 * vr.abs()).all()),
                        f"conv_stats layer {i}: var max err {ev.max()}")

                def library_stats(xl=xl, wl=wl):
                    y = F.conv2d(xl, wl, stride=2, padding=1)
                    return y, torch.var_mean(y, dim=(0, 2, 3), correction=0)

                flops, byt = conv_work(x, wb, nbytes(y, mean, var))
                flops += 3 * y.numel()  # the sums of y and y^2
                bms, by = bound_ms(flops, byt)
                c = dict(shape=shape, **timed(
                    lambda: cuda_conv_stats.conv_stats(x, wb), library_stats),
                    plain_ms=time_ms(
                        lambda: cuda_conv_stats.conv_stats_plain(x, wb), 5),
                    bound_ms=bms,
                    bound_by=by, flops=flops, bytes=byt,
                    max_abs_err=max(ey, em.max().item(), ev.max().item()),
                    scale=yr.float().abs().max().item())
                # the depth split against its alternatives (the plan's
                # choice is the one the main path runs)
                steps = 16 * -(-cin // 64)
                c["split_ms"] = {
                    s: graph_ms(lambda s=s: cuda_conv_stats._launch(
                        x, wb, splits=s), 20)
                    for s in (1, 2, 4) if steps % s == 0 and steps >= 8 * s}
                c["splits"] = cuda_conv_stats.plan(x, cout)[1]
                stats_cases.append(c)
                log(f"[kernel] conv_stats {json.dumps(c)}")
                log(f"[kernel] conv_stats {shape}: {rate(c)}; depth split "
                    f"{c['splits']}, ms by split {c['split_ms']}")
            x = ref
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

    counts = {"convt_affine_act": cuda_convt.launches, "v1": cuda_gen.launches,
              "v2": cuda_gen2.launches}
    log(f"[main] launches on the serving path: {counts}")
    for key, n in counts.items():
        require(n > 0, f"{key} never launched on the serving path")
        report[key]["launches"] = n

    # -- 5. train, with the launch counters from zero -----------------------
    zero_counts()

    def trainer(mode):
        c = tcfg.override({"train.fuse_stats": mode, "train.out_dir":
                           str(ROOT / "chiprun_out" / f"smoke_train_{mode}")})
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

    def run_steps(tr, n):
        """ms per step of n train steps fed by the input pipeline, as the
        Trainer runs them (logging and grids aside)."""
        it = iter(make_input_pipeline(train_data, TRAIN_BATCH,
                                      seed=tcfg.train.seed,
                                      with_labels=False, device=dev,
                                      start_step=tr.state.step))
        batches = [next(it)]  # the pipeline's prefetch, as in steady state

        def body():
            for i in range(n):
                tr.state, m = tr.step_fn(tr.state, batches[i])
                step_metrics.append(m)
                if i + 1 < n:
                    batches.append(next(it))

        ms = events_ms(body) / n
        it.close()
        return ms

    times = {"on": [], "off": []}
    for mode in ("off", "on", "on", "off"):  # in turns, on one card
        times[mode].append(run_steps(t_on if mode == "on" else t_off, 10))
    # where a fused step's time goes: device time by kernel, and the
    # device's busy share of the step (the rest is the host's)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = run_steps(t_on, 5)
    # kernel rows only: an operator's row repeats its kernels' device time
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / 5
    log(f"[profile] fuse_stats=on: {prof_ms:.4f} ms/step under the profiler,"
        f" device busy {busy:.4f} ms/step ({100 * busy / prof_ms:.1f}%), "
        f"{sum(e.count for e in kern) / 5:.0f} kernels/step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / 5:8.4f} ms/step "
            f"{e.count / 5:6.1f}/step  {e.key[:90]}")
    k_draw = threefry.split(t_on.state.rng, 8)[1]
    t0 = time.perf_counter()
    for _ in range(10):
        threefry.normal(k_draw, (TRAIN_BATCH, tcfg.model.nz))
    log(f"[profile] host: one {TRAIN_BATCH}x{tcfg.model.nz} threefry normal "
        f"draw in numpy {(time.perf_counter() - t0) * 100:.3f} ms "
        f"(two a step)")
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
    report["conv_stats"]["launches"] = cuda_conv_stats.launches
    for mode in ("on", "off"):
        ms = sum(times[mode]) / len(times[mode])
        log(f"[train] fuse_stats={mode}: {ms:.4f} ms/step "
            f"({TRAIN_BATCH * 1e3 / ms:.1f} images/s; runs "
            f"{', '.join(f'{t:.4f}' for t in times[mode])} ms/step)")

    # -- 6. the trained D in eval mode, with the launch counters from zero ---
    zero_counts()
    d = t_on.d.eval()
    fake = torch.from_numpy(Sampler(tcfg, t_on.g).sample(TRAIN_BATCH, seed=1)
                            ).to(dev)
    scores = {}
    with torch.no_grad():
        for impl in ("pallas", "xla"):
            convs.set_default_impl(impl)
            scores[impl] = [d(x).float() for x in (real, fake)]
    convs.set_default_impl("xla")
    log(f"[eval] conv launches: {cuda_conv.launches} for 2 D forwards")
    require(cuda_conv.launches == 2 * len(d.blocks),
            f"{cuda_conv.launches} conv launches, not one per block")
    report["conv_affine_act"]["launches"] = cuda_conv.launches
    for i, label in enumerate(("real", "generated")):
        got, ref = scores["pallas"][i], scores["xla"][i]
        err = (got - ref).abs()
        log(f"[eval] D({label}) pallas vs xla: max {err.max().item():.3e}, "
            f"mean logit {ref.mean().item():.4f}")
        require(bool(torch.isfinite(got).all()), f"D({label}) non-finite")
        # each block rounds to bf16 at other places (2^-8 relative): the
        # fused kernel rounds once after BN and LeakyReLU, the "xla" impl
        # after the conv, after BN and after the activation
        require(bool((err <= 3e-2 * (1 + ref.abs())).all()),
                f"D({label}): pallas and xla disagree by {err.max().item()}")

    # -- 7. report ----------------------------------------------------------
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "library_device_ms", "cases")
    kernels = [{k: report[key][k] for k in order}
               for key in ("convt_affine_act", "v1", "v2", "conv_affine_act",
                           "conv_stats")]
    log(f"[done] total {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
