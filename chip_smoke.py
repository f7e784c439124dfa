#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``tpugan_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (no exception is caught):

1. build the CUDA kernels of ``tpugan_torch/csrc`` (one nvcc per source, in
   parallel) and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, in bf16, with the tolerance stated, and time kernel,
   plain version and (where one exists) one PyTorch library call of the
   same function;
3. drive the main path at full width (``dcgan_celeba64``: nz=100, ngf=64,
   random weights from a seeded ``torch.Generator``, BN running stats from a
   few train-mode forwards): ``Sampler.sample(256)`` under
   ``train.kernels="pallas"`` against the per-layer-kernel module path, the
   v1 megakernel and the PyTorch-ops module path, plus determinism;
4. serve it: ``BatchingEngine`` + ``make_server`` on 127.0.0.1, concurrent
   ``POST /sample`` (png and npy) and ``GET /healthz``; npy pixels must equal
   ``Sampler.sample`` for the same seed.

Launch counters are zeroed just before phase 3 and read just after phase 4:
every kernel must have launched on the main path.  The last lines are the
``kernels`` JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device or
without the ``tpugan_torch`` package beside this file.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int) -> float:
    """Device time per call, by CUDA events over ``iters`` calls after one
    warm-up call."""
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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    from tpugan_torch.models.registry import build_generator
    from tpugan_torch.ops import _build, convs, cuda_convt, cuda_gen, cuda_gen2
    from tpugan_torch.sample.sampler import Sampler, seeded_noise
    from tpugan_torch.serve.server import BatchingEngine, make_server

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
    for name, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
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
        cases, tot = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                              bound_ms=0.0, flops=0.0, bytes=0.0, err=0.0)
        for i, (w, a, b) in enumerate(blocks):
            act = "tanh" if i == len(blocks) - 1 else "relu"
            wb = w.to(bf).contiguous()
            got = cuda_convt.convt_affine_act(x, wb, a, b, act=act,
                                              out_dtype=bf)
            ref = cuda_convt.convt_affine_act_plain(x, wb, a, b, act=act,
                                                    out_dtype=bf)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            # bf16 output: an fp32 sum-order ulp may flip the bf16 rounding,
            # one bf16 ulp is 2^-8 relative, so 1e-2 * (1 + |ref|)
            require(bool((err <= 1e-2 * (1 + ref.float().abs())).all()),
                    f"convt layer {i}: max err {err.max().item()}")
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
                     ms=time_ms(lambda: cuda_convt.convt_affine_act(
                         x, wb, a, b, act=act, out_dtype=bf), 20),
                     plain_ms=time_ms(
                         lambda: cuda_convt.convt_affine_act_plain(
                             x, wb, a, b, act=act, out_dtype=bf), 5),
                     library_ms=time_ms(library, 20), bound_ms=bms,
                     bound_by=by, max_abs_err=err.max().item())
            cases.append(c)
            log(f"[kernel] convt_affine_act {json.dumps(c)}")
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[k] += c[k]
            tot["flops"] += flops
            tot["bytes"] += byt
            tot["err"] = max(tot["err"], c["max_abs_err"])
            x = ref
        report["convt_affine_act"] = dict(
            name="convt_affine_act", route="cuda",
            source="tpugan_torch/csrc/cuda_convt.cu",
            replaces="tpugan/ops/pallas_convt.py:108",
            max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=bound_ms(tot["flops"], tot["bytes"])[1],
            library_ms=tot["library_ms"], cases=cases)

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
                c = dict(case=label, ms=time_ms(run, 10),
                         plain_ms=time_ms(plain, 3), library_ms=None,
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
            ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None, cases=[m] + extra)

    # -- 3. main path, with the launch counters from zero ------------------
    for mod in (cuda_convt, cuda_gen, cuda_gen2):
        mod.launches = 0
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
    log(f"[main] launches on the main path: {counts}")
    for key, n in counts.items():
        require(n > 0, f"{key} never launched on the main path")
        report[key]["launches"] = n

    # -- 5. report ----------------------------------------------------------
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "cases")
    kernels = [{k: report[key][k] for k in order}
               for key in ("convt_affine_act", "v1", "v2")]
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
