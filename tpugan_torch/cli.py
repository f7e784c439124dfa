"""Command-line entry points (port of ``tpugan/cli.py``): presets, train,
sample, eval, export, serve, profile, convert-inception, import-torch, fid
and export-torch, over the named presets and dotted ``--set`` overrides.

Every command runs on the card unless ``--device cpu`` (before the
subcommand) asks for the CPU.  ``serve --ckpt`` exports the checkpoint's
generator in memory and serves the loaded artifact, so a checkpoint and an
``export``ed file are served by one path: under ``train.kernels="pallas"``
the artifact's generator runs kernel 1 (the op
``tpugan_torch::convt_affine_act``) once a GBlock.

Meshes (``parallel/``): ``train`` with ``train.mesh_shape``,
``train.fsdp_shards`` or ``train.spatial_shards`` runs one process per
rank: under ``torchrun`` the launcher's ranks, otherwise this command
spawns them (``parallel.multihost.spawn``), as many as the mesh needs
(``mesh_shape`` x the second axis; ``fsdp_shards`` alone takes every card
it divides).  ``sample`` and ``eval`` of a ``spatial_shards`` checkpoint
spawn that many ranks; ``serve --shards N --ckpt`` spawns N, the first of
which serves HTTP over a ``ShardedSampler``.  CUDA ranks take one card
each over NCCL; ``--backend gloo`` puts several on one card, and ``--device
cpu`` runs gloo ranks on the CPU.  The first rank prints and writes.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP.md
item that will port it: ``bench`` (**Benchmark**: ``bench.py`` is the JAX
package's benchmark).

Examples
--------
  python -m tpugan_torch.cli presets
  python -m tpugan_torch.cli train dcgan_celeba64 \\
      --set data.dataset=synthetic --set train.total_steps=200 --out runs/g
  python -m tpugan_torch.cli sample --ckpt runs/g/ckpt --n 64 --seed 7 \\
      --out samples.png
  python -m tpugan_torch.cli export --ckpt runs/g/ckpt --out g.tpugan
  python -m tpugan_torch.cli serve --model g.tpugan --port 8000
  python -m tpugan_torch.cli --device cpu eval --ckpt runs/g/ckpt
  python -m tpugan_torch.cli train dcgan_celeba64 --set train.mesh_shape=2
  python -m tpugan_torch.cli --backend gloo serve --ckpt runs/g/ckpt \
      --shards 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from tpugan_torch.serve.server import BatchingEngine, serve_forever


def _parse_sets(pairs):
    out = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue A: {item!r})")


def _load_cfg_for_ckpt(ckpt_dir: str):
    from tpugan_torch.configs import Config

    cfg_path = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise SystemExit(f"no config.json in {ckpt_dir!r}; pass --preset")
    with open(cfg_path) as f:
        return Config.from_dict(json.load(f))


def _load_state(ckpt_dir: str, device, step=None):
    """(cfg, TrainState) restored from a checkpoint directory onto
    ``device``."""
    from tpugan_torch.ckpt.checkpoint import CheckpointManager
    from tpugan_torch.models.registry import build_models
    from tpugan_torch.train.state import create_train_state

    cfg = _load_cfg_for_ckpt(ckpt_dir)
    g, d = build_models(cfg.model, cfg.train.precision,
                        fuse_stats=cfg.train.fuse_stats, device=device)
    state = create_train_state(cfg, g, d)
    state.load_state_dict(CheckpointManager(ckpt_dir).restore(
        step, map_location=device))
    return cfg, state


def _load_generator_from_ckpt(ckpt_dir: str, device):
    """(cfg, generator module, step) from a checkpoint directory: the EMA
    of G (with G's buffers) when the run kept one, else G."""
    from tpugan_torch.train.state import sync_ema_buffers

    cfg, state = _load_state(ckpt_dir, device)
    if state.g_ema is None:
        return cfg, state.g, state.step
    sync_ema_buffers(state)
    return cfg, state.g_ema, state.step


def cmd_presets(args):
    from tpugan_torch.configs import get_preset, list_presets

    for name in list_presets():
        cfg = get_preset(name)
        print(f"{name:20s} {cfg.model.arch:7s} {cfg.model.image_size}px "
              f"{cfg.loss.kind:8s} dataset={cfg.data.dataset}")


def _mesh_world(cfg, device) -> int:
    """The ranks a config's mesh needs (0: no mesh), as the JAX trainer
    sizes it."""
    t = cfg.train
    if t.spatial_shards > 0:
        return (t.mesh_shape or 1) * t.spatial_shards
    if t.fsdp_shards > 0:
        import torch

        cards = (torch.cuda.device_count()
                 if torch.device(device).type == "cuda" else 1)
        return (t.mesh_shape or max(cards // t.fsdp_shards, 1)) \
            * t.fsdp_shards
    return t.mesh_shape or 0


def _launched() -> bool:
    """Whether a launcher (``torchrun``) started this process as a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _on_ranks(args, fn, world, *fn_args):
    """``fn(rank, *fn_args)`` on ``world`` spawned ranks (the first rank's
    result), or in this process when a launcher made it a rank."""
    from tpugan_torch.parallel import multihost

    backend = args.backend or None
    if _launched():
        rank = multihost.initialize_multihost(autodetect=True,
                                              backend=backend,
                                              device=args.device)
        try:
            return fn(rank, *fn_args)
        finally:
            multihost.shutdown()
    if args.device.startswith("cuda"):
        # build the kernel libraries once here, not in every rank at once
        from tpugan_torch.ops import _build

        _build.build_all()
    return multihost.spawn(fn, world, fn_args, backend=backend,
                           device=args.device)[0]


def _train_rank(rank, cfg, device):
    from tpugan_torch.train.trainer import Trainer

    metrics = Trainer(cfg, device=device).train()
    if rank == 0:
        print(json.dumps({"final": metrics}), flush=True)
    return metrics


def cmd_train(args):
    from tpugan_torch.configs import get_preset
    from tpugan_torch.train.trainer import Trainer

    cfg = get_preset(args.preset).override(_parse_sets(args.set))
    if args.out:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, out_dir=args.out,
            ckpt_dir=os.path.join(args.out, "ckpt")))
    if args.resume:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, resume=args.resume))
    print(cfg.to_json())
    world = _mesh_world(cfg, args.device)
    if world or _launched():
        _on_ranks(args, _train_rank, world, cfg, args.device)
        return
    metrics = Trainer(cfg, device=args.device).train()
    print(json.dumps({"final": metrics}))


def _spatial_world(args) -> int:
    return _load_cfg_for_ckpt(args.ckpt).train.spatial_shards


def _rank_device(device):
    from tpugan_torch.parallel import multihost

    return multihost.rank_device(device)


def _sample_rank(rank, args):
    cmd_sample(args, device=_rank_device(args.device), write=rank == 0)


def cmd_sample(args, device=None, write=True):
    from tpugan_torch.sample.sampler import Sampler
    from tpugan_torch.utils.images import make_grid, save_png, to_uint8

    if device is None and _spatial_world(args) > 0:
        # a spatially sharded model samples on its mesh of ranks
        _on_ranks(args, _sample_rank, _spatial_world(args), args)
        return
    cfg, g, step = _load_generator_from_ckpt(args.ckpt, device or
                                             args.device)
    imgs = Sampler(cfg, g).sample(args.n, seed=args.seed,
                                  batch_size=args.batch_size or args.n)
    if not write:
        return
    if args.outdir:
        # one PNG per image (the two-folder eval workflow: sample --outdir
        # then `fid <outdir> <real dir>`)
        os.makedirs(args.outdir, exist_ok=True)
        u8 = to_uint8(imgs)
        for i in range(len(u8)):
            save_png(os.path.join(args.outdir, f"sample_{i:06d}.png"), u8[i])
        print(f"wrote {len(u8)} images (seed {args.seed}, step {step}) "
              f"-> {args.outdir}")
        return
    save_png(args.out, make_grid(to_uint8(imgs), nrow=args.nrow))
    print(f"wrote {args.out} ({args.n} images, seed {args.seed}, "
          f"step {step})")


def _eval_rank(rank, args):
    cmd_eval(args, device=_rank_device(args.device), write=rank == 0)


def cmd_eval(args, device=None, write=True):
    from tpugan_torch.eval.evaluate import evaluate

    if device is None and _spatial_world(args) > 0:
        _on_ranks(args, _eval_rank, _spatial_world(args), args)
        return
    cfg, g, _ = _load_generator_from_ckpt(args.ckpt, device or args.device)
    if args.fid_n:
        cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, fid_n=args.fid_n))
    scores = evaluate(cfg, g, seed=args.seed)
    if write:
        print(json.dumps(scores))


def cmd_export(args):
    from tpugan_torch.export import save_generator

    cfg, g, step = _load_generator_from_ckpt(args.ckpt, args.device)
    platforms = tuple(
        p.strip() for p in args.platforms.split(",") if p.strip())
    save_generator(args.out, cfg, g, batch=args.batch or None,
                   platforms=platforms)
    size = os.path.getsize(args.out)
    print(f"exported step-{step} generator -> {args.out} "
          f"({size / 1e6:.2f} MB, platforms={','.join(platforms)}, "
          f"batch={'symbolic' if not args.batch else args.batch}, "
          f"kernels={cfg.train.kernels})")


def _engine(gen, args) -> BatchingEngine:
    return BatchingEngine(gen, max_batch=args.max_batch,
                          linger_ms=args.linger_ms,
                          queue_depth=args.queue_depth,
                          request_timeout_s=args.request_timeout_s)


def _serve_rank(rank, args):
    """One rank of ``serve --shards``: the first serves HTTP over the
    ShardedSampler, the others answer its generate rounds until it closes
    (they ignore SIGTERM / SIGINT: the first rank's shutdown releases
    them)."""
    import signal

    from tpugan_torch.parallel import ShardedSampler, make_mesh

    device = _rank_device(args.device)
    cfg, g, _ = _load_generator_from_ckpt(args.ckpt, device)
    sampler = ShardedSampler(cfg, g, make_mesh(args.shards, device.type))
    if rank != 0:
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, signal.SIG_IGN)
        sampler.serve()
        return None
    try:
        serve_forever(_engine(sampler, args), host=args.host, port=args.port)
    finally:
        sampler.close()
    return None


def cmd_serve(args):
    from tpugan_torch.export import export_generator, load_generator

    if args.shards:
        if args.model:
            raise SystemExit(
                "--shards needs --ckpt (an exported artifact is one "
                "program; the mesh serves the checkpoint's generator)")
        if not args.ckpt:
            raise SystemExit("serve needs --model or --ckpt")
        _on_ranks(args, _serve_rank, args.shards, args)
        return
    if args.model:
        gen = load_generator(args.model, device=args.device)
    else:
        if not args.ckpt:
            raise SystemExit("serve needs --model or --ckpt")
        # serve straight from a checkpoint: export in memory (weights
        # baked in) so the serving path is the artifact's either way
        cfg, g, _ = _load_generator_from_ckpt(args.ckpt, args.device)
        gen = load_generator(export_generator(cfg, g), device=args.device)
    serve_forever(_engine(gen, args), host=args.host, port=args.port)


def cmd_profile(args):
    """Train-step probe for a preset: FLOPs and bytes of one step (counted
    as it runs, ``utils/profiling.cost_analysis``, on a step of the same
    config under ``kernels="xla"`` and ``fuse_stats="off"``: the
    hand-written kernels are opaque to the counters), the measured
    ms/step (wall clock, each step synchronized) of the configured step,
    achieved TFLOP/s and images/s, and optionally a ``torch.profiler``
    trace of three steps."""
    import numpy as np
    import torch

    from tpugan_torch.configs import get_preset
    from tpugan_torch.models.registry import build_models
    from tpugan_torch.train.state import create_train_state
    from tpugan_torch.train.steps import build_train_step
    from tpugan_torch.utils.device import resolve_device
    from tpugan_torch.utils.profiling import cost_analysis, timeit, trace

    cfg = get_preset(args.preset).override(_parse_sets(args.set))
    cfg = cfg.override({"data.dataset": "synthetic",
                        "train.steps_per_call": 1})
    dev = resolve_device(args.device)

    def build(c):
        g, d = build_models(c.model, c.train.precision,
                            fuse_stats=c.train.fuse_stats, device=dev,
                            generator=torch.Generator().manual_seed(
                                c.train.seed))
        return create_train_state(c, g, d), build_train_step(c, g, d)

    s, c, bsz = cfg.model.image_size, cfg.model.channels, cfg.data.batch_size
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(
        0, 256, size=(bsz, s, s, c)).astype(np.uint8)).to(dev)}
    if cfg.model.arch == "cdcgan":
        batch["label"] = torch.from_numpy(rng.integers(
            0, max(cfg.model.n_classes, 1), size=(bsz,))).to(dev)

    counted, count_step = build(cfg.override({"train.kernels": "xla",
                                              "train.fuse_stats": "off"}))
    costs = cost_analysis(count_step, counted, batch)
    del counted, count_step
    state, step = build(cfg)
    sec = timeit(lambda: step(state, batch), iters=args.iters, warmup=2)
    flops = costs["flops"]
    out = {
        "preset": args.preset,
        "batch": bsz,
        "precision": cfg.train.precision,
        "device": str(dev),
        "flops_per_step": flops,
        "bytes_accessed": costs["bytes accessed"],
        "ms_per_step": round(sec * 1e3, 4),
        "achieved_tflops": round(flops / sec / 1e12, 4) if sec else 0.0,
        "images_per_sec": round(bsz / sec, 1) if sec else 0.0,
    }
    if args.trace:
        with trace(args.trace):
            for _ in range(3):
                step(state, batch)
        out["trace_dir"] = args.trace
    print(json.dumps(out))


def cmd_convert_inception(args):
    """A pytorch-fid InceptionV3 state_dict -> the weight pickle that
    ``eval.inception_weights`` takes (the same file ``tpugan
    convert-inception`` writes)."""
    import pickle

    import numpy as np
    import torch

    from tpugan_torch.eval.inception import convert_torch_state_dict

    sd = torch.load(args.src, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: np.asarray(v.detach() if hasattr(v, "detach") else v)
          for k, v in sd.items()}
    out = convert_torch_state_dict(sd)
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    n_arrays = sum(len(v) for v in out.values())
    print(f"converted {n_arrays} arrays -> {args.out}; set "
          f"eval.inception_weights={args.out!r} for exact FID")


def _torch_load(path):
    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # older .pth files pickle plain python containers around the
        # tensors; fall back for those
        return torch.load(path, map_location="cpu", weights_only=False)


def cmd_import_torch(args):
    """Reference-style torch .pth -> a port checkpoint (weights, BN stats,
    SN u).  Optimizer moments are restored warm only from an export of
    either package (the ``tpugan_export`` marker pins the parameter order,
    the update rule and the format version); a foreign .pth's moments stay
    un-imported (``ckpt/torch_import.py``)."""
    from tpugan_torch.ckpt.checkpoint import CheckpointManager
    from tpugan_torch.ckpt.torch_export import EXPORT_VERSION
    from tpugan_torch.ckpt.torch_import import (extract_export_meta,
                                                import_optimizer_state,
                                                import_torch_state,
                                                split_reference_checkpoint)
    from tpugan_torch.configs import get_preset

    cfg = get_preset(args.preset).override(_parse_sets(args.set))
    g_sd = d_sd = None
    meta = opt_g_sd = opt_d_sd = None
    is_ema = False
    step = args.step
    if args.ckpt:
        obj = _torch_load(args.ckpt)
        g_sd, d_sd, found = split_reference_checkpoint(obj)
        meta, opt_g_sd, opt_d_sd = extract_export_meta(obj)
        # a provenance flag, not truthiness: a foreign EMA state_dict under
        # 'ema' must not mark the imported 'G' weights as EMA
        ema_entry = obj.get("ema") if isinstance(obj, dict) else None
        is_ema = ema_entry is True
        if isinstance(ema_entry, dict):
            print("note: checkpoint holds a dict under 'ema' (foreign EMA "
                  "weights?) — not imported; pass that state_dict via --g "
                  "to import it as the generator")
        step = step or found
    if args.g:
        g_sd, _, found = split_reference_checkpoint(_torch_load(args.g))
        if g_sd is None:
            raise SystemExit(f"{args.g} does not look like a generator "
                             "state_dict")
        step = step or found
        opt_g_sd = None  # --ckpt's G moments do not belong to --g's weights
        is_ema = False  # nor does --ckpt's EMA flag
    if args.d:
        _, d_sd, found = split_reference_checkpoint(_torch_load(args.d))
        if d_sd is None:
            raise SystemExit(f"{args.d} does not look like a discriminator "
                             "state_dict")
        step = step or found
        opt_d_sd = None
    if g_sd is None and d_sd is None:
        raise SystemExit("nothing to import: pass --ckpt and/or --g/--d")

    state = import_torch_state(cfg, g_sd, d_sd, step=step,
                               device=args.device)
    opt_note = "optimizer state fresh by design"
    if meta and (opt_g_sd is not None or opt_d_sd is not None):
        if meta.get("version") != EXPORT_VERSION:
            opt_note = (f"optimizer state fresh: checkpoint export format "
                        f"v{meta.get('version')} != this build's "
                        f"v{EXPORT_VERSION} — moment layout not trusted")
        elif meta.get("optimizer") == cfg.optim.optimizer:
            import_optimizer_state(cfg, state, opt_g_sd, opt_d_sd)
            warm = [n for n, s in (("G", opt_g_sd), ("D", opt_d_sd))
                    if s is not None]
            opt_note = (f"optimizer moments restored warm for "
                        f"{'+'.join(warm)} (exported checkpoint)")
        else:
            opt_note = (f"optimizer state fresh: checkpoint was exported "
                        f"under {meta.get('optimizer')!r} but this preset "
                        f"uses {cfg.optim.optimizer!r}")
    if is_ema:
        both = state.g_ema is not None
        print("note: checkpoint marks its G weights as EMA — imported as "
              + ("both the raw and the EMA generator weights" if both else
                 "the raw generator weights (train.ema=0 for this preset; "
                 "set train.ema>0 to track an EMA slot)"))
    CheckpointManager(args.out).save(state.step, state.state_dict(),
                                     cfg.to_json())
    got = [n for n, s in (("G", g_sd), ("D", d_sd)) if s is not None]
    print(f"imported {'+'.join(got)} into {args.out} at step {state.step} "
          f"({opt_note}; BN stats and SN u vectors carried over) — usable "
          f"via sample/eval/export --ckpt, or train --resume to fine-tune")


def cmd_fid(args):
    """FID/KID between two image folders (pytorch-fid's two-path usage)."""
    from tpugan_torch.eval.evaluate import evaluate_folders

    print(json.dumps(evaluate_folders(
        args.path_a, args.path_b, image_size=args.image_size,
        channels=args.channels, metric=args.metric,
        inception_weights=args.inception_weights, n=args.n,
        batch=args.batch, prdc=args.prdc, device=args.device)))


def cmd_export_torch(args):
    """A port checkpoint -> a reference-style torch .pth (the inverse of
    import-torch), BN stats and SN u carried, the optimizers' moments in
    torch-native format."""
    import torch

    from tpugan_torch.ckpt.torch_export import export_torch_checkpoint

    cfg, state = _load_state(args.ckpt, args.device, step=args.step or None)
    out = export_torch_checkpoint(cfg, state, use_ema=args.ema)
    torch.save(out, args.out)
    size = os.path.getsize(args.out)
    opts = "+".join(k[len("opt_"):] for k in ("opt_G", "opt_D") if k in out)
    print(f"exported step-{out['step']} G+D -> {args.out} "
          f"({size / 1e6:.2f} MB, {'EMA' if args.ema else 'raw'} generator "
          f"weights — self-described via the 'ema' key; BN stats and SN u "
          f"carried; {cfg.optim.optimizer} moments for {opts} in torch-"
          f"native format, restored warm by import-torch)")


def cmd_bench(args):
    raise _not_ported("the bench subcommand (bench.py is the JAX package's "
                      "benchmark)", "Benchmark")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpugan-torch")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu for the CPU)")
    ap.add_argument("--backend", default="", choices=["", "nccl", "gloo"],
                    help="process group backend of a mesh (default: NCCL "
                         "for CUDA, gloo for the CPU; gloo shares cards)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("presets", help="list named configs")

    p = sub.add_parser("train", help="train a preset")
    p.add_argument("preset")
    p.add_argument("--set", action="append", metavar="key=value",
                   help="dotted config override, e.g. train.total_steps=100")
    p.add_argument("--out", default="", help="output dir (also ckpt dir)")
    p.add_argument("--resume", default="", help="checkpoint dir to resume")

    p = sub.add_parser("sample", help="generate a seeded sample grid")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nrow", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--out", default="samples.png")
    p.add_argument("--outdir", default="",
                   help="write n individual PNGs here instead of one grid "
                        "(pairs with `fid`)")

    p = sub.add_parser("eval", help="FID/IS evaluation")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fid-n", type=int, default=0)

    p = sub.add_parser("export",
                       help="export a deployable generator artifact")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", default="generator.tpugan")
    p.add_argument("--batch", type=int, default=0,
                   help="fixed batch size (default: symbolic, any size)")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma-separated devices the artifact may run on")

    p = sub.add_parser("serve", help="HTTP sampling server (micro-batched)")
    p.add_argument("--model", default="", help=".tpugan artifact to serve")
    p.add_argument("--ckpt", default="", help="...or a checkpoint dir")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--linger-ms", type=float, default=2.0)
    p.add_argument("--queue-depth", type=int, default=256,
                   help="pending-request cap; overflow sheds with 503")
    p.add_argument("--request-timeout-s", type=float, default=120.0)
    p.add_argument("--shards", type=int, default=0,
                   help="serve one endpoint over an N-rank mesh (needs "
                        "--ckpt)")

    sub.add_parser("bench", help="throughput benchmark (not ported yet)")

    p = sub.add_parser("profile", help="train-step cost/rate probe "
                       "(counted FLOPs/bytes + measured ms/step)")
    p.add_argument("preset")
    p.add_argument("--set", action="append", metavar="key=value")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--trace", default="", help="also write a torch.profiler "
                   "Chrome trace into this directory")

    p = sub.add_parser(
        "convert-inception",
        help="convert a pytorch-fid InceptionV3 state_dict (.pth) to the "
             "weight file eval.inception_weights expects (exact-FID path)")
    p.add_argument("--src", required=True,
                   help="torch state_dict file (torch.save'd)")
    p.add_argument("--out", default="inception_fid.pkl")

    p = sub.add_parser(
        "import-torch",
        help="convert a reference-style torch .pth (G/D state_dicts) into "
             "a checkpoint (the migration path for trained models)")
    p.add_argument("preset", help="architecture the weights belong to "
                   "(e.g. dcgan_cifar10, cdcgan_celeba64)")
    p.add_argument("--set", action="append", metavar="key=value",
                   help="dotted config override (match nz/ngf/ndf if "
                   "the run changed them)")
    p.add_argument("--ckpt", default="",
                   help=".pth holding both nets (keys like G/D/netG/netD)")
    p.add_argument("--g", default="", help=".pth of the generator alone")
    p.add_argument("--d", default="", help=".pth of the discriminator alone")
    p.add_argument("--step", type=int, default=0,
                   help="step number to stamp on the checkpoint")
    p.add_argument("--out", required=True, help="checkpoint dir")

    p = sub.add_parser(
        "fid",
        help="FID/KID between two image folders (the pytorch-fid two-path "
             "workflow; generator-free)")
    p.add_argument("path_a")
    p.add_argument("path_b")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--metric", default="proxy",
                   choices=["proxy", "inception"])
    p.add_argument("--inception-weights", default="",
                   help="weight pickle from `convert-inception` (required "
                        "for --metric inception)")
    p.add_argument("--n", type=int, default=0,
                   help="cap images per folder (default: all)")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--prdc", action="store_true",
                   help="also report precision/recall/density/coverage")

    p = sub.add_parser(
        "export-torch",
        help="convert a checkpoint into a reference-style torch .pth (G/D "
             "state_dicts; the inverse of import-torch)")
    p.add_argument("--ckpt", required=True, help="checkpoint dir")
    p.add_argument("--out", default="model.pth", help="output .pth path")
    p.add_argument("--step", type=int, default=0,
                   help="checkpoint step to export (default: latest)")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA generator weights instead of raw")

    # bench takes bench.py's flags (e.g. --quick); other commands refuse
    # unknown ones
    args, extra = ap.parse_known_args(argv)
    if args.cmd != "bench" and extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    {"presets": cmd_presets, "train": cmd_train, "sample": cmd_sample,
     "eval": cmd_eval, "export": cmd_export, "serve": cmd_serve,
     "bench": cmd_bench, "profile": cmd_profile,
     "convert-inception": cmd_convert_inception,
     "import-torch": cmd_import_torch,
     "export-torch": cmd_export_torch, "fid": cmd_fid}[args.cmd](args)


if __name__ == "__main__":
    main()
