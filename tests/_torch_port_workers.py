"""Rank-side halves of the port's multi-process tests.

The test modules (``test_torch_port_{parallel,spatial,multihost}.py``)
compute the JAX package's numbers in the pytest process and spawn gloo
ranks on the CPU (``tpugan_torch.parallel.multihost.spawn``) once per
module, each running ``run_cases`` over a list of cases defined here.
This module imports neither JAX nor the JAX package: every rank imports
it to unpickle its function.  A case returns numpy arrays and Python
values (rank 0's, unless it says otherwise); ranks outside a case's mesh
return None.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

from tpugan_torch.configs import get_preset
from tpugan_torch.models.registry import build_generator, build_models
from tpugan_torch.parallel import collectives, fsdp, multihost, spatial
from tpugan_torch.parallel.mesh import (all_gather_arrays, axis_index,
                                        axis_size, build_mesh, in_mesh,
                                        make_mesh, shard_batch,
                                        shard_train_state)
from tpugan_torch.train.state import create_train_state
from tpugan_torch.train.steps import build_train_step


def run_cases(rank, cases, keep=None):
    """[(name, kwargs)] -> [each case's result on this rank], in order;
    every rank runs every case (each is collective).  The ranks run on one
    thread each: the suite runs several test files at once beside them.
    ``keep`` (a directory): the results so far are also pickled there
    after each case, so that they outlive a later case that fails."""
    torch.set_num_threads(1)
    torch.manual_seed(0)
    results = []
    for name, kw in cases:
        results.append(globals()[name](rank, **kw))
        if keep is not None:
            with open(os.path.join(keep, f"rank{rank}.pkl"), "wb") as f:
                pickle.dump(results, f)
    return results


def numpy_tree(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(numpy_tree(v) for v in x)
    return x


def torch_tree(x):
    """Tensors from numpy, copied: an optimizer steps its loaded state in
    place, and a case's inputs must stay as given."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    if isinstance(x, dict):
        return {k: torch_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(torch_tree(v) for v in x)
    return x


def _mesh(kind, shape):
    if kind == "single":  # no mesh: every rank runs the whole program
        return None
    if kind == "dp":
        return make_mesh(shape[0], "cpu")
    if kind == "fsdp":
        return fsdp.make_mesh_2d(*shape, device="cpu")
    if kind == "space":
        return build_mesh(shape, ("space",), "cpu")
    if kind == "dp_space":
        return spatial.make_mesh_dp_spatial(*shape, device="cpu")
    raise ValueError(kind)


def _state(preset, overrides, init_sd):
    """(cfg, a port TrainState): ``init_sd`` loaded, or (None) the port's
    own seeded initialization, the same on every rank."""
    cfg = get_preset(preset).override(overrides)
    g, d = build_models(cfg.model, cfg.train.precision,
                        fuse_stats=cfg.train.fuse_stats, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, g, d)
    if init_sd is not None:
        state.load_state_dict(torch_tree(init_sd))
    return cfg, state


def mesh_facts(rank):
    """What the mesh helpers report on each rank (all ranks' results)."""
    out = {"world": multihost.world_size(), "rank": rank}
    try:
        make_mesh(999, "cpu")
    except ValueError as e:
        out["over_request"] = str(e)
    sub = make_mesh(2, "cpu")
    out["subset"] = (sub.size(), in_mesh(sub))
    dp = make_mesh(None, "cpu")
    x = torch.zeros(16, 8, 8, 3)
    out["shard"] = tuple(shard_batch(x, dp).shape)
    local = torch.arange(4.0)[rank:rank + 1]
    out["gathered"] = numpy_tree(all_gather_arrays(local, dp))
    return out


def steps(rank, preset, overrides, init_sd, batches, kind, shape,
          mesh_step=True, grads=False):
    """Train-step calls of the port on a mesh, each rank fed its rows of
    the global batches; rank 0 returns (dense state_dict, metrics per
    call, facts): FSDP's shard shapes, or (``grads``) the first call's
    gradients as each optimizer received them, by parameter name."""
    mesh = _mesh(kind, shape)
    if mesh is not None and not in_mesh(mesh):
        return None
    cfg, state = _state(preset, overrides, init_sd)
    if kind == "fsdp":
        fsdp.shard_train_state_fsdp(state, mesh)
    elif mesh is not None:
        shard_train_state(state, mesh)
    facts = {}
    if kind == "fsdp":
        w = dict(state.g.named_parameters())["block0.conv.w"]
        facts["block0.conv.w"] = tuple(w.shape)
    if grads:
        facts["grads"] = {}
        for part in ("g", "d"):
            module = getattr(state, part)
            getattr(state, "opt_" + part).register_step_pre_hook(
                _grad_catcher(module, facts["grads"], part))
    n_data = axis_size(mesh, "data")
    accum = cfg.train.grad_accum
    step = build_train_step(cfg, state.g, state.d,
                            mesh=mesh if mesh_step else None)
    ctx = (spatial.spatial_ctx(mesh) if kind in ("space", "dp_space")
           else _null())
    metrics = []
    with ctx:
        for b in batches:
            rows = multihost.local_rows(b["image"].shape[0], n_data,
                                        axis_index(mesh, "data"), accum)
            state, m = step(state, {k: torch.from_numpy(v[rows])
                                    for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
    if kind == "fsdp":
        st = state.opt_g.state[dict(state.g.named_parameters())[
            "block0.conv.w"]]
        facts["exp_avg"] = tuple(st["exp_avg"].shape)
    sd = numpy_tree(state.state_dict())
    return (sd, metrics, facts) if rank == 0 else metrics


def _grad_catcher(module, out, part):
    """An optimizer step pre-hook that keeps ``module``'s gradients of the
    first step in ``out[part]``."""
    def hook(opt, args, kwargs):
        if part not in out:
            out[part] = {k: p.grad.detach().cpu().numpy().copy()
                         for k, p in module.named_parameters()}
    return hook


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def trainer(rank, preset, overrides, data, init_sd=None, steps=None,
            resume_steps=0, workdir=None):
    """``Trainer(cfg).train()`` on every rank (the mesh from the config),
    then optionally a resumed run; returns rank 0's dense state, every
    rank's last metrics, what each rank wrote, and the mesh's names."""
    from tpugan_torch.train.trainer import Trainer

    workdir = workdir or tempfile.mkdtemp()
    base = {**overrides, "train.ckpt_dir": os.path.join(workdir, "ckpt")}

    def cfg_for(n, resume=""):
        return get_preset(preset).override({
            **base, "train.total_steps": n, "train.resume": resume,
            "train.out_dir": os.path.join(workdir, f"out{rank}")})

    data = {k: np.asarray(v) for k, v in data.items()}
    t = Trainer(cfg_for(steps), data=dict(data), device="cpu")
    placed = t.mesh or t.spatial_mesh
    names = None if placed is None else tuple(placed.mesh_dim_names)
    facts = {"mesh": names, "fuse": t._fuse_mode}
    if init_sd is not None:
        t.state.load_state_dict(torch_tree(init_sd))
    if t.state.fsdp:
        w = dict(t.state.g.named_parameters())["block0.conv.w"]
        facts["shard"] = tuple(w.shape)
    m = t.train()
    out = {"metrics": m, "state": numpy_tree(t.state.state_dict()),
           "facts": facts}
    if resume_steps:
        t2 = Trainer(cfg_for(resume_steps, resume=base["train.ckpt_dir"]),
                     data=dict(data), device="cpu")
        out["resumed"] = t2.train()
        out["resumed_step"] = t2.state.step
        out["resumed_state"] = numpy_tree(t2.state.state_dict())
        if t2.state.fsdp:
            w = dict(t2.state.g.named_parameters())["block0.conv.w"]
            out["facts"]["resumed_shard"] = tuple(w.shape)
    out["wrote"] = sorted(os.listdir(os.path.join(workdir, f"out{rank}")))
    out["active_after"] = spatial.spatial_active()
    if rank != 0:
        out.pop("state")
        out.pop("resumed_state", None)
    return out


def halo_conv(rank, kind, dim, n, x, w, device="cpu"):
    """A spatial conv (``kind`` "conv" / "convt") of x on a ("space",) mesh
    of n ranks and its gradients, through sum(tanh(out)); rank 0 returns
    (out, dx, dw), each whole (fp32 on a card: TF32 off)."""
    dev = multihost.rank_device(device)
    torch.backends.cudnn.allow_tf32 = False
    mesh = build_mesh((n,), ("space",), dev.type)
    if not in_mesh(mesh):
        return None
    group = mesh.get_group()
    xs = spatial.shard_spatial(torch.from_numpy(x).to(dev), mesh,
                               dim=dim).requires_grad_()
    wt = torch.from_numpy(w).to(dev).requires_grad_()
    f = (spatial.spatial_conv2d if kind == "conv"
         else spatial.spatial_conv_transpose2d)
    y = f(xs, wt, mesh, dim=dim)
    torch.tanh(y).sum().backward()
    out = collectives.gather_from_shard(y.detach(), group, dim)
    dx = collectives.gather_from_shard(xs.grad, group, dim)
    return numpy_tree((out, dx, wt.grad)) if rank == 0 else None


def ctx_dispatch(rank, x, small, w):
    """conv2d inside spatial_ctx on a whole map (sharded) and a small one
    (dense), each gathered whole."""
    from tpugan_torch.ops import convs

    mesh = build_mesh((4,), ("space",), "cpu")
    with spatial.spatial_ctx(mesh):
        got = convs.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                           stride=2, padding=1)
        sharded = spatial.is_sharded(got)
        got = spatial.replicated(got)
        got_small = convs.conv2d(torch.from_numpy(small),
                                 torch.from_numpy(w), stride=2, padding=1)
    return numpy_tree((got, got_small, sharded)) if rank == 0 else None


def model_forward(rank, which, preset, overrides, n, seed=0):
    """G (``which`` "g") or D in train mode inside a spatial_ctx of n ranks,
    on seeded weights and inputs; rank 0 returns (spatial output, the same
    module's dense output)."""
    mesh = build_mesh((n,), ("space",), "cpu")
    if not in_mesh(mesh):
        return None
    cfg = get_preset(preset).override(overrides)
    g, d = build_models(cfg.model, cfg.train.precision, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    m = (g if which == "g" else d).train()
    gen = torch.Generator().manual_seed(seed + 1)
    s = cfg.model.image_size
    inp = (torch.randn(2, cfg.model.nz, generator=gen) if which == "g"
           else torch.randn(2, s, s, cfg.model.channels, generator=gen))
    bufs = {k: v.clone() for k, v in m.state_dict().items()}
    with spatial.spatial_ctx(mesh), torch.no_grad():
        out = m(inp)
    m.load_state_dict(bufs)  # the same running statistics again
    if rank != 0:
        return None
    with torch.no_grad():
        return numpy_tree((out, m(inp)))


def _channel_stats_extractor(channels, *args, **kwargs):
    """A stand-in feature extractor: per-channel means and deviations as
    features, their softmax as class probabilities."""
    def run(images, batch=256):
        x = np.asarray(images, np.float32)
        f = np.concatenate([x.mean(axis=(1, 2)), x.std(axis=(1, 2))], 1)
        e = np.exp(f - f.max(1, keepdims=True))
        return f.astype(np.float64), e / e.sum(1, keepdims=True)

    return run


def sample(rank, preset, overrides, n, seed, batch_size=0, fid=None):
    """A standalone Sampler of a seeded generator (its own space mesh when
    the config shards); rank 0 returns the images, the same generator's
    dense images, the chunked images and FID scores.  The scores' extractor
    is a stand-in (``_channel_stats_extractor``): this case checks
    ``evaluate``'s spatial wiring (every rank generates, the first scores);
    the extractors themselves are held in ``test_torch_port_eval.py``, and
    fitting the proxy's head would cost a rank ~14 s of CPU."""
    from tpugan_torch.eval import evaluate as evaluate_mod
    from tpugan_torch.sample.sampler import Sampler

    evaluate = evaluate_mod.evaluate
    evaluate_mod.make_extractor = _channel_stats_extractor  # this rank only

    cfg = get_preset(preset).override(overrides)
    g = build_generator(cfg.model, cfg.train.precision, device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    s = Sampler(cfg, g)
    out = {"images": s.sample(n, seed=seed)}
    if batch_size:
        out["chunked"] = s.sample(n, seed=seed, batch_size=batch_size)
    if fid is not None:
        out["scores"] = evaluate(cfg, g, seed=0,
                                 real_images=np.asarray(fid))
    if rank != 0:
        return None
    dense = Sampler(cfg.override({"train.spatial_shards": 0}), g)
    out["dense"] = dense.sample(n, seed=seed)
    return out


def sharded_sample(rank, preset, overrides, sd, n, seed, kernels,
                   device="cpu"):
    """``ShardedSampler.sample(n, seed)`` over every rank (rank 0 returns
    the images and its kernel-1 launches; the others serve its round, then
    are released)."""
    from tpugan_torch.ops import cuda_convt
    from tpugan_torch.parallel import ShardedSampler

    dev = multihost.rank_device(device)
    cfg = get_preset(preset).override({**overrides,
                                       "train.kernels": kernels})
    g = build_generator(cfg.model, cfg.train.precision, device=dev,
                        generator=torch.Generator().manual_seed(rank))
    if rank == 0:  # the others take rank 0's weights from the broadcast
        g.load_state_dict(torch_tree(sd))
    s = ShardedSampler(cfg, g, make_mesh(None, dev.type))
    cuda_convt.launches = 0
    if rank != 0:
        s.serve()
        return None
    try:
        return {"images": s.sample(n, seed), "shards": s.n_shards,
                "launches": cuda_convt.launches}
    finally:
        s.close()


def all_reduce_psum(rank, world):
    """The two-process psum: each rank contributes its rows of arange."""
    import torch.distributed as dist

    vals = np.arange(2 * world, dtype=np.float32)
    sl = multihost.local_batch_slice(2 * world)
    t = torch.from_numpy(vals[sl].copy()).sum().reshape(1)
    dist.all_reduce(t)
    return {"slice": (sl.start, sl.stop), "sum": float(t),
            "rank": multihost.process_index(),
            "main": multihost.is_main_process()}


def fail_on(rank, bad):
    """Raise on rank ``bad``; the others wait at a barrier it never
    reaches (the spawner must stop them and report the failure)."""
    import torch.distributed as dist

    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()


def run_example(path, argv, cwd, out, threads):
    """Run the example script at ``path`` as ``__main__`` with ``argv`` from
    ``cwd`` in this process, on ``threads`` threads; put (ok, what it
    printed) on the queue ``out``."""
    import contextlib
    import io
    import runpy
    import sys
    import traceback

    torch.set_num_threads(threads)
    os.chdir(cwd)
    sys.argv = [path, *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    except BaseException:
        out.put((False, buf.getvalue() + traceback.format_exc()))
        raise
    out.put((True, buf.getvalue()))
