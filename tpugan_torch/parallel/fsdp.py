"""FSDP-style parameter sharding over a 2-D (data, model) mesh (port of
``tpugan/parallel/fsdp.py``).

Each ``model`` rank holds its shard of every shardable parameter and of
its optimizer moments; the placement rule is the JAX package's
``_leaf_spec``: a leaf of rank >= 2 is split on its last dim when that is
divisible by the ``model`` size, a 1-D leaf of length > 1 on its only dim
when divisible, and everything else is replicated.  BatchNorm statistics
and spectral norm's ``u`` (per-channel buffers, updated in place by the
forward) stay whole on every rank.

The shard is the module's registered parameter, under its own name, so
``parameters()``, the optimizers (and so Adam's moments), the EMA update
and WGAN's clip all work on shards.  A forward pre-hook on the module that
owns it all-gathers it over ``model`` (``collectives.gather_from_shard``:
its backward takes this rank's slice of the full gradient) and sets the
full tensor as an instance attribute for the forward, which the forward
hook removes.  The batch is sharded over ``data`` only, so the ``model``
ranks of one data row compute the same thing; the train step all-reduces
every gradient over ``data``, and each rank's optimizer updates its shard.
The numbers equal plain DP's.

``TrainState.state_dict()`` of an FSDP state gathers every shard (a
collective), so a checkpoint holds the dense layout whatever the mesh;
``load_state_dict`` takes the dense layout and keeps this rank's shards.
"""

from __future__ import annotations

import copy
import itertools
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from tpugan_torch.parallel import collectives
from tpugan_torch.parallel.mesh import (axis_group, axis_index, axis_size,
                                        build_mesh)

# process groups by key: a module records the key (an int survives
# copy.deepcopy, a ProcessGroup does not)
_GROUPS: dict = {}


def make_mesh_2d(n_data: int, n_model: int, device="cuda"):
    """A (data, model) mesh over the first n_data * n_model ranks."""
    return build_mesh((n_data, n_model), ("data", "model"), device)


def leaf_dim(shape, n_model: int) -> Optional[int]:
    """The dim a leaf of ``shape`` is sharded on over ``n_model`` ranks, or
    None when it is replicated (the JAX package's ``_leaf_spec``)."""
    if len(shape) >= 2 and shape[-1] % n_model == 0:
        return len(shape) - 1
    if len(shape) == 1 and shape[0] % n_model == 0 and shape[0] > 1:
        return 0
    return None


def _gather_hook(module, args):
    spec = getattr(module, "_fsdp", None)
    if spec is None:
        return
    dims, key = spec
    for name, d in dims.items():
        module.__dict__[name] = collectives.gather_from_shard(
            module._parameters[name], _GROUPS[key], d)


def _release_hook(module, args, out):
    for name in getattr(module, "_fsdp", ({}, 0))[0]:
        module.__dict__.pop(name, None)


def sharded_dims(module: nn.Module) -> dict:
    """{parameter name (dotted, as ``named_parameters``): sharded dim} of a
    module placed by ``shard_params_fsdp``."""
    out = {}
    for prefix, sub in module.named_modules():
        for name, d in getattr(sub, "_fsdp", ({}, 0))[0].items():
            out[f"{prefix}.{name}" if prefix else name] = d
    return out


@torch.no_grad()
def shard_params_fsdp(module: nn.Module, mesh) -> nn.Module:
    """Replace each shardable parameter of ``module`` by this rank's shard
    over ``model`` and hook the owning modules (in place; returns the
    module).  A ``model`` axis of one rank shards nothing."""
    n, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    if n == 1:
        return module
    key = id(axis_group(mesh, "model"))
    _GROUPS[key] = axis_group(mesh, "model")
    for sub in module.modules():
        dims = {}
        for name, p in list(sub._parameters.items()):
            d = None if p is None else leaf_dim(tuple(p.shape), n)
            if d is None:
                continue
            k = p.shape[d] // n
            sub._parameters[name] = nn.Parameter(
                p.detach().narrow(d, r * k, k).clone(),
                requires_grad=p.requires_grad)
            dims[name] = d
        if dims:
            sub._fsdp = (dims, key)
            sub.register_forward_pre_hook(_gather_hook)
            sub.register_forward_hook(_release_hook, always_call=True)
    return module


def _group_of(module: nn.Module):
    for sub in module.modules():
        spec = getattr(sub, "_fsdp", None)
        if spec is not None:
            return _GROUPS[spec[1]]
    return None


def _gather(t: torch.Tensor, group, d: int) -> torch.Tensor:
    return torch.cat(collectives.all_gather(t.detach(), group), dim=d)


def _slice(t: torch.Tensor, group, d: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = t.shape[d] // n
    return t.narrow(d, r * k, k).clone()


def full_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` with every shard gathered whole (collective
    over ``model``)."""
    sd = module.state_dict()
    group = _group_of(module)
    for name, d in sharded_dims(module).items():
        sd[name] = _gather(sd[name], group, d)
    return sd


def full_parameters(module: nn.Module) -> dict:
    """{name: whole parameter} (collective over ``model``)."""
    dims, group = sharded_dims(module), _group_of(module)
    return {k: (_gather(p, group, dims[k]) if k in dims else p.detach())
            for k, p in module.named_parameters()}


def load_full_state_dict(module: nn.Module, sd: dict, params_only=False
                         ) -> None:
    """Load a dense ``state_dict`` (or, with ``params_only``, a dict of
    parameters) into an FSDP-placed module, keeping this rank's shards."""
    dims, group = sharded_dims(module), _group_of(module)
    sd = {k: (_slice(v, group, dims[k]) if k in dims else v)
          for k, v in sd.items()}
    if params_only:
        with torch.no_grad():
            for k, p in module.named_parameters():
                p.copy_(sd[k])
        return
    module.load_state_dict(sd)


def _opt_params(opt: torch.optim.Optimizer) -> list:
    return list(itertools.chain.from_iterable(
        g["params"] for g in opt.param_groups))


def _param_dims(module: nn.Module) -> dict:
    """{id(parameter): sharded dim} of an FSDP-placed module."""
    dims = sharded_dims(module)
    return {id(p): dims[k] for k, p in module.named_parameters()
            if k in dims}


def full_optimizer_state_dict(opt, module: nn.Module) -> dict:
    """``opt.state_dict()`` with each sharded parameter's moments gathered
    whole (collective over ``model``)."""
    sd = opt.state_dict()
    dims, group = _param_dims(module), _group_of(module)
    for idx, p in enumerate(_opt_params(opt)):
        d = dims.get(id(p))
        st = sd["state"].get(idx)
        if d is None or st is None:
            continue
        sd["state"][idx] = {k: (_gather(v, group, d) if torch.is_tensor(v)
                                and v.shape == p.shape else v)
                            for k, v in st.items()}
    return sd


def _slice_optimizer_state(sd: dict, params: list, dims: dict, group,
                           full_shapes: dict) -> dict:
    sd = copy.copy(sd)
    sd["state"] = dict(sd["state"])
    for idx, p in enumerate(params):
        d = dims.get(id(p))
        st = sd["state"].get(idx)
        if d is None or st is None:
            continue
        full = full_shapes[id(p)]
        sd["state"][idx] = {k: (_slice(v, group, d) if torch.is_tensor(v)
                                and tuple(v.shape) == full else v)
                            for k, v in st.items()}
    return sd


def _full_shape(p, d, n) -> tuple:
    s = list(p.shape)
    s[d] *= n
    return tuple(s)


def load_full_optimizer_state_dict(opt, module: nn.Module, sd: dict) -> None:
    """Load a dense optimizer ``state_dict`` into the optimizer of an
    FSDP-placed module, keeping this rank's slice of each moment."""
    dims, group = _param_dims(module), _group_of(module)
    params = _opt_params(opt)
    n = dist.get_world_size(group) if group is not None else 1
    shapes = {id(p): _full_shape(p, dims[id(p)], n) for p in params
              if id(p) in dims}
    opt.load_state_dict(_slice_optimizer_state(sd, params, dims, group,
                                               shapes))


def _reshard_optimizer(opt, module: nn.Module, old_shapes: list):
    """A new optimizer of ``opt``'s kind over ``module``'s (sharded)
    parameters, carrying ``opt``'s state sliced to the shards."""
    params = list(module.parameters())
    new = type(opt)(params, **opt.defaults)
    dims, group = _param_dims(module), _group_of(module)
    shapes = {id(p): old_shapes[i] for i, p in enumerate(params)}
    new.load_state_dict(_slice_optimizer_state(opt.state_dict(), params,
                                               dims, group, shapes))
    return new


def shard_train_state_fsdp(state, mesh):
    """TrainState placement: G's, D's and the EMA's parameters and both
    optimizers' moments sharded over ``model``; buffers, key, step and
    ADA's p and r_t replicated.  In place; returns the state."""
    from tpugan_torch.parallel.mesh import shard_train_state

    shard_train_state(state, mesh)  # every rank starts from one state
    shapes_g = [tuple(p.shape) for p in state.g.parameters()]
    shapes_d = [tuple(p.shape) for p in state.d.parameters()]
    shard_params_fsdp(state.g, mesh)
    shard_params_fsdp(state.d, mesh)
    if state.g_ema is not None:
        shard_params_fsdp(state.g_ema, mesh)
    state.opt_g = _reshard_optimizer(state.opt_g, state.g, shapes_g)
    state.opt_d = _reshard_optimizer(state.opt_d, state.d, shapes_d)
    state.fsdp = True
    return state


def dense_copy(module: nn.Module) -> nn.Module:
    """A whole, unhooked copy of an FSDP-placed module for eval-mode use
    on one rank (sample grids, FID); collective over ``model``."""
    full = full_parameters(module)
    out = copy.deepcopy(module)
    with torch.no_grad():
        for prefix, sub in out.named_modules():
            spec = sub.__dict__.pop("_fsdp", None)
            if spec is None:
                continue
            for name in spec[0]:
                key = f"{prefix}.{name}" if prefix else name
                sub._parameters[name] = nn.Parameter(
                    full[key].clone(), requires_grad=False)
    return out
