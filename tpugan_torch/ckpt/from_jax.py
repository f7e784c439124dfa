"""Carry ``tpugan`` weights and training state into the port.

The JAX package keeps params and state as nested dicts (``head.dense.w``,
``block{i}.conv.{w,b}``, ``block{i}.bn.{scale,bias}``, state
``block{i}.bn.{mean,var}``, ``final.conv.{w,b}``, ``tail.dense.{w,b}``,
spectral norm's state ``block{i}.conv.u`` and ``tail.dense.u``,
``embed.table``, the conditional generator's ``g.*`` and the conditional
discriminator's ``proj.{w,b}`` and ``d.*``).  The port's modules keep the
same layouts under the same names, so carrying weights across is a name
map: the dotted keys of params and state together are the module's
``state_dict`` keys.  Spectral norm's ``u`` is a buffer, not a parameter,
so the optimizer moments still match ``named_parameters()``.

``load_jax_train_state`` carries a whole JAX ``TrainState`` (both modules,
the EMA of G, the optimizers' moments and counts, the LR schedule's count,
ADA's ``ada_p`` and ``ada_rt``, the run's key and step) into a port
``TrainState``.  It reads the JAX state by field name and the optax states
by their fields, and imports nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested dicts -> {dotted key: leaf}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


@torch.no_grad()
def load_jax_module(module: torch.nn.Module, params: Mapping,
                    state: Mapping) -> torch.nn.Module:
    """Copy JAX ``params`` and ``state`` (nested dicts of arrays) into
    ``module`` in place; returns it.  A missing or extra key, or a wrong
    shape, raises."""
    src = flatten(params)
    for k, v in flatten(state).items():
        if k in src:
            raise KeyError(f"{k!r} is both a param and a state entry")
        src[k] = v
    dst = module.state_dict(keep_vars=True)
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"key mismatch: missing {missing}, extra {extra}")
    for k, t in dst.items():
        arr = _tensor(src[k])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{k}: shape {tuple(arr.shape)} != "
                             f"{tuple(t.shape)}")
        t.copy_(arr)
    return module


def _schedule_count(opt_state):
    """The update count of an optax chain under a schedule: the count of
    its ``ScaleByScheduleState`` (optax 0.2.6: ``(ScaleByAdamState,
    ScaleByScheduleState)`` for adam, ``(ScaleByRmsState,
    ScaleByScheduleState, EmptyState)`` for rmsprop), or None for a
    constant LR."""
    for s in opt_state[1:]:
        if type(s).__name__ == "ScaleByScheduleState":
            return int(np.asarray(s.count))
    return None


@torch.no_grad()
def _load_optimizer(opt: torch.optim.Optimizer, module: torch.nn.Module,
                    opt_state) -> None:
    # optax adam / rmsprop: (ScaleByAdamState(count, mu, nu), ...) or
    # (ScaleByRmsState(nu), ...), then the LR's state
    f = opt_state[0]._asdict()
    params = dict(module.named_parameters())
    nu = flatten(f["nu"])
    if sorted(nu) != sorted(params):
        raise KeyError(f"optimizer moments {sorted(nu)} do not match the "
                       f"parameters {sorted(params)}")
    scheduled = _schedule_count(opt_state)
    if isinstance(opt, torch.optim.Adam):
        keys = {"exp_avg": flatten(f["mu"]), "exp_avg_sq": nu}
        count = float(np.asarray(f["count"]))
    elif isinstance(opt, torch.optim.RMSprop):
        keys = {"square_avg": nu}
        # optax's rms state keeps no count: under a schedule the schedule's
        # is the update count; under a constant LR torch's is unused
        count = 0.0
    else:
        raise TypeError(f"unsupported optimizer {type(opt).__name__}")
    if scheduled is not None:
        count = float(scheduled)
    for name, p in params.items():
        st = {"step": torch.tensor(count)}
        for key, tree in keys.items():
            st[key] = _tensor(tree[name]).to(p.device)
        opt.state[p] = st


def load_jax_train_state(state, jax_state):
    """Copy a JAX ``TrainState`` (host copy, e.g. ``jax.device_get`` of it)
    into the port's ``TrainState`` in place; returns it.  The EMA of G
    (``params_g_ema``, with G's own BatchNorm state) goes into
    ``state.g_ema``, ADA's ``ada_p`` and ``ada_rt`` into the state's; both
    or neither must have each."""
    src = dict(jax_state)
    if (src.get("ada_p") is None) != (state.ada_p is None):
        raise ValueError("ada_p and the port state's disagree "
                         "(train.ada_target must match)")
    if (src.get("params_g_ema") is None) != (state.g_ema is None):
        raise ValueError("params_g_ema and the port state's g_ema disagree "
                         "(train.ema must match)")
    load_jax_module(state.g, src["params_g"], src["state_g"])
    load_jax_module(state.d, src["params_d"], src["state_d"])
    if state.g_ema is not None:
        load_jax_module(state.g_ema, src["params_g_ema"], src["state_g"])
    _load_optimizer(state.opt_g, state.g, src["opt_g"])
    _load_optimizer(state.opt_d, state.d, src["opt_d"])
    if state.ada_p is not None:
        dev = state.ada_p.device
        state.ada_p = _tensor(src["ada_p"]).to(dev)
        state.ada_rt = _tensor(src["ada_rt"]).to(dev)
    state.rng = np.array(src["rng"], np.uint32)
    state.step = int(np.asarray(src["step"]))
    return state
