"""Export a port training state as a reference-style torch ``.pth`` (port
of ``tpugan/ckpt/torch_export.py``).

The inverse of ``ckpt/torch_import.py``: a model trained or fine-tuned here
goes back to any torch DCGAN-family codebase as ``torch.save`` of
``{"G", "D", "step", "ema", "opt_G", "opt_D", "tpugan_export"}``, the G and
D ``state_dict``s of the reference nets (``ckpt/reference_nets.py``), with
BatchNorm running statistics and spectral norm's ``u`` carried.

The optimizers' state is written in torch's own ``optimizer.state_dict()``
format, indexed by the reference nets' ``parameters()`` order; each moment
is transposed as its weight is.  A torch user can ``load_state_dict`` it
into an ``Adam`` / ``RMSprop`` over those nets and fine-tune warm, and
``import-torch`` (of either package) restores it.  Its ``lr`` is the LR in
effect at the optimizer's own update count (``_effective_lr``): torch's
``load_state_dict`` takes the saved group's LR, so under a linear schedule
the initial LR would be wrong.  ``ema`` and ``tpugan_export`` record which
generator weights were written and under which update rule.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from tpugan_torch.ckpt.reference_nets import (build_reference_nets, key_map,
                                              to_reference)
from tpugan_torch.configs import Config
from tpugan_torch.train.state import TrainState, lr_schedule, update_count

EXPORT_VERSION = 1
# the moments of each update rule's torch state, by optimizer
MOMENTS = {"adam": ("exp_avg", "exp_avg_sq"), "rmsprop": ("square_avg",)}


def _effective_lr(cfg: Config, lr: float, count: int, every: int = 1
                  ) -> float:
    """The LR in effect at the optimizer's update count ``count``: the
    configured schedule (``train/state.lr_schedule``) evaluated there."""
    s = lr_schedule(cfg, lr, every)
    return float(s(count)) if s is not None else float(lr)


def _moments(net, module, opt, fields) -> List[Dict[str, torch.Tensor]]:
    """``opt``'s per-parameter ``fields`` of ``module`` in ``net``'s
    ``parameters()`` order and layouts; a parameter with no state yet (no
    update taken) has zero moments."""
    kmap = key_map(net)
    params = dict(module.named_parameters())
    out = []
    for name, _ in net.named_parameters():
        port_key, kind = kmap[name]
        p = params[port_key]
        st = opt.state.get(p, {})
        out.append({f: to_reference(st[f] if f in st else torch.zeros_like(p),
                                    kind) for f in fields})
    return out


def _torch_opt_state_dict(o, lr: float, moments: List[Dict], count: int
                          ) -> Dict:
    """torch-native ``optimizer.state_dict()`` for the configured rule,
    hyperparameters from ``cfg.optim``."""
    n = len(moments)
    if o.optimizer == "adam":
        state = {i: {"step": torch.tensor(float(count)),
                     "exp_avg": moments[i]["exp_avg"],
                     "exp_avg_sq": moments[i]["exp_avg_sq"]}
                 for i in range(n)}
        group = {"lr": lr, "betas": (o.beta1, o.beta2), "eps": o.eps,
                 "weight_decay": 0.0, "amsgrad": False, "maximize": False,
                 "foreach": None, "capturable": False,
                 "differentiable": False, "fused": None,
                 "params": list(range(n))}
    elif o.optimizer == "rmsprop":
        state = {i: {"step": count, "square_avg": moments[i]["square_avg"]}
                 for i in range(n)}
        group = {"lr": lr, "momentum": 0.0, "alpha": o.rmsprop_decay,
                 "eps": o.eps, "centered": False, "weight_decay": 0.0,
                 "foreach": None, "maximize": False, "capturable": False,
                 "differentiable": False, "params": list(range(n))}
    else:
        raise ValueError(f"unknown optimizer {o.optimizer!r}")
    return {"state": state, "param_groups": [group]}


def export_torch_checkpoint(cfg: Config, state: TrainState,
                            use_ema: bool = False,
                            include_opt: bool = True) -> Dict:
    """TrainState -> ``{"G", "D", "step", "ema", "opt_G", "opt_D",
    "tpugan_export"}``, every tensor on the CPU.

    ``use_ema=True`` writes the EMA of G's parameters (with G's buffers,
    which the EMA samples with) in G's slot; the run must keep one
    (``train.ema > 0``).  ``opt_G`` is then still the raw G's moments: the
    EMA has none of its own.  ``include_opt=False`` drops the optimizers'
    state.
    """
    g_sd = dict(state.g.state_dict())
    if use_ema:
        if state.g_ema is None:
            raise ValueError(
                "use_ema=True but the checkpoint has no EMA weights "
                "(train.ema was 0 for this run)")
        g_sd.update({k: p.detach()
                     for k, p in state.g_ema.named_parameters()})
    tg, td = build_reference_nets(cfg, g_sd, state.d.state_dict())
    out = {"G": tg.state_dict(), "D": td.state_dict(),
           "step": int(state.step), "ema": bool(use_ema),
           "tpugan_export": {"version": EXPORT_VERSION,
                             "optimizer": cfg.optim.optimizer,
                             "ema": bool(use_ema)}}
    if include_opt:
        o = cfg.optim
        for key, net, module, opt, lr, every in (
                ("opt_G", tg, state.g, state.opt_g, o.lr_g,
                 max(cfg.loss.n_critic, 1)),
                ("opt_D", td, state.d, state.opt_d, o.lr_d, 1)):
            count = update_count(opt)
            out[key] = _torch_opt_state_dict(
                o, _effective_lr(cfg, lr, count, every),
                _moments(net, module, opt, MOMENTS[o.optimizer]), count)
    return out
