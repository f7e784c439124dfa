"""The training state (port of ``tpugan/train/state.py``).

The JAX package keeps everything in one donated pytree.  Here the state is
the two modules (parameters and BatchNorm running statistics, updated in
place), their two ``torch.optim`` optimizers, the threefry key of the run's
random stream (a numpy ``uint32`` pair, ``sample/threefry.py``) and the step
counter.  The optimizers are the same updates as the JAX package's optax
ones: ``torch.optim.Adam`` is optax's ``adam``, and ``torch.optim.RMSprop``
(eps outside the square root, no momentum) is optax's ``rmsprop`` with
``eps_in_sqrt=False``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from tpugan_torch.configs import Config
from tpugan_torch.sample import threefry


@dataclass
class TrainState:
    g: nn.Module
    d: nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    rng: np.ndarray  # (2,) uint32 threefry key
    step: int = 0


def make_optimizers(cfg: Config, g: nn.Module, d: nn.Module):
    """(opt_g, opt_d) over the two modules' parameters."""
    o = cfg.optim
    if o.schedule != "constant":
        raise NotImplementedError(
            f"optim.schedule={o.schedule!r} is not ported yet (ROADMAP.md, "
            f"Queue A: 'Optimizers and TrainState', lr_schedule)")
    if o.optimizer == "adam":
        def mk(params, lr):
            return torch.optim.Adam(params, lr=lr, betas=(o.beta1, o.beta2),
                                    eps=o.eps)
    elif o.optimizer == "rmsprop":
        def mk(params, lr):
            return torch.optim.RMSprop(params, lr=lr, alpha=o.rmsprop_decay,
                                       eps=o.eps)
    else:
        raise ValueError(f"unknown optimizer {o.optimizer!r}")
    return mk(g.parameters(), o.lr_g), mk(d.parameters(), o.lr_d)


def create_train_state(cfg: Config, g: nn.Module, d: nn.Module
                       ) -> TrainState:
    """Optimizers for (g, d) and the run's key, as the JAX package derives
    it: the third of ``split(PRNGKey(train.seed), 3)``."""
    if cfg.train.ema > 0:
        raise NotImplementedError(
            "train.ema is not ported yet (ROADMAP.md, Queue A: 'Optimizers "
            "and TrainState', EMA of G)")
    if cfg.train.ada_target != 0:
        raise NotImplementedError(
            "train.ada_target is not ported yet (ROADMAP.md, Queue A: "
            "'Augment')")
    opt_g, opt_d = make_optimizers(cfg, g, d)
    rng = threefry.split(threefry.prng_key(cfg.train.seed), 3)[2]
    return TrainState(g=g, d=d, opt_g=opt_g, opt_d=opt_d, rng=rng, step=0)
