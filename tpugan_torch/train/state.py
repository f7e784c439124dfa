"""The training state (port of ``tpugan/train/state.py``).

The JAX package keeps everything in one donated pytree.  Here the state is
the two modules (parameters, BatchNorm running statistics and spectral
norm's ``u``, updated in place), their two ``torch.optim`` optimizers, the
threefry key of the run's random stream (a numpy ``uint32`` pair,
``sample/threefry.py``), the step counter and, under ``train.ema > 0``, the
EMA of G: a copy of G (``g_ema``) whose parameters the step averages and
which takes no gradient, and under ``train.ada_target != 0`` ADA's
``ada_p`` and ``ada_rt``: 0-dim float32 tensors on the modules' device,
which the step updates there.  The optimizers are the same updates as the JAX
package's optax ones: ``torch.optim.Adam`` is optax's ``adam``, and
``torch.optim.RMSprop`` (eps outside the square root, no momentum) is
optax's ``rmsprop`` with ``eps_in_sqrt=False``.

The learning rate under ``optim.schedule="linear"`` is optax's
``linear_schedule`` in float32, evaluated at the optimizer's own update
count (the number of its previous updates, which ``torch.optim`` keeps per
parameter as ``step`` and a checkpoint carries): ``set_lr`` writes it into
the param groups before each update.  ``torch.optim.lr_scheduler`` is not
used: its count is a second counter, outside the optimizer's state.

``state_dict()`` / ``load_state_dict()`` hold everything an exact resume
needs (``ckpt/checkpoint.py`` saves them).  Under FSDP (``fsdp`` set by
``parallel/fsdp.shard_train_state_fsdp``) the modules and the optimizers'
moments hold shards: ``state_dict()`` gathers them (a collective: every
rank calls it) into the dense layout, and ``load_state_dict()`` takes the
dense layout and keeps this rank's shards, so a checkpoint is the same
under any mesh.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional

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
    # EMA of G's parameters (None when train.ema == 0); its buffers are
    # G's, copied in before it generates (``sync_ema_buffers``)
    g_ema: Optional[nn.Module] = None
    # ADA (None unless train.ada_target != 0): the augmentation probability
    # p and the running estimate of r_t = E[sign(D(real))]
    ada_p: Optional[torch.Tensor] = None
    ada_rt: Optional[torch.Tensor] = None
    # parameters and moments sharded over a mesh's 'model' axis
    fsdp: bool = False

    def state_dict(self) -> dict:
        """Modules, optimizers, key, step and ADA's state, as
        ``torch.load`` takes back with ``weights_only=True`` (the key as two
        ints)."""
        if self.fsdp:
            from tpugan_torch.parallel import fsdp

            module_sd, ema_params = fsdp.full_state_dict, fsdp.full_parameters
            opt_sd = fsdp.full_optimizer_state_dict
        else:
            def module_sd(m):
                return m.state_dict()

            def ema_params(m):
                return {k: p.detach() for k, p in m.named_parameters()}

            def opt_sd(opt, m):
                return opt.state_dict()
        return {
            "step": int(self.step), "rng": [int(v) for v in self.rng],
            "g": module_sd(self.g), "d": module_sd(self.d),
            "opt_g": opt_sd(self.opt_g, self.g),
            "opt_d": opt_sd(self.opt_d, self.d),
            # the EMA's parameters: its buffers are G's (sync_ema_buffers)
            "g_ema": (None if self.g_ema is None else
                      ema_params(self.g_ema)),
            "ada_p": self.ada_p, "ada_rt": self.ada_rt,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore ``state_dict()``'s output in place, onto the modules'
        own device."""
        if (sd["g_ema"] is None) != (self.g_ema is None):
            raise ValueError(
                "the checkpoint's EMA of G and this state's disagree "
                "(train.ema must match the run that saved it)")
        if (sd.get("ada_p") is None) != (self.ada_p is None):
            raise ValueError(
                "the checkpoint's ADA state and this state's disagree "
                "(train.ada_target must be nonzero in both or in neither)")
        if self.fsdp:
            from tpugan_torch.parallel import fsdp

            load_module = fsdp.load_full_state_dict

            def load_opt(opt, m, osd):
                fsdp.load_full_optimizer_state_dict(opt, m, osd)
        else:
            def load_module(m, msd, params_only=False):
                if not params_only:
                    return m.load_state_dict(msd)
                with torch.no_grad():
                    for k, p in m.named_parameters():
                        p.copy_(msd[k])

            def load_opt(opt, m, osd):
                opt.load_state_dict(osd)
        load_module(self.g, sd["g"])
        load_module(self.d, sd["d"])
        if self.g_ema is not None:
            params = dict(self.g_ema.named_parameters())
            if sorted(params) != sorted(sd["g_ema"]):
                raise KeyError(f"EMA keys {sorted(sd['g_ema'])} are not G's "
                               f"parameters {sorted(params)}")
            load_module(self.g_ema, sd["g_ema"], params_only=True)
        for opt, m, key in ((self.opt_g, self.g, "opt_g"),
                            (self.opt_d, self.d, "opt_d")):
            load_opt(opt, m, sd[key])
            # torch.optim keeps a non-capturable count on the CPU, wherever
            # the checkpoint was mapped to
            for st in opt.state.values():
                if torch.is_tensor(st.get("step")):
                    st["step"] = st["step"].cpu()
        if self.ada_p is not None:
            dev = self.ada_p.device
            self.ada_p = sd["ada_p"].to(dev, torch.float32)
            self.ada_rt = sd["ada_rt"].to(dev, torch.float32)
        self.rng = np.array(sd["rng"], np.uint32)
        self.step = int(sd["step"])


def lr_schedule(cfg: Config, lr: float, every: int = 1
                ) -> Optional[Callable[[int], np.float32]]:
    """The configured LR schedule for one optimizer: None for "constant"
    (the optimizer keeps ``lr``), else count -> float32 LR in that
    optimizer's own update-count domain.

    "linear" is optax's ``linear_schedule(lr, 0, transition_steps,
    transition_begin)`` (``polynomial_schedule`` with power 1) in its own
    float32 arithmetic: ``lr * (1 - clip(count - begin, 0, T) / T)``.
    ``every`` converts the trainer-step decay window into the count domain
    of an optimizer that updates every ``every``-th step (G under
    n_critic), as the JAX package does.
    """
    o = cfg.optim
    if o.schedule == "constant":
        return None
    if o.schedule == "linear":
        total = max(cfg.train.total_steps // every, 1)
        begin = int(total * o.decay_start_frac)
        steps = max(total - begin, 1)

        def schedule(count: int) -> np.float32:
            c = min(max(int(count) - begin, 0), steps)
            frac = np.float32(1) - np.float32(c) / np.float32(steps)
            return np.float32(lr) * frac

        return schedule
    raise ValueError(f"unknown optim.schedule {o.schedule!r}")


def update_count(opt: torch.optim.Optimizer) -> int:
    """The optimizer's number of previous updates (0 before the first)."""
    for st in opt.state.values():
        if "step" in st:
            return int(st["step"])
    return 0


def set_lr(opt: torch.optim.Optimizer, schedule) -> None:
    """Write the schedule's LR for the coming update into every param
    group (a constant schedule, None, leaves the groups alone)."""
    if schedule is None:
        return
    lr = float(schedule(update_count(opt)))
    for group in opt.param_groups:
        group["lr"] = lr


def make_schedules(cfg: Config):
    """(G's schedule, D's schedule): G's in its count domain, which
    advances once every n_critic steps."""
    o = cfg.optim
    return (lr_schedule(cfg, o.lr_g, every=max(cfg.loss.n_critic, 1)),
            lr_schedule(cfg, o.lr_d))


def make_optimizers(cfg: Config, g: nn.Module, d: nn.Module):
    """(opt_g, opt_d) over the two modules' parameters, at the schedules'
    first LR."""
    o = cfg.optim
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
    opt_g, opt_d = mk(g.parameters(), o.lr_g), mk(d.parameters(), o.lr_d)
    for opt, schedule in zip((opt_g, opt_d), make_schedules(cfg)):
        set_lr(opt, schedule)
    return opt_g, opt_d


@torch.no_grad()
def ema_update(g_ema: nn.Module, g: nn.Module, decay: float) -> None:
    """``e * decay + p * (1 - decay)`` for every parameter, in fp32 on the
    master parameters, as the JAX step computes it."""
    for e, p in zip(g_ema.parameters(), g.parameters()):
        e.copy_(e * decay + p * (1.0 - decay))


@torch.no_grad()
def sync_ema_buffers(state: TrainState) -> None:
    """Copy G's live buffers (BatchNorm running statistics, spectral norm's
    ``u``) into the EMA module, as the JAX trainer samples from
    (``params_g_ema``, ``state_g``)."""
    for e, b in zip(state.g_ema.buffers(), state.g.buffers()):
        e.copy_(b)


def create_train_state(cfg: Config, g: nn.Module, d: nn.Module
                       ) -> TrainState:
    """Optimizers for (g, d), the EMA copy of g under ``train.ema > 0``,
    ADA's p and r_t (zero) under ``train.ada_target != 0``, and the run's
    key, as the JAX package derives it: the third of
    ``split(PRNGKey(train.seed), 3)``."""
    opt_g, opt_d = make_optimizers(cfg, g, d)
    g_ema = (copy.deepcopy(g).requires_grad_(False) if cfg.train.ema > 0
             else None)
    rng = threefry.split(threefry.prng_key(cfg.train.seed), 3)[2]
    ada_p = ada_rt = None
    if cfg.train.ada_target != 0:
        dev = next(g.parameters()).device
        ada_p = torch.zeros((), dtype=torch.float32, device=dev)
        ada_rt = torch.zeros((), dtype=torch.float32, device=dev)
    return TrainState(g=g, d=d, opt_g=opt_g, opt_d=opt_d, rng=rng, step=0,
                      g_ema=g_ema, ada_p=ada_p, ada_rt=ada_rt)
