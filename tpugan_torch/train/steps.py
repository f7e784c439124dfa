"""The alternating D/G train step (port of the alternating path of
``tpugan/train/steps.py``).

One call = one data batch = one D update, plus a G update when
``step % n_critic == n_critic - 1`` (every call for n_critic = 1):

- D step: G forward in train mode without gradients (it updates G's
  BatchNorm statistics; the reference's ``fake.detach()``), D on the real
  batch, then on the fake one, the D loss, D's optimizer step, and the WGAN
  weight clip.
- G step: G forward, D on the fake in train mode (it updates D's BatchNorm
  statistics, with the updated D), the G loss, G's optimizer step.  D's
  parameters are frozen for that backward, so no gradient reaches them.

The train-mode DBlock path ("on": the conv + BN-statistics kernel of
``ops/cuda_conv_stats.py``; "auto": on for CUDA tensors) is each DBlock's
own ``fuse_stats``, set from ``train.fuse_stats`` by ``build_models``.

BatchNorm statistics thus update in the JAX package's order: G's in both
steps, D's on the real and fake forwards of the D step and again in the G
step.  Modules and optimizers update in place; the step returns the same
``TrainState`` with its key and counter advanced.

RNG: each step splits the state's threefry key into 8 as the JAX step does
(``sample/threefry.py``), and draws the hflip bits and both latents from the
same keys, so from one carried state the two packages see the same noise.
Batch entries ``z_d`` / ``z_g`` replace the drawn latents (the JAX step's
parity hook).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from tpugan_torch.configs import Config
from tpugan_torch.losses.adversarial import d_loss_fn, g_loss_fn
from tpugan_torch.sample import threefry
from tpugan_torch.train.state import TrainState


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet (ROADMAP.md, Queue A: {item!r})")


def check_supported(cfg: Config) -> None:
    """Raise on an option of the JAX train step that the port does not
    take."""
    t, kind = cfg.train, cfg.loss.kind
    if kind == "wgan_gp":
        raise _not_ported("loss.kind='wgan_gp' (the gradient penalty)",
                          "Discriminator models")
    if cfg.model.arch == "cdcgan":
        raise _not_ported("model.arch='cdcgan' (the conditional D)",
                          "Discriminator models")
    if t.augment or t.ada_target != 0:
        raise _not_ported("train.augment / train.ada_target", "Augment")
    if t.fused_prop:
        raise _not_ported("train.fused_prop", "Train step")
    if t.grad_accum != 1:
        raise _not_ported("train.grad_accum > 1", "Train step")
    if t.steps_per_call > 1:
        raise _not_ported("train.steps_per_call > 1", "Train step")
    if t.remat:
        raise _not_ported("train.remat", "Train step")
    if cfg.data.device_resident:
        raise _not_ported("data.device_resident", "Data")
    if kind in ("wgan", "hinge") and (cfg.loss.real_label != 1.0
                                      or cfg.loss.fake_label != 0.0):
        raise ValueError(
            f"loss.real_label/fake_label have no effect under {kind!r} (no "
            f"label targets in that objective); label smoothing applies to "
            f"bce/lsgan only")


def build_train_step(cfg: Config, g: nn.Module, d: nn.Module
                     ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                             Dict]]:
    """Return the train step for (cfg, g, d): ``step(state, batch) ->
    (state, metrics)`` with ``batch["image"]`` (N, S, S, C) uint8 or float
    on the modules' device; metrics are 0-dim tensors left on the device."""
    check_supported(cfg)
    kind, nz, n_critic = cfg.loss.kind, cfg.model.nz, cfg.loss.n_critic
    hflip = cfg.data.hflip
    clip = cfg.loss.clip_value if kind == "wgan" else None

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        # the trainer's sample grids put G in eval mode between steps
        g.train()
        d.train()
        (rng, k_zd, k_zg, _k_gp, _k_yd, _k_yg, k_flip,
         _k_data) = threefry.split(state.rng, 8)
        x_real = batch["image"]
        dev = x_real.device
        bsz = x_real.shape[0]
        if x_real.dtype == torch.uint8:
            x_real = x_real.float() / 127.5 - 1.0
        if hflip:
            flip = torch.from_numpy(
                threefry.uniform(k_flip, (bsz, 1, 1, 1)) < 0.5).to(dev)
            x_real = torch.where(flip, x_real.flip(2), x_real)

        def latents(name, key):
            z = batch.get(name)
            if z is None:
                z = threefry.normal(key, (bsz, nz))
            return torch.as_tensor(z, device=dev).float()

        # --- D update ---
        z_d = latents("z_d", k_zd)
        with torch.no_grad():
            fake = g(z_d)
        state.opt_d.zero_grad(set_to_none=True)
        real_logits = d(x_real)
        fake_logits = d(fake)
        loss_d = d_loss_fn(kind, real_logits, fake_logits,
                           real_label=cfg.loss.real_label,
                           fake_label=cfg.loss.fake_label)
        loss_d.backward()
        state.opt_d.step()
        if clip is not None:
            # original WGAN critic weight clipping (Lipschitz constraint)
            with torch.no_grad():
                for p in d.parameters():
                    p.clamp_(-clip, clip)
        metrics = {
            "loss_d": loss_d.detach(),
            "d_real": real_logits.detach().float().mean(),
            "d_fake": fake_logits.detach().float().mean(),
            # the gradient penalty is not ported: kept so the logged keys
            # are the JAX package's
            "gp": torch.zeros((), device=dev),
        }

        # --- G update (every n_critic-th call) ---
        if n_critic == 1 or state.step % n_critic == n_critic - 1:
            z_g = latents("z_g", k_zg)
            state.opt_g.zero_grad(set_to_none=True)
            d.requires_grad_(False)
            try:
                loss_g = g_loss_fn(kind, d(g(z_g)))
                loss_g.backward()
            finally:
                d.requires_grad_(True)
            state.opt_g.step()
            metrics["loss_g"] = loss_g.detach()
        else:
            metrics["loss_g"] = torch.zeros((), device=dev)
        state.rng = rng
        state.step += 1
        return state, metrics

    return step
