"""The train step (port of ``tpugan/train/steps.py``).

One call = one data batch = one D update, plus a G update when
``step % n_critic == n_critic - 1`` (every call for n_critic = 1):

- D step: G forward in train mode without gradients (it updates G's
  BatchNorm statistics; the reference's ``fake.detach()``), D on the real
  batch, then on the fake one, the D loss (under ``wgan_gp`` plus lambda
  times the gradient penalty, taken through D in eval mode: BatchNorm's
  running statistics and spectral norm's stored ``u``, nothing updated),
  D's optimizer step, and the WGAN weight clip.
- G step: G forward, D on the fake in train mode (it updates D's BatchNorm
  statistics, with the updated D), the G loss, G's optimizer step, then the
  EMA of G (``train.ema``).  D's parameters are frozen for that backward,
  so no gradient reaches them.

BatchNorm statistics and spectral norm's ``u`` thus update in the JAX
package's order: G's in both steps, D's on the real and fake forwards of
the D step and again in the G step.  Modules and optimizers update in
place; the step returns the same ``TrainState`` with its key and counter
advanced.

``train.fused_prop`` (FusedProp, arXiv:2004.03335; n_critic 1, no
penalty) shares one G forward between both updates: D on the real batch
and its gradient, then D once on the fake batch as a leaf, and two pulls
from that one graph: the D loss's cotangent gives D's parameter gradient,
the G loss's gives the input gradient that G's backward takes.  Both use
the pre-update D; BatchNorm statistics and ``u`` move in JAX's order (G
once, D on the real then the fake forward); the EMA updates every step.

``train.grad_accum`` splits the batch into that many microbatches, run one
after another with the gradients summed, divided by the count and applied
in one update; BatchNorm statistics and ``u`` thread through the
microbatches in order, the penalty's key is ``split(k_gp, accum)``'s, and
the metrics are the means over microbatches.

``train.remat`` recomputes the train-mode G and D forwards in the backward
(``torch.utils.checkpoint``, non-reentrant) from the buffers the first
forward saw, leaving them as the first forward left them (``remat``).

``train.steps_per_call`` K > 1 runs K steps a call (the port of the JAX
package's ``lax.scan``): on a stacked host batch (leading axis K), one
slice a step, or on the same device-resident dataset; the metrics are the
last step's.

Device-resident data (``data.device_resident``): the batch is
``{"dataset_images", "dataset_labels"}``, the whole uint8 dataset on the
device, and each step gathers its rows by index on the device: uniform
with replacement from ``k_data`` (``sampling="replacement"``) or the
epoch permutations of ``epoch_indices`` (``"epoch"``), drawn on the host
as the JAX step draws them.

The train-mode DBlock path ("on": the conv + BN-statistics kernel of
``ops/cuda_conv_stats.py``; "auto": on for CUDA tensors) is each DBlock's
own ``fuse_stats``, set from ``train.fuse_stats`` by ``build_models``.

The step's forwards run on PyTorch's ops whatever ``ops.convs``' default
impl is (``convs.using_impl("xla")``): the kernels behind "pallas" are
forward-only, and the JAX package's step never reaches a Pallas kernel
either.  The conv + BN-statistics kernel, which has a backward, is not an
impl: ``fuse_stats`` selects it.

Conditional models (``cdcgan``): G takes (z, y) and D (x, y); the real
labels are ``batch["label"]``, the fake ones a ``randint`` draw per update.

``train.augment`` (``ops/augment.py``) augments every image D sees: in the
D update the reals and the fakes with fresh draws (``ka_r, ka_f =
split(k_aug_d)``), under ``wgan_gp`` the penalty's interpolates between
the augmented pair, in the G update the fake differentiably (``k_aug_g``);
under FusedProp the one fake forward's augmentation is shared by both
pulls, and under ``grad_accum`` each microbatch takes its own key of
``split(k_aug, accum)``.  ``train.ada_target`` (ADA, bce or hinge only)
gates each op at probability ``state.ada_p``: after D's gradients the step
folds ``rt_batch = mean(sign(D(real)))`` into ``state.ada_rt`` by
``ada_rt_alpha(bsz)`` and moves ``p`` by ``sign(rt - target) * bsz /
(ada_kimg * 1000)``, clipped to [0, 1], in float32 on the device (no
sync); both updates of a step augment at the step's incoming ``p``.  The
metrics then carry ``ada_p``, ``ada_rt`` and ``ada_rt_batch``.

RNG: each step splits the state's threefry key into 8 as the JAX step does
(``sample/threefry.py``), 10 under a policy (``k_aug_d``, ``k_aug_g``
last), and draws the hflip bits, both latents, both fake label sets, the
penalty's interpolation weights, the resident batch's indices and the
augmentation from the same keys, so from one carried state the two
packages see the same noise and data.  The key stays a host array and is
split on the host.  The hflip bits, the latents, the fake labels and the
indices under ``sampling="replacement"`` are drawn where the batch lies,
by ``ops/cuda_threefry.py``: on a CUDA device one launch of the threefry
kernel each, written on the current stream (no copy, no wait; under a
``data`` mesh the global draw at this rank's rows, by an index uploaded
once a batch size); on the CPU the host draw itself.  Batch entries
``z_d`` / ``z_g``, ``y_fake_d`` / ``y_fake_g`` and ``gp_alpha`` replace the
draws (the JAX step's parity hooks); they, the ``"epoch"`` permutations,
the penalty's weights and the augmentation's draws are host arrays copied
to the device.  The LR under a schedule is set before each update from the
optimizer's own count (``train/state.py``).

Spans (``utils/tracing.py``, on while a ``torch.profiler`` records): each
step is ``step``, holding ``step.draws`` (the host's threefry splits, the
draws' launches, counted as ``device_draws``, and the host draws' blocking
copies to the device, each an ``h2d`` span and counted as
``h2d_blocking``; the penalty's under ``step.d_grads``),
``step.real_batch`` (gather, uint8 to float, flip), ``step.grads``
(FusedProp) or ``step.d_grads`` and ``step.g_grads``, and ``step.d_update``
and ``step.g_update`` (the optimizers; ``step.ema`` under G's).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpugan_torch.configs import Config
from tpugan_torch.losses.adversarial import (d_loss_fake_fn, d_loss_fn,
                                             d_loss_real_fn, g_loss_fn)
from tpugan_torch.losses.gradient_penalty import gradient_penalty
from tpugan_torch.ops import convs, cuda_threefry
from tpugan_torch.ops.augment import apply_policy, parse_policy
from tpugan_torch.parallel import collectives
from tpugan_torch.parallel.mesh import (axis_group, axis_index, axis_size,
                                        batch_ctx)
from tpugan_torch.parallel.multihost import local_rows
from tpugan_torch.sample import threefry
from tpugan_torch.train.state import (TrainState, ema_update, make_schedules,
                                      set_lr)
from tpugan_torch.utils.tracing import h2d, span


# ADA's r_t is an EMA over an image budget: alpha = 1 - bsz / window gives
# every batch size the same ~1280-image memory (0.9 at batch 128), and
# clamps at 0.5 so one batch never overwrites the estimate.
_ADA_RT_IMG_WINDOW = 1280.0


def ada_rt_alpha(bsz: int) -> float:
    """EMA blend factor for ADA's r_t estimate at this batch size."""
    return max(0.5, 1.0 - bsz / _ADA_RT_IMG_WINDOW)


def check_supported(cfg: Config) -> tuple[str, ...]:
    """Raise on a combination the JAX train step refuses; returns the
    augmentation policy (empty when ``train.augment`` is off)."""
    t, kind = cfg.train, cfg.loss.kind
    policy = parse_policy(t.augment) if t.augment else ()
    if t.ada_target != 0 and not policy:
        raise ValueError(
            "nonzero train.ada_target requires train.augment to name at "
            "least one op (e.g. 'color,translation,cutout')")
    if t.ada_target != 0 and kind not in ("bce", "hinge"):
        # r_t = E[sign(D(real))] needs a zero-calibrated logit: it
        # saturates under lsgan and has no calibrated zero under wgan
        raise ValueError(
            f"train.ada_target requires a zero-calibrated logit loss "
            f"(bce or hinge), not {kind!r}: r_t = E[sign(D(real))] "
            f"saturates under lsgan and is uncalibrated for wgan, so p "
            f"would ramp to 1.0 regardless of overfitting; use fixed-p "
            f"DiffAugment (train.augment without ada_target) instead")
    if t.fused_prop and (kind == "wgan_gp" or cfg.loss.n_critic != 1):
        raise ValueError(
            "train.fused_prop requires n_critic == 1 and no gradient "
            "penalty (loss.kind != 'wgan_gp')")
    if t.grad_accum < 1:
        raise ValueError(f"train.grad_accum must be >= 1, got {t.grad_accum}")
    if t.grad_accum > 1:
        if t.fused_prop:
            raise ValueError("train.grad_accum requires fused_prop off (the "
                             "fused path shares one full-batch "
                             "linearization)")
        if cfg.data.batch_size % t.grad_accum:
            raise ValueError(
                f"data.batch_size {cfg.data.batch_size} not divisible by "
                f"train.grad_accum {t.grad_accum}")
    if kind in ("wgan", "wgan_gp", "hinge") and (
            cfg.loss.real_label != 1.0 or cfg.loss.fake_label != 0.0):
        raise ValueError(
            f"loss.real_label/fake_label have no effect under {kind!r} (no "
            f"label targets in that objective); label smoothing applies to "
            f"bce/lsgan only")
    return policy


def data_root(seed: int) -> np.ndarray:
    """The key of the per-epoch permutations: a function of the config seed
    alone, so the data order is resume-exact."""
    return threefry.fold_in(threefry.prng_key(seed), 0xDA7A)


def epoch_indices(root, step: int, bsz: int, n: int) -> np.ndarray:
    """DataLoader order (shuffle=True, without replacement) on a resident
    dataset: run position p reads ``perm_{p // n}[p % n]``, the
    permutation of ``fold_in(root, epoch)``.  A batch straddles at most two
    epochs, so ``bsz <= n``."""
    if bsz > n:
        raise ValueError(
            f"sampling='epoch' needs batch_size ({bsz}) <= dataset size "
            f"({n}); a batch may straddle at most two epochs")
    pos = step * bsz + np.arange(bsz)
    epoch, r = pos // n, pos % n
    perm_a = threefry.permutation(threefry.fold_in(root, epoch[0]), n)
    perm_b = threefry.permutation(threefry.fold_in(root, epoch[-1]), n)
    return np.where(epoch == epoch[0], perm_a[r], perm_b[r])


def remat(module: nn.Module, *args):
    """``module(*args)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) instead of kept.

    JAX recomputes functionally; a module's forward updates its buffers in
    place (BatchNorm's running statistics, spectral norm's ``u``), so a
    plain recomputation would update them twice and, under spectral norm,
    take sigma from a ``u`` the first forward already moved.  The
    recomputation therefore runs from the buffers the first forward saw
    and puts back the ones it found."""
    if not torch.is_grad_enabled():
        return module(*args)
    bufs = list(module.buffers())
    seen = [b.clone() for b in bufs]
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return module(*a)
        with torch.no_grad():
            found = [b.clone() for b in bufs]
            for b, v in zip(bufs, seen):
                b.copy_(v)
        try:
            return module(*a)
        finally:
            with torch.no_grad():
                for b, v in zip(bufs, found):
                    b.copy_(v)

    return checkpoint(run, *args, use_reentrant=False)


def _set_grads(params, grads) -> None:
    for p, gr in zip(params, grads):
        p.grad = gr


def build_train_step(cfg: Config, g: nn.Module, d: nn.Module, mesh=None
                     ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                             Dict]]:
    """Return the train step for (cfg, g, d): ``step(state, batch) ->
    (state, metrics)``, K = ``train.steps_per_call`` steps a call.  The
    batch is ``{"image": (N, S, S, C) uint8 or float, "label": (N,) int}``
    on the modules' device (a leading K axis when K > 1), or the resident
    ``{"dataset_images", "dataset_labels"}``; metrics are 0-dim tensors
    left on the device.

    ``mesh`` (``parallel/``) with a ``data`` axis of n > 1 ranks: the
    batch is this rank's rows of the global one (``local_rows``), and the
    step computes the single program's numbers: every draw is the global
    batch's, kept at this rank's rows; BatchNorm reduces over ``data``
    (``batch_ctx``); each loss is this rank's sum over the global batch
    size, so that each network's gradients, all-reduced over ``data`` as
    one buffer before its update, are the global mean's; the metrics are
    all-reduced.  The hooks ``z_d`` etc. then hold the global batch's
    values."""
    policy = check_supported(cfg)
    n_data = axis_size(mesh, "data")
    data_index = axis_index(mesh, "data")
    data_group = axis_group(mesh, "data")
    if (cfg.train.grad_accum > 1 and n_data > 1
            and (cfg.data.batch_size // cfg.train.grad_accum) % n_data):
        raise ValueError(
            f"microbatch size {cfg.data.batch_size // cfg.train.grad_accum} "
            f"(batch_size/grad_accum) not divisible by the 'data' mesh axis "
            f"({n_data})")
    ada_on = cfg.train.ada_target != 0
    kind, nz, n_critic = cfg.loss.kind, cfg.model.nz, cfg.loss.n_critic
    hflip = cfg.data.hflip
    clip = cfg.loss.clip_value if kind == "wgan" else None
    conditional = cfg.model.arch == "cdcgan"
    n_classes = cfg.model.n_classes
    accum = cfg.train.grad_accum
    ema_decay = cfg.train.ema
    bsz_cfg = cfg.data.batch_size
    root = data_root(cfg.train.seed)
    sched_g, sched_d = make_schedules(cfg)
    labels = dict(real_label=cfg.loss.real_label,
                  fake_label=cfg.loss.fake_label)

    def run(module, *args):
        return remat(module, *args) if cfg.train.remat else module(*args)

    def gen(z, y):
        return run(g, z, y) if conditional else run(g, z)

    def disc(x, y):
        return run(d, x, y) if conditional else run(d, x)

    def aug(x, key, p):
        return apply_policy(x, key, policy, 1.0 if p is None else p,
                            rows=micro_rows(x))

    def micro_rows(x):
        """(global size, this rank's rows) of a (micro)batch ``x``: a
        contiguous slice under the data mesh (microbatches are sharded
        row-contiguously), None without one."""
        if n_data == 1:
            return None
        per = x.shape[0]
        return (per * n_data,
                np.arange(data_index * per, (data_index + 1) * per))

    row_index = {}  # (global batch size, device) -> this rank's rows there

    def local(t):
        """The global batch's draw (or hook value) ``t``, a tensor, at this
        rank's rows."""
        if n_data == 1:
            return t
        bsz = t.shape[0]
        if (bsz, t.device) not in row_index:
            row_index[bsz, t.device] = h2d(
                local_rows(bsz, n_data, data_index, accum), t.device)
        return t.index_select(0, row_index[bsz, t.device])

    def share(loss):
        """This rank's part of a global-batch mean from its local mean."""
        return loss if n_data == 1 else loss / n_data

    def global_metrics(metrics):
        """Local means -> the global batch's, in one all-reduce."""
        if n_data == 1:
            return metrics
        keys = list(metrics)
        flat = torch.stack([metrics[k].detach().float() / n_data
                            for k in keys])
        dist.all_reduce(flat, group=data_group)
        return {k: flat[i] for i, k in enumerate(keys)}

    def sync_grads(module):
        # (a one-rank data axis too: its group's all-reduce runs)
        if data_group is not None:
            collectives.all_reduce_grads(module.parameters(), data_group)

    def aug_keys(key):
        """Each microbatch's augmentation key."""
        if not policy:
            return [None] * accum
        return threefry.split(key, accum) if accum > 1 else [key]

    def rt_batch(real_logits):
        # ADA's overfitting heuristic: E[sign(D(real))] drifts toward +1 as
        # D memorizes the reals
        return torch.sign(real_logits.detach().float()).mean()

    def ada_update(state, metrics, bsz):
        """Fold the batch's r_t into the state's and move p (module doc)."""
        if not ada_on:
            return metrics
        rt_b = metrics.pop("rt_batch")
        alpha = ada_rt_alpha(bsz)
        rt = state.ada_rt * alpha + rt_b * (1.0 - alpha)
        adj = torch.sign(rt - cfg.train.ada_target) * (
            bsz / (cfg.train.ada_kimg * 1000.0))
        state.ada_p = torch.clamp(state.ada_p + adj, 0.0, 1.0)
        state.ada_rt = rt
        return dict(metrics, ada_rt_batch=rt_b, ada_p=state.ada_p,
                    ada_rt=rt)

    def d_update(state):
        with span("step.d_update"):
            sync_grads(d)
            set_lr(state.opt_d, sched_d)
            state.opt_d.step()
            if clip is not None:
                # original WGAN critic weight clipping (Lipschitz constraint)
                with torch.no_grad():
                    for p in d.parameters():
                        p.clamp_(-clip, clip)

    def g_update(state):
        with span("step.g_update"):
            sync_grads(g)
            set_lr(state.opt_g, sched_g)
            state.opt_g.step()
            if state.g_ema is not None:
                with span("step.ema"):
                    ema_update(state.g_ema, g, ema_decay)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        with span("step"), convs.using_impl("xla"), batch_ctx(mesh):
            return _step(state, batch)

    def _real_rows(state, batch, k_data, k_flip, bsz, dev):
        """The draws for the real batch, on the device: the resident
        batch's indices and the hflip bits (None where there are none)."""
        idx = flip = None
        if "dataset_images" in batch:
            n_set = batch["dataset_images"].shape[0]
            if cfg.data.sampling == "epoch":
                idx = h2d(epoch_indices(root, state.step, bsz_cfg, n_set)
                          .astype(np.int64), dev)
            else:  # uniform with replacement
                idx = cuda_threefry.randint(k_data, 0, n_set, (bsz_cfg,),
                                            dev)
            idx = local(idx)
        if hflip:
            flip = local(cuda_threefry.bernoulli(k_flip, 0.5, (bsz, 1, 1, 1),
                                                 dev))
        return idx, flip

    def _real_batch(batch, idx, flip):
        if idx is not None:
            x_real = batch["dataset_images"].index_select(0, idx)
            lab = batch.get("dataset_labels")
            y_real = None if lab is None else lab.index_select(0, idx)
        else:
            x_real, y_real = batch["image"], batch.get("label")
        dev = x_real.device
        if conditional:
            if y_real is None:
                raise ValueError("a conditional model's batch needs 'label'")
            y_real = y_real.to(dev).long()
        if x_real.dtype == torch.uint8:
            x_real = x_real.float() / 127.5 - 1.0
        if flip is not None:
            x_real = torch.where(flip, x_real.flip(2), x_real)
        return x_real, (y_real if conditional else None)

    def _step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        # the trainer's sample grids put G in eval mode between steps
        g.train()
        d.train()
        resident = "dataset_images" in batch
        dev = batch["dataset_images" if resident else "image"].device

        def latents(name, key):
            z = batch.get(name)
            return local(cuda_threefry.normal(key, (bsz, nz), dev)
                         if z is None else h2d(z, dev).float())

        def fake_labels(name, key):
            if not conditional:
                return None
            y = batch.get(name)
            return local(cuda_threefry.randint(key, 0, n_classes, (bsz,), dev)
                         if y is None else h2d(y, dev).long())

        with span("step.draws"):
            if policy:
                (rng, k_zd, k_zg, k_gp, k_yd, k_yg, k_flip, k_data, k_aug_d,
                 k_aug_g) = threefry.split(state.rng, 10)
            else:
                (rng, k_zd, k_zg, k_gp, k_yd, k_yg, k_flip,
                 k_data) = threefry.split(state.rng, 8)
                k_aug_d = k_aug_g = None
            # the global batch's size
            bsz = bsz_cfg if resident else batch["image"].shape[-4] * n_data
            idx, flip = _real_rows(state, batch, k_data, k_flip, bsz, dev)
            z_d = latents("z_d", k_zd)
            y_fake_d = fake_labels("y_fake_d", k_yd)
        with span("step.real_batch"):
            x_real, y_real = _real_batch(batch, idx, flip)
        if cfg.train.fused_prop:
            with span("step.grads"):
                metrics = fused(state, x_real, y_real, z_d, y_fake_d, k_aug_d)
            d_update(state)
            g_update(state)
        else:
            metrics = alternating(state, batch, x_real, y_real, z_d,
                                  y_fake_d, k_gp, k_aug_d, k_aug_g,
                                  lambda: (latents("z_g", k_zg),
                                           fake_labels("y_fake_g", k_yg)))
        state.rng = rng
        state.step += 1
        return state, metrics

    def fused(state, x_real, y_real, z, y_fake, k_aug):
        d_params = list(d.parameters())
        g_params = list(g.parameters())
        ada_p = state.ada_p  # the step's incoming p
        if policy:
            # the one fake forward's augmentation draw is shared by the D
            # and G pulls, inside the shared graph
            ka_r, ka_f = threefry.split(k_aug, 2)
            x_real = aug(x_real, ka_r, ada_p)
        fake = gen(z, y_fake)
        real_logits = disc(x_real, y_real)
        loss_r = d_loss_real_fn(kind, real_logits,
                                real_label=cfg.loss.real_label)
        grads_real = torch.autograd.grad(share(loss_r), d_params)
        fake_in = fake.detach().requires_grad_()
        fake_logits = disc(aug(fake_in, ka_f, ada_p) if policy else fake_in,
                           y_fake)
        # the two cotangents of the one linearization of D on the fake
        leaf = fake_logits.detach().requires_grad_()
        loss_f = d_loss_fake_fn(kind, leaf, fake_label=cfg.loss.fake_label)
        c_d, = torch.autograd.grad(share(loss_f), leaf)
        loss_g = g_loss_fn(kind, leaf)
        c_g, = torch.autograd.grad(share(loss_g), leaf)
        grads_fake = torch.autograd.grad(fake_logits, d_params,
                                         grad_outputs=c_d, retain_graph=True)
        fake_cot, = torch.autograd.grad(fake_logits, fake_in,
                                        grad_outputs=c_g)
        _set_grads(g_params, torch.autograd.grad(fake, g_params,
                                                 grad_outputs=fake_cot))
        _set_grads(d_params, [a + b for a, b in zip(grads_real, grads_fake)])
        metrics = {
            "loss_d": (loss_r + loss_f).detach(),
            "d_real": real_logits.detach().float().mean(),
            "d_fake": fake_logits.detach().float().mean(),
            "gp": torch.zeros((), device=x_real.device),
            "loss_g": loss_g.detach(),
        }
        if ada_on:
            metrics["rt_batch"] = rt_batch(real_logits)
        return ada_update(state, global_metrics(metrics),
                          x_real.shape[0] * n_data)

    def chunks(t):
        return [None] * accum if t is None else list(t.chunk(accum))

    def mean(values):
        return values[0] if accum == 1 else torch.stack(values).mean()

    def alternating(state, batch, x_real, y_real, z_d, y_fake_d, k_gp,
                    k_aug_d, k_aug_g, g_inputs):
        ada_p = state.ada_p  # both updates augment at the step's incoming p
        with span("step.d_grads"):
            metrics = d_grads(state, batch, x_real, y_real, z_d, y_fake_d,
                              k_gp, k_aug_d, ada_p)
        d_update(state)
        # --- G update (every n_critic-th call) ---
        if n_critic == 1 or state.step % n_critic == n_critic - 1:
            with span("step.draws"):
                z_g, y_fake_g = g_inputs()
            with span("step.g_grads"):
                loss_g = g_grads(state, z_g, y_fake_g, k_aug_g, ada_p)
            g_update(state)
            metrics["loss_g"] = global_metrics({"loss_g": loss_g})["loss_g"]
        else:
            metrics["loss_g"] = torch.zeros((), device=x_real.device)
        return metrics

    def d_grads(state, batch, x_real, y_real, z_d, y_fake_d, k_gp, k_aug_d,
                ada_p):
        """D's gradients, one microbatch after another, summed; returns
        the metrics of the D update."""
        dev = x_real.device
        gp_alpha = batch.get("gp_alpha")
        if gp_alpha is not None:
            gp_alpha = torch.as_tensor(gp_alpha).reshape(-1)
        k_gps = threefry.split(k_gp, accum) if accum > 1 else [k_gp]
        state.opt_d.zero_grad(set_to_none=True)
        ms = []
        for xr, yr, z, yf, kg, ga, ka in zip(
                chunks(x_real), chunks(y_real), chunks(z_d),
                chunks(y_fake_d), k_gps, chunks(gp_alpha),
                aug_keys(k_aug_d)):
            with torch.no_grad():
                fake = gen(z, yf)
            if policy:
                # fresh draws for the reals and the fakes; the penalty's
                # interpolates are taken between the augmented pair
                ka_r, ka_f = threefry.split(ka, 2)
                xr, fake = aug(xr, ka_r, ada_p), aug(fake, ka_f, ada_p)
            real_logits = disc(xr, yr)
            fake_logits = disc(fake, yf)
            loss_d = d_loss_fn(kind, real_logits, fake_logits, **labels)
            gp = torch.zeros((), device=dev)
            if kind == "wgan_gp":
                d.eval()  # the frozen state: no statistic or u moves
                try:
                    gp = gradient_penalty(lambda x: d(x, yr) if conditional
                                          else d(x), xr, fake, kg, alpha=ga,
                                          rows=micro_rows(xr))
                finally:
                    d.train()
                loss_d = loss_d + cfg.loss.lambda_gp * gp
            share(loss_d).backward()
            ms.append({
                "loss_d": loss_d.detach(),
                "d_real": real_logits.detach().float().mean(),
                "d_fake": fake_logits.detach().float().mean(),
                "gp": gp.detach(),
            })
            if ada_on:
                ms[-1]["rt_batch"] = rt_batch(real_logits)
        if accum > 1:
            for p in d.parameters():
                p.grad.div_(accum)
        return ada_update(state, global_metrics(
            {k: mean([m[k] for m in ms]) for k in ms[0]}),
            x_real.shape[0] * n_data)

    def g_grads(state, z_g, y_fake_g, k_aug_g, ada_p):
        """G's gradients through the frozen D, one microbatch after
        another, summed; returns G's loss, the microbatches' mean."""
        state.opt_g.zero_grad(set_to_none=True)
        d.requires_grad_(False)
        losses = []
        try:
            for z, yf, ka in zip(chunks(z_g), chunks(y_fake_g),
                                 aug_keys(k_aug_g)):
                fake = gen(z, yf)
                if policy:  # differentiable: G's gradient flows through
                    fake = aug(fake, ka, ada_p)
                loss_g = g_loss_fn(kind, disc(fake, yf))
                share(loss_g).backward()
                losses.append(loss_g.detach())
        finally:
            d.requires_grad_(True)
        if accum > 1:
            for p in g.parameters():
                p.grad.div_(accum)
        return mean(losses)

    k = cfg.train.steps_per_call
    if k <= 1:
        return step

    def multi_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        resident = "dataset_images" in batch
        for i in range(k):
            state, metrics = step(state, batch if resident else {
                key: v[i] for key, v in batch.items()})
        return state, metrics

    return multi_step
