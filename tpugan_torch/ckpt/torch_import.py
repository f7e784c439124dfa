"""Import a reference-style torch ``.pth`` into the port (port of
``tpugan/ckpt/torch_import.py``).

A gan-playground user's asset after training is a ``.pth``: a dict of G and
D ``state_dict``s (and optimizer states and a step).  This module maps it
onto a port ``TrainState`` through the reference layout of
``ckpt/reference_nets.py``: weights, BatchNorm running statistics and
spectral norm's ``u`` land in the port's modules, transposed to its
layouts, ready for the Sampler, the exporter and ``train.resume``.

Optimizer state from a foreign ``.pth`` is not imported: torch Adam /
RMSprop moments are keyed by parameter order, which the reference's
scripts do not fix, and a silent misalignment is worse than a cold
optimizer.  The exception is the packages' own export (``export-torch``
of either package), which writes ``opt_G`` / ``opt_D`` in the reference
nets' ``parameters()`` order with a ``tpugan_export`` marker naming the
update rule and the format version: ``import_optimizer_state`` restores
those moments (transposed like their weights) and the update count, so a
fine-tune resumes warm.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from tpugan_torch.ckpt.reference_nets import (from_reference, key_map,
                                              reference_nets)
from tpugan_torch.ckpt.torch_export import MOMENTS
from tpugan_torch.configs import Config
from tpugan_torch.models.registry import build_models
from tpugan_torch.train.state import TrainState, create_train_state

# Keys every torch module carries that have no port counterpart.
_IGNORED_SUFFIXES = ("num_batches_tracked",)


def _strip_module_prefix(sd: Dict) -> Dict:
    """Drop DataParallel's 'module.' wrapper if present."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def _port_tensors(net, ref_sd: Dict, what: str) -> Dict[str, torch.Tensor]:
    """{port key: tensor in the port's layout} from a reference
    ``state_dict`` of ``net``'s architecture.  A missing key raises
    ``KeyError``; a key with no port destination or a tensor of another
    shape raises ``ValueError`` (a wrong preset or width)."""
    sd = _strip_module_prefix(ref_sd)
    own = net.state_dict()
    kmap = key_map(net)
    out, bad = {}, []
    for ref_key, (port_key, kind) in kmap.items():
        if ref_key not in sd:
            raise KeyError(
                f"torch state_dict is missing {ref_key!r}: wrong architecture "
                f"or wrong preset? (have e.g. {sorted(sd)[:6]} ...)")
        t = torch.as_tensor(sd[ref_key])
        if tuple(t.shape) != tuple(own[ref_key].shape):
            bad.append(f"{ref_key}: torch {tuple(t.shape)} vs "
                       f"{tuple(own[ref_key].shape)}")
            continue
        out[port_key] = from_reference(t.float(), kind)
    if bad:
        raise ValueError(
            f"{what}: architecture mismatch: {len(bad)} tensors disagree in "
            f"shape (wrong preset or nz/ngf/ndf overrides?): "
            + "; ".join(bad[:6]))
    left = [k for k in sd if k not in kmap
            and not k.endswith(_IGNORED_SUFFIXES)]
    if left:
        raise ValueError(
            f"{what}: {len(left)} torch keys had no port destination "
            f"(wrong preset / architecture?): {left[:8]}")
    return out


# Key aliases under which reference-style .pth checkpoints store the two
# state_dicts.
_G_KEYS = ("G", "g", "generator", "netG", "g_state", "model_g",
           "generator_state_dict")
_D_KEYS = ("D", "d", "discriminator", "netD", "d_state", "model_d",
           "discriminator_state_dict")
_STEP_KEYS = ("step", "iter", "iteration", "global_step")


def split_reference_checkpoint(obj) -> Tuple[Optional[Dict], Optional[Dict],
                                             int]:
    """A loaded .pth is either a bare state_dict (G or D alone) or a dict
    holding both under conventional keys; return (g_sd, d_sd, step)."""
    if not isinstance(obj, dict):
        raise ValueError(f"expected a dict checkpoint, got {type(obj)}")
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    g_sd = next((obj[k] for k in _G_KEYS if isinstance(obj.get(k), dict)),
                None)
    d_sd = next((obj[k] for k in _D_KEYS if isinstance(obj.get(k), dict)),
                None)
    step = 0
    for k in _STEP_KEYS:
        if isinstance(obj.get(k), (int, float)):
            step = int(obj[k])
            break
    # an 'epoch' field alone is not converted: epochs do not map to steps
    # without the original loader's size; importers pass --step
    if g_sd is None and d_sd is None:
        # a bare state_dict: tell G from D by their distinctive keys (D
        # first: 'embed' is in both conditional nets, 'proj' / 'features'
        # / 'd.' only in D)
        keys = {k.split(".")[0] for k in obj}
        if keys & {"features", "tail", "proj", "d"}:
            d_sd = obj
        elif keys & {"head", "head_bn", "blocks", "final", "g"}:
            g_sd = obj
        else:
            raise ValueError(
                "could not locate G/D state_dicts in the checkpoint "
                f"(top-level keys: {sorted(obj)[:10]})")
    return g_sd, d_sd, step


# Keys under which export-torch stores the optimizer state_dicts: exactly
# the exporter's own, no foreign aliases ('optimizerG' etc.), since moments
# are trusted only under the tpugan_export marker.
_OPT_G_KEYS = ("opt_G",)
_OPT_D_KEYS = ("opt_D",)


def extract_export_meta(obj) -> Tuple[Optional[Dict], Optional[Dict],
                                      Optional[Dict]]:
    """(tpugan_export marker, opt_G sd, opt_D sd) from a loaded .pth, each
    None-able; callers gate optimizer import on the marker."""
    if not isinstance(obj, dict):
        return None, None, None
    meta = obj.get("tpugan_export")
    if not isinstance(meta, dict):
        meta = None
    opt_g = next((obj[k] for k in _OPT_G_KEYS
                  if isinstance(obj.get(k), dict)), None)
    opt_d = next((obj[k] for k in _OPT_D_KEYS
                  if isinstance(obj.get(k), dict)), None)
    return meta, opt_g, opt_d


def import_torch_state(cfg: Config, g_sd: Optional[Dict] = None,
                       d_sd: Optional[Dict] = None, step: int = 0,
                       device="cuda") -> TrainState:
    """A port ``TrainState`` for ``cfg`` on ``device`` (the Trainer's seeded
    init) with G / D weights and buffers imported from reference
    ``state_dict``s.  A net not given keeps its init; the EMA of G, when
    the config keeps one, starts at the imported G; the optimizers are
    fresh (see the module docstring)."""
    g, d = build_models(cfg.model, cfg.train.precision,
                        fuse_stats=cfg.train.fuse_stats, device=device,
                        generator=torch.Generator().manual_seed(
                            cfg.train.seed))
    state = create_train_state(cfg, g, d)
    ref_g, ref_d = reference_nets(cfg)
    if g_sd is not None:
        g.load_state_dict(_port_tensors(ref_g, g_sd, "import G"))
        if state.g_ema is not None:
            with torch.no_grad():
                for e, p in zip(state.g_ema.parameters(), g.parameters()):
                    e.copy_(p)
    if d_sd is not None:
        d.load_state_dict(_port_tensors(ref_d, d_sd, "import D"))
    if step:
        state.step = int(step)
    return state


def _opt_count(opt_sd: Dict) -> int:
    for entry in opt_sd.get("state", {}).values():
        if "step" in entry:
            return int(entry["step"])
    return 0


def _restore_moments(cfg: Config, net, module, opt, opt_sd: Dict) -> None:
    """One net's moments (reference parameter order, reference layouts)
    into ``opt``'s state for ``module``'s parameters."""
    kmap = key_map(net)
    names = [n for n, _ in net.named_parameters()]
    st = opt_sd.get("state", {})
    if len(st) != len(names):
        raise ValueError(
            f"optimizer state has {len(st)} param entries but the "
            f"architecture has {len(names)} parameters: wrong preset or "
            "a foreign checkpoint (only exported .pth files carry "
            "importable optimizer state)")
    fields = MOMENTS[cfg.optim.optimizer]
    count = torch.tensor(float(_opt_count(opt_sd)))
    params = dict(module.named_parameters())
    for i, name in enumerate(names):
        entry = st[i] if i in st else st[str(i)]
        port_key, kind = kmap[name]
        p = params[port_key]
        new = {"step": count.clone()}
        for f in fields:
            if f not in entry:
                raise ValueError(
                    f"optimizer state entry {i} has no {f!r} (have "
                    f"{sorted(entry)}): optimizer rule mismatch?")
            t = from_reference(torch.as_tensor(entry[f]).float(), kind)
            if t.shape != p.shape:
                raise ValueError(f"moment {f} of {name}: shape "
                                 f"{tuple(t.shape)} != {tuple(p.shape)}")
            new[f] = t.to(p.device)
        opt.state[p] = new


def import_optimizer_state(cfg: Config, state: TrainState,
                           opt_g_sd: Optional[Dict] = None,
                           opt_d_sd: Optional[Dict] = None) -> TrainState:
    """Restore the optimizers' moments and counts from exported torch
    optimizer state_dicts (the warm half of the round trip); returns
    ``state``, changed in place.

    Call this only for a checkpoint carrying the ``tpugan_export`` marker
    with a matching ``optimizer``: the index -> parameter map is the
    reference nets' ``parameters()`` order, which a foreign checkpoint
    does not promise.
    """
    only = ("g" if opt_g_sd is not None else "") + \
           ("d" if opt_d_sd is not None else "")
    ref_g, ref_d = reference_nets(cfg, only)
    if opt_g_sd is not None:
        _restore_moments(cfg, ref_g, state.g, state.opt_g, opt_g_sd)
    if opt_d_sd is not None:
        _restore_moments(cfg, ref_d, state.d, state.opt_d, opt_d_sd)
    return state
