"""Shared set-up for the port's tests: one generator built in both packages
from the same preset, with the JAX weights (and BN statistics from a
train-mode apply) carried into the port by name."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpugan.configs import get_preset
from tpugan.models import build_models
from tpugan_torch.ckpt.from_jax import load_jax_module
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.models.registry import build_generator


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def twin_generators(preset, overrides, precision="fp32", seed=0,
                    train_batch=8, rng=None):
    """(cfg, jax g, params, state, port cfg, port g): BN running stats come
    from one train-mode apply on a seeded batch."""
    cfg = get_preset(preset).override(overrides)
    g, _ = build_models(cfg.model, precision)
    params, state = g.init(jax.random.PRNGKey(seed))
    rng = rng or np.random.default_rng(seed)
    z = jnp.asarray(rng.standard_normal((train_batch, cfg.model.nz)),
                    jnp.float32)
    if cfg.model.arch == "cdcgan":
        y = jnp.asarray(np.arange(train_batch) % cfg.model.n_classes,
                        jnp.int32)
        _, state = g.apply(params, state, (z, y), train=True)
    else:
        _, state = g.apply(params, state, z, train=True)
    pcfg = port_preset(preset).override(overrides)
    tg = build_generator(pcfg.model, precision, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    load_jax_module(tg, to_numpy(params), to_numpy(state))
    return cfg, g, params, state, pcfg, tg.eval()


def twin_train_states(preset, overrides):
    """(cfg, jax g, jax d, jax TrainState, port cfg, port TrainState): the
    JAX state from ``create_train_state``, carried into the port's (both
    modules, the optimizers' moments, the key and the step).  The JAX state
    is copied to the host first, so a donating JAX step can consume it."""
    from tpugan.train.state import create_train_state
    from tpugan_torch.ckpt.from_jax import load_jax_train_state
    from tpugan_torch.models.registry import build_models as port_models
    from tpugan_torch.train.state import \
        create_train_state as port_train_state

    cfg = get_preset(preset).override(overrides)
    g, d = build_models(cfg.model, cfg.train.precision)
    state = create_train_state(cfg, g, d)
    pcfg = port_preset(preset).override(overrides)
    tg, td = port_models(pcfg.model, pcfg.train.precision,
                         fuse_stats=pcfg.train.fuse_stats, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    pstate = port_train_state(pcfg, tg, td)
    load_jax_train_state(pstate, jax.device_get(state))
    return cfg, g, d, state, pcfg, pstate


def module_arrays(module):
    """{dotted name: float32 numpy} of a port module's params and buffers."""
    return {k: v.detach().float().numpy()
            for k, v in module.state_dict().items()}
