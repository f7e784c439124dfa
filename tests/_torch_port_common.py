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


def twin_train_states(preset, overrides, **fields):
    """(cfg, jax g, jax d, jax TrainState, port cfg, port TrainState): the
    JAX state from ``create_train_state`` (its ``fields`` replaced, e.g.
    ``ada_p``), carried into the port's (both modules, the optimizers'
    moments, ADA's state, the key and the step).  The JAX state is copied
    to the host first, so a donating JAX step can consume it."""
    from tpugan.train.state import create_train_state
    from tpugan_torch.ckpt.from_jax import load_jax_train_state
    from tpugan_torch.models.registry import build_models as port_models
    from tpugan_torch.train.state import \
        create_train_state as port_train_state

    cfg = get_preset(preset).override(overrides)
    g, d = build_models(cfg.model, cfg.train.precision)
    state = create_train_state(cfg, g, d)
    if fields:
        state = state.replace(**{k: jnp.asarray(v) for k, v in
                                 fields.items()})
    pcfg = port_preset(preset).override(overrides)
    tg, td = port_models(pcfg.model, pcfg.train.precision,
                         fuse_stats=pcfg.train.fuse_stats, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    pstate = port_train_state(pcfg, tg, td)
    load_jax_train_state(pstate, jax.device_get(state))
    return cfg, g, d, state, pcfg, pstate


def _fill(shapes, arrays, prefix=""):
    """A nested dict of ``jax.ShapeDtypeStruct`` leaves -> the same tree of
    arrays, each taken from ``arrays`` by its dotted key."""
    out = {}
    for k, v in shapes.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = _fill(v, arrays, key + ".")
        else:
            a = arrays[key]
            assert a.shape == v.shape, (key, a.shape, v.shape)
            out[k] = jnp.asarray(a, v.dtype)
    return out


def jax_module_from_port(jmodule, module):
    """(params, state) of the JAX module ``jmodule`` holding the port
    ``module``'s values (its structure from ``jax.eval_shape`` of
    ``init``: nothing is initialized twice)."""
    params, state = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0))
    arrays = module_arrays(module)
    return _fill(params, arrays), _fill(state, arrays)


def jax_state_from_port(cfg, g, d, pstate):
    """The JAX ``TrainState`` of a fresh port ``TrainState`` (step 0): the
    reverse of ``load_jax_train_state`` for a state no optimizer has
    stepped, so that both packages start from the port's seeded
    initialization."""
    from tpugan.train.state import TrainState, make_optimizers

    assert pstate.step == 0
    params_g, state_g = jax_module_from_port(g, pstate.g)
    params_d, state_d = jax_module_from_port(d, pstate.d)
    tx_g, tx_d = make_optimizers(cfg)
    zero = (jnp.zeros((), jnp.float32) if cfg.train.ada_target != 0
            else None)
    return TrainState(
        params_g=params_g, state_g=state_g, opt_g=tx_g.init(params_g),
        params_d=params_d, state_d=state_d, opt_d=tx_d.init(params_d),
        rng=jnp.asarray(pstate.rng, jnp.uint32),
        step=jnp.zeros((), jnp.int32),
        params_g_ema=(jax_module_from_port(g, pstate.g_ema)[0]
                      if pstate.g_ema is not None else None),
        ada_p=zero, ada_rt=zero)


def module_arrays(module):
    """{dotted name: float32 numpy} of a port module's params and buffers."""
    return {k: v.detach().float().numpy()
            for k, v in module.state_dict().items()}


def run_twin_steps(preset, overrides, calls=3, resident=False, seed=5,
                   **fields):
    """``calls`` calls of the JAX train step and the port's from one carried
    state (``twin_train_states``, ``fields`` replaced in the JAX state), on
    the same synthetic uint8 batches: a
    fresh slice a call (K = ``train.steps_per_call`` stacked slices when
    K > 1), or the whole dataset held resident.  Returns (JAX state on the
    host, port state, JAX metrics, port metrics), the metrics as floats a
    call."""
    from tpugan import ops as jax_ops
    from tpugan.data.datasets import make_synthetic
    from tpugan.train.steps import build_train_step
    from tpugan_torch.train.steps import build_train_step as port_step

    cfg, g, d, jstate, pcfg, pstate = twin_train_states(preset, overrides,
                                                        **fields)
    k, bsz = max(cfg.train.steps_per_call, 1), cfg.data.batch_size
    cond = cfg.model.arch == "cdcgan"
    n = cfg.data.synthetic_size if resident else calls * k * bsz
    data = make_synthetic(cfg.model.image_size, cfg.model.channels, n,
                          seed=seed, n_classes=max(cfg.model.n_classes, 0))
    jax_ops.set_fuse_stats(cfg.train.fuse_stats)
    try:
        jstep = build_train_step(cfg, g, d)
        pstep = port_step(pcfg, pstate.g, pstate.d)
        jms, pms = [], []
        for i in range(calls):
            if resident:
                batch = {"dataset_images": data["images"]}
                if cond:
                    batch["dataset_labels"] = data["labels"]
            else:
                part = slice(i * k * bsz, (i + 1) * k * bsz)
                lead = (k, bsz) if k > 1 else (bsz,)
                batch = {"image": data["images"][part].reshape(
                    lead + data["images"].shape[1:])}
                if cond:
                    batch["label"] = data["labels"][part].reshape(lead)
            jstate, jm = jstep(jstate, {key: jnp.asarray(v)
                                        for key, v in batch.items()})
            pstate, pm = pstep(pstate, {key: torch.from_numpy(v)
                                        for key, v in batch.items()})
            jms.append({key: float(v) for key, v in jm.items()})
            pms.append({key: v.item() for key, v in pm.items()})
    finally:
        jax_ops.set_fuse_stats("off")
    return jax.device_get(jstate), pstate, jms, pms


def assert_metrics_close(jms, pms, rtol=1e-4, atol=1e-4):
    """Each call's logged metrics, JAX's against the port's."""
    for i, (jm, pm) in enumerate(zip(jms, pms)):
        assert sorted(jm) == sorted(pm)
        for key, v in jm.items():
            np.testing.assert_allclose(pm[key], v, rtol=rtol, atol=atol,
                                       err_msg=f"call {i} {key}")


def assert_state_close(jstate, pstate, atol, buf_tol=1e-4):
    """Parameters within ``atol``, BatchNorm statistics and spectral norm's
    u within ``buf_tol`` (relative and absolute), the EMA of G within
    ``atol``; the step, the key and ADA's p exact, ADA's r_t within an
    ulp."""
    from tpugan_torch.ckpt.from_jax import flatten

    mods = [(pstate.g, jstate.params_g, jstate.state_g),
            (pstate.d, jstate.params_d, jstate.state_d)]
    if jstate.params_g_ema is not None:
        mods.append((pstate.g_ema, jstate.params_g_ema, {}))
    for mod, params, st in mods:
        arrays = module_arrays(mod)
        for k, v in flatten(to_numpy(params)).items():
            np.testing.assert_allclose(arrays[k], v, rtol=0, atol=atol,
                                       err_msg=k)
        for k, v in flatten(to_numpy(st)).items():
            np.testing.assert_allclose(arrays[k], v, rtol=buf_tol,
                                       atol=buf_tol, err_msg=k)
    assert pstate.step == int(jstate.step)
    np.testing.assert_array_equal(pstate.rng, np.asarray(jstate.rng))
    if jstate.ada_p is not None:
        # p exactly; r_t's blend within an ulp (XLA may contract it into a
        # fused multiply-add)
        assert pstate.ada_p.item() == float(jstate.ada_p)
        np.testing.assert_allclose(pstate.ada_rt.item(),
                                   float(jstate.ada_rt), rtol=2.4e-7,
                                   atol=1e-9)


def assert_moments_close(jstate, pstate, rel=1e-5):
    """Both optimizers' moments of the port state within ``rel`` of each
    tensor's largest of the JAX state's, their counts exact (the JAX
    state carried into a copy of the port state, to compare by name)."""
    import copy

    from tpugan_torch.ckpt.from_jax import load_jax_train_state

    want = load_jax_train_state(copy.deepcopy(pstate), jstate).state_dict()
    got = pstate.state_dict()
    for part in ("opt_g", "opt_d"):
        assert sorted(got[part]["state"]) == sorted(want[part]["state"])
        for p, st in want[part]["state"].items():
            assert sorted(st) == sorted(got[part]["state"][p])
            for name, v in st.items():
                v = v.numpy()
                np.testing.assert_allclose(
                    got[part]["state"][p][name].numpy(), v, rtol=0,
                    atol=rel * np.abs(v).max(), err_msg=f"{part} {p} {name}")


def port_states_equal(a, b):
    """Two port TrainStates hold the same bits: modules, EMA, both
    optimizers' moments and counts, key and step."""
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"] and sa["rng"] == sb["rng"]
    for key in ("ada_p", "ada_rt"):
        assert (sa[key] is None) == (sb[key] is None), key
        if sa[key] is not None:
            assert torch.equal(sa[key], sb[key]), key
    for key in ("g", "d", "g_ema"):
        if sa[key] is None or sb[key] is None:
            assert sa[key] is None and sb[key] is None, key
            continue
        assert sorted(sa[key]) == sorted(sb[key])
        for name, t in sa[key].items():
            assert torch.equal(t, sb[key][name]), f"{key}.{name}"
    for key in ("opt_g", "opt_d"):
        oa, ob = sa[key], sb[key]
        assert oa["param_groups"] == ob["param_groups"], key
        assert sorted(oa["state"]) == sorted(ob["state"])
        for p, st in oa["state"].items():
            for name, t in st.items():
                assert torch.equal(t, ob["state"][p][name]), (key, p, name)


def spawn_cases(cases, world):
    """Start ``_torch_port_workers.run_cases(cases)`` on ``world`` gloo
    ranks in a background thread (the JAX references are computed
    meanwhile); ``.result()`` is each rank's list of results."""
    from concurrent.futures import ThreadPoolExecutor

    from _torch_port_workers import run_cases
    from tpugan_torch.parallel import multihost

    pool = ThreadPoolExecutor(1)
    try:
        return pool.submit(multihost.spawn, run_cases, world, (cases,),
                           device="cpu", timeout=1200)
    finally:
        pool.shutdown(wait=False)
