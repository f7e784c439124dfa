"""The port's spatial (H / W) sharding against the JAX package's
(``tests/test_spatial.py``, case for case as far as each applies to
processes): the halo convs and their gradients, the ops seam, whole models
at 256 px against the same modules dense, the spatial and DP x spatial train steps, the Trainer's wiring
and exact resume, the spatial Sampler and ``evaluate``.

The JAX side runs here on the conftest's fake CPU devices; the port's in 4
gloo ranks on the CPU, spawned once for the module.  Tolerances: halo
convs 1e-4 relative / 1e-5 absolute (their gradients 1e-4), whole models
and samples 2e-3 / 2e-4 (the JAX package's own for the same claims); the
train steps' metrics 1e-5 relative, the first step's gradients within
2e-5 of each tensor's largest, and after two steps the whole state
(parameters within lr / 20 = 1e-5, BatchNorm statistics 1e-4, Adam's
moments within 1e-5 of each tensor's largest; observed: a fifth of each or
less); the resumed run equals the uninterrupted one bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_port_common import (assert_moments_close, assert_state_close,
                                jax_state_from_port, spawn_cases, to_numpy)
from tpugan.configs import get_preset
from tpugan.models import build_models
from tpugan.ops.convs import conv2d, conv_transpose2d
from tpugan.parallel.spatial import spatial_ctx
from tpugan_torch.ckpt.from_jax import flatten
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.models.registry import build_models as port_models

WORLD = 4
CONV_CASES = [(kind, dim, n) for kind in ("conv", "convt")
              for dim in (1, 2) for n in (2, 4)]


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("space",))


def _overrides(image_size):
    return {"model.image_size": image_size, "model.ngf": 8,
            "model.ndf": 8, "model.nz": 8, "data.batch_size": 4,
            "train.precision": "fp32", "data.dataset": "synthetic"}


def _models(image_size):
    cfg = get_preset("dcgan_cifar10").override(_overrides(image_size))
    g, d = build_models(cfg.model, cfg.train.precision)
    return cfg, g, d


def _port_state():
    """A port TrainState at 32 px: the seeded initialization every rank
    starts from."""
    from tpugan_torch.train.state import create_train_state as port_state

    pcfg = port_preset("dcgan_cifar10").override(_overrides(32))
    tg, td = port_models(pcfg.model, "fp32", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return port_state(pcfg, tg, td)


def _jax_reference(cfg, g, d, batches, mesh):
    """The JAX package's spatial step from the port's seeded state: (the
    state after the calls, the metrics per call, the first step's
    gradients of D's loss and of G's), the gradients ``jax.grad`` of the
    step's losses under the same spatial context: D's at the incoming
    state, G's against the once-updated D, on the step's own draws."""
    from tpugan.losses import d_loss_fn, g_loss_fn
    from tpugan.train import build_train_step

    state = jax.device_get(jax_state_from_port(cfg, g, d, _port_state()))
    step = build_train_step(cfg, g, d)
    states, ms = [], []
    for b in batches:  # (the step donates its state: keep host copies)
        with spatial_ctx(mesh):
            s, m = step(jax.tree.map(jnp.array, states[-1] if states
                                     else state), b)
        states.append(jax.device_get(s))
        ms.append({k: float(v) for k, v in m.items()})
    # the step's draws (no augment, no flip): z_d and z_g from its split
    _, k_zd, k_zg = jax.random.split(state.rng, 8)[:3]
    x = batches[0]["image"].astype(jnp.float32) / 127.5 - 1.0
    bsz, nz = x.shape[0], cfg.model.nz
    z_d = jax.random.normal(k_zd, (bsz, nz), jnp.float32)
    z_g = jax.random.normal(k_zg, (bsz, nz), jnp.float32)
    kind, once = cfg.loss.kind, states[0]

    def loss_d(pd):
        fake, _ = g.apply(state.params_g, state.state_g, z_d, train=True)
        real, sd = d.apply(pd, state.state_d, x, train=True)
        fake, _ = d.apply(pd, sd, jax.lax.stop_gradient(fake), train=True)
        return d_loss_fn(kind, real, fake, real_label=cfg.loss.real_label,
                         fake_label=cfg.loss.fake_label)

    def loss_g(pg):
        fake, _ = g.apply(pg, state.state_g, z_g, train=True)
        logits, _ = d.apply(once.params_d, once.state_d, fake, train=True)
        return g_loss_fn(kind, logits)

    both = jax.jit(lambda pd, pg: (jax.value_and_grad(loss_d)(pd),
                                   jax.value_and_grad(loss_g)(pg)))
    with spatial_ctx(mesh):
        (ld, gd), (lg, gg) = both(state.params_d, state.params_g)
    # the reference is the step's: its losses are the ones logged
    np.testing.assert_allclose([float(ld), float(lg)],
                               [ms[0]["loss_d"], ms[0]["loss_g"]],
                               rtol=1e-6)
    grads = {"g": flatten(to_numpy(gg)), "d": flatten(to_numpy(gd))}
    return states[-1], ms, grads


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases, ref, names = [], {}, []

    def add(name, fn, **kw):
        names.append(name)
        cases.append((fn, kw))

    # halo convs and their gradients
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    w_conv = (rng.standard_normal((4, 4, 8, 16)) * 0.1).astype(np.float32)
    xt = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    w_convt = (rng.standard_normal((4, 4, 8, 4)) * 0.1).astype(np.float32)
    ref["conv_inputs"] = (x, w_conv, xt, w_convt)
    for kind, dim, n in CONV_CASES:
        xi, wi = (x, w_conv) if kind == "conv" else (xt, w_convt)
        add(f"{kind}{dim}{n}", "halo_conv", kind=kind, dim=dim, n=n, x=xi,
            w=wi)
    # the seam's dispatch and fallback
    small = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    w8 = (rng.standard_normal((4, 4, 8, 8)) * 0.1).astype(np.float32)
    ref["ctx"] = (x, small, w8)
    add("ctx", "ctx_dispatch", x=x, small=small, w=w8)
    # whole models at 256 px, against the same modules dense
    for which in ("g", "d"):
        add(f"{which}256", "model_forward", which=which,
            preset="dcgan_cifar10", overrides=_overrides(256), n=WORLD)
    # the spatial and DP x spatial train steps at 32 px, from the port's
    # seeded initialization
    batches = [{"image": rng.integers(0, 256, size=(4, 32, 32, 3))
                .astype(np.uint8)} for _ in range(2)]
    for name, kind, shape in (("step_space", "space", (4,)),
                              ("step_dp_space", "dp_space", (2, 2))):
        add(name, "steps", preset="dcgan_cifar10", overrides=_overrides(32),
            init_sd=None, batches=batches, kind=kind, shape=shape,
            grads=True)
    # the Trainer: spatial alone, DP x spatial and its exact resume
    tr = {**_overrides(32), "data.synthetic_size": 16, "data.hflip": False,
          "train.log_every": 1, "train.sample_every": 2,
          "train.ckpt_every": 2}
    data = {"images": rng.integers(0, 256, size=(16, 32, 32, 3))
            .astype(np.uint8)}
    add("trainer_space", "trainer", preset="dcgan_256_spatial",
        overrides={**tr, "train.spatial_shards": 4}, data=data, steps=2,
        workdir=str(tmp_path_factory.mktemp("space")))
    dps = {**tr, "train.spatial_shards": 2, "train.mesh_shape": 2}
    add("straight", "trainer", preset="dcgan_256_spatial", overrides=dps,
        data=data, steps=3, workdir=str(tmp_path_factory.mktemp("straight")))
    add("resumed", "trainer", preset="dcgan_256_spatial", overrides=dps,
        data=data, steps=2, resume_steps=3,
        workdir=str(tmp_path_factory.mktemp("resumed")))
    # the standalone Sampler at 256 px, and evaluate at 64 px
    add("sample", "sample", preset="dcgan_cifar10",
        overrides={**_overrides(256), "train.spatial_shards": WORLD},
        n=4, seed=3, batch_size=2)
    add("evaluate", "sample", preset="dcgan_cifar10",
        overrides={**_overrides(64), "train.spatial_shards": WORLD,
                   "eval.fid_n": 8, "eval.fid_batch": 4}, n=4, seed=0,
        fid=rng.integers(0, 256, size=(8, 64, 64, 3)).astype(np.uint8))
    running = spawn_cases(cases, WORLD)
    # the JAX reference, while the ranks run
    cfg, g, d = _models(32)
    jb = [{"image": jnp.asarray(b["image"])} for b in batches]
    ref["space"] = _jax_reference(cfg, g, d, jb, _mesh(4))
    results = running.result()
    return ref, {n: [r[i] for r in results] for i, n in enumerate(names)}


@pytest.mark.parametrize("kind,dim,n", CONV_CASES)
def test_halo_conv_matches_dense(world, kind, dim, n):
    """The port's halo conv / ConvT on n shards (H or W) against the JAX
    package's dense op."""
    ref, got = world
    x, w_conv, xt, w_convt = ref["conv_inputs"]
    xi, wi = (x, w_conv) if kind == "conv" else (xt, w_convt)
    dense_op = conv2d if kind == "conv" else conv_transpose2d
    want = np.asarray(dense_op(jnp.asarray(xi), jnp.asarray(wi), stride=2,
                               padding=1, impl="xla"))
    out, _, _ = got[f"{kind}{dim}{n}"][0]
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind,dim", [("conv", 1), ("conv", 2),
                                      ("convt", 1), ("convt", 2)])
def test_halo_conv_grads_match_dense(world, kind, dim):
    """dx and dw of sum(tanh(out)) on 4 shards against JAX autodiff of the
    dense op (dw summed over 'space')."""
    ref, got = world
    x, w_conv, xt, w_convt = ref["conv_inputs"]
    xi, wi = (x, w_conv) if kind == "conv" else (xt, w_convt)
    op = conv2d if kind == "conv" else conv_transpose2d

    def dense(x, w):
        return jnp.sum(jnp.tanh(op(x, w, stride=2, padding=1, impl="xla")))

    gx, gw = jax.grad(dense, argnums=(0, 1))(jnp.asarray(xi),
                                             jnp.asarray(wi))
    _, dx, dw = got[f"{kind}{dim}4"][0]
    np.testing.assert_allclose(dx, np.asarray(gx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(gw), rtol=1e-4, atol=1e-4)


def test_ctx_dispatch_and_fallback(world):
    ref, got = world
    x, small, w = ref["ctx"]
    out, out_small, sharded = got["ctx"][0]
    assert sharded  # the qualifying conv returned this rank's shard
    np.testing.assert_allclose(out, np.asarray(conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=2, padding=1)),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out_small, np.asarray(conv2d(
        jnp.asarray(small), jnp.asarray(w), stride=2, padding=1)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["g", "d"])
def test_model_256_spatial_matches_dense(world, which):
    """The whole 256 px G (from z) or D (from an image), train mode, 4-way
    H-sharded, against the same module dense."""
    _, got = world
    sharded, dense = got[f"{which}256"][0]
    np.testing.assert_allclose(sharded, dense, rtol=2e-3, atol=2e-4)


def _check_step(ref_state, ref_ms, got):
    """Both calls' metrics, then the whole state after them: parameters
    within lr / 20 = 1e-5, BatchNorm statistics within 1e-4, step and key
    exact (``assert_state_close``), and both optimizers' moments within
    1e-5 of each tensor's largest (``assert_moments_close``)."""
    from _torch_port_workers import torch_tree

    sd, pms, _ = got
    for jm, pm in zip(ref_ms, pms):
        assert sorted(jm) == sorted(pm)
        for k, v in jm.items():
            np.testing.assert_allclose(pm[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    port = _port_state()
    port.load_state_dict(torch_tree(sd))
    assert_state_close(ref_state, port, atol=2e-4 / 20)
    assert_moments_close(ref_state, port, rel=1e-5)


def _check_grads(ref_grads, got):
    """The first step's gradients of G and D, as each optimizer received
    them, against ``jax.grad`` of the JAX spatial step's losses: within
    2e-5 of each tensor's largest (a gradient summed over the wrong ranks
    is off by a whole multiple of itself)."""
    grads = got[2]["grads"]
    for part in ("g", "d"):
        assert sorted(grads[part]) == sorted(ref_grads[part])
        for k, v in ref_grads[part].items():
            np.testing.assert_allclose(grads[part][k], v, rtol=0,
                                       atol=2e-5 * np.abs(v).max(),
                                       err_msg=f"{part}.{k}")


@pytest.mark.parametrize("case", ["step_space", "step_dp_space"])
def test_spatial_step_gradients_match_jax(world, case):
    """4 space ranks, and (2 data x 2 space): each parameter's gradient,
    sharded compute and replicated alike, counted once."""
    ref, got = world
    _check_grads(ref["space"][2], got[case][0])


def test_spatial_train_step_matches_jax(world):
    """Two alternating steps at 32 px, 4-way H-sharded, against the JAX
    package's 4-way spatial step (which its own test holds to its dense
    step)."""
    ref, got = world
    _check_step(*ref["space"][:2], got["step_space"][0])


def test_dp_x_spatial_train_step_matches_jax(world):
    """(2 data x 2 space): batch over 'data', H over 'space' (gradient
    all-reduces over data, halos over space) against the same JAX step."""
    ref, got = world
    _check_step(*ref["space"][:2], got["step_dp_space"][0])


def test_trainer_spatial_wiring(world):
    """train.spatial_shards alone: a ('space',) mesh of 4, finite losses,
    fuse_stats off, a grid from rank 0, and the spatial context cleared
    when train() returns."""
    _, got = world
    r = got["trainer_space"]
    assert r[0]["facts"]["mesh"] == ("space",)
    assert {x["facts"]["fuse"] for x in r} == {"off"}
    assert np.isfinite(r[0]["metrics"]["loss_d"])
    assert np.isfinite(r[0]["metrics"]["loss_g"])
    assert "samples_0000002.png" in r[0]["wrote"]
    assert all(x["wrote"] == [] for x in r[1:])
    assert not any(x["active_after"] for x in r)


def test_trainer_dp_x_spatial_resume_is_exact(world):
    """mesh_shape x spatial_shards builds the (data, space) mesh; a run
    resumed from its step-2 checkpoint ends bit for bit where the
    uninterrupted 3-step run did."""
    _, got = world
    straight, resumed = got["straight"][0], got["resumed"][0]
    assert straight["facts"]["mesh"] == ("data", "space")
    assert resumed["resumed_step"] == 3
    a, b = straight["state"], resumed["resumed_state"]
    assert a["step"] == b["step"] == 3 and a["rng"] == b["rng"]
    for part in ("g", "d", "opt_g", "opt_d"):
        flat_a, flat_b = flatten(_plain(a[part])), flatten(_plain(b[part]))
        assert sorted(flat_a) == sorted(flat_b)
        for k, v in flat_a.items():
            np.testing.assert_array_equal(v, flat_b[k], err_msg=k)


def _plain(tree):
    """Optimizer state dicts keyed by ints -> by strings (for flatten)."""
    if isinstance(tree, dict):
        return {str(k): _plain(v) for k, v in tree.items()
                if k != "param_groups"}
    return np.asarray(tree)


def test_sampler_spatial_matches_dense(world):
    """A standalone spatial Sampler (its own ('space',) mesh of 4 ranks,
    no Trainer) reproduces the same generator's dense pixels at 256 px;
    chunked generation stays deterministic."""
    _, got = world
    out = got["sample"][0]
    assert out["images"].shape == out["dense"].shape == (4, 256, 256, 3)
    np.testing.assert_allclose(out["images"], out["dense"], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_array_equal(out["chunked"], out["images"])


def test_evaluate_spatial_sharded(world):
    """evaluate() on a spatial config: every rank generates through the
    spatial Sampler, the first scores (a stand-in extractor: the workers'
    ``sample`` case)."""
    _, got = world
    assert np.isfinite(got["evaluate"][0]["scores"]["fid"])


def test_sampler_rejects_insufficient_ranks_for_spatial_shards():
    """One process, spatial_shards=16: refused, not silently sharded over
    fewer ranks."""
    from tpugan_torch.models.registry import build_generator
    from tpugan_torch.sample.sampler import Sampler

    pcfg = port_preset("dcgan_cifar10").override(
        {**_overrides(256), "train.spatial_shards": 16})
    g = build_generator(pcfg.model, "fp32", device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="spatial_shards"):
        Sampler(pcfg, g).sample(2, seed=0)


def test_trainer_refuses_too_few_ranks_for_spatial_shards(tmp_path):
    from tpugan_torch.train.trainer import Trainer

    pcfg = port_preset("dcgan_256_spatial").override(
        {**_overrides(64), "train.out_dir": str(tmp_path)})
    with pytest.raises(ValueError, match="spatial_shards=8"):
        Trainer(pcfg, device="cpu")



def test_context_takes_square_maps_only():
    """A shard is told by its shape, so under a spatial context of 4 ranks
    a whole map must be square: a non-square map raises, and so does a
    model input that reads as a shard (it would be misread as one)."""
    from tpugan_torch.parallel import spatial

    class _Mesh:  # a stand-in: a 4-rank space axis, no process group
        mesh_dim_names = ("space",)

        def size(self, dim=0):
            return 4

    pcfg = port_preset("dcgan_cifar10").override(_overrides(32))
    _, d = port_models(pcfg.model, "fp32", device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with spatial.spatial_ctx(_Mesh()):
        assert spatial.is_sharded(torch.zeros(1, 4, 16, 3))
        assert not spatial.is_sharded(torch.zeros(1, 16, 16, 3))
        with pytest.raises(ValueError, match="square maps"):
            spatial.is_sharded(torch.zeros(1, 8, 16, 3))
        with pytest.raises(ValueError, match="reads as a 4-way shard"):
            d(torch.zeros(1, 8, 32, 3))
    assert not spatial.spatial_active()
