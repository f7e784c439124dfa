"""The port's data parallelism and FSDP against the JAX package's
(``tests/test_parallel.py``, case for case as far as each applies to
processes).

The JAX side runs here on the conftest's fake CPU devices; the port's runs
in 4 gloo ranks on the CPU, spawned once for the module
(``_torch_port_workers.py``), from the same numpy-seeded batches and the
same initial state (the port's seeded one, carried into the JAX
package).  Tolerances: parameters within lr / 20 = 1e-5 of the JAX mesh
step's after 3 steps (a mesh reorders the float sums: the JAX package's
own mesh tests hold 1e-4 relative), BatchNorm statistics 1e-4, Adam's
moments within 1e-5 of each tensor's largest, metrics within 1e-4; FSDP
against the port's DP within 1e-6
(the same sums; only the weight gathers differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (assert_moments_close, assert_state_close,
                                jax_module_from_port,
                                jax_state_from_port, module_arrays,
                                spawn_cases)
from tpugan.configs import get_preset
from tpugan.models import build_models
from tpugan.parallel import batch_sharding, make_mesh, shard_train_state
from tpugan.train import build_train_step
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.models.registry import build_generator
from tpugan_torch.models.registry import build_models as port_models
from tpugan_torch.parallel import multihost
from tpugan_torch.train.state import create_train_state as port_state
from tpugan_torch.train.trainer import Trainer

WORLD = 4
TINY = {"data.dataset": "synthetic", "data.batch_size": 16,
        "model.ngf": 8, "model.ndf": 8, "model.nz": 8,
        "train.precision": "fp32"}
ACCUM = {**TINY, "train.grad_accum": 2, "model.g_batchnorm": False,
         "model.d_batchnorm": False}
GEN = {"model.ngf": 8, "model.nz": 8}
FAST = {"data.dataset": "synthetic", "data.batch_size": 16,
        "data.synthetic_size": 64, "model.ngf": 8, "model.ndf": 8,
        "model.nz": 8, "train.precision": "fp32", "train.total_steps": 2,
        "train.steps_per_call": 2, "train.log_every": 100,
        "train.sample_every": 0, "train.ckpt_every": 0}
FSDP_TRAINER = {**TINY, "data.synthetic_size": 64, "train.log_every": 100,
                "train.sample_every": 2, "train.ckpt_every": 0,
                "train.kernels": "pallas", "train.mesh_shape": 2,
                "train.fsdp_shards": 2}


def _batches(cfg, n=3, seed=0):
    rng = np.random.default_rng(seed)
    s, c = cfg.model.image_size, cfg.model.channels
    return [{"image": rng.integers(0, 256, size=(cfg.data.batch_size, s, s,
                                                 c)).astype(np.uint8)}
            for _ in range(n)]


def _numpy_sd(pstate):
    from _torch_port_workers import numpy_tree

    return numpy_tree(pstate.state_dict())


def _port_state(overrides, sd, preset="dcgan_cifar10"):
    """A port TrainState holding ``sd`` (None: the seeded initialization
    every rank starts from)."""
    from _torch_port_workers import torch_tree

    pcfg = port_preset(preset).override(overrides)
    g, d = port_models(pcfg.model, pcfg.train.precision, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    st = port_state(pcfg, g, d)
    if sd is not None:
        st.load_state_dict(torch_tree(sd))
    return st


def _jax_steps(cfg, g, d, state, batches, mesh):
    step = build_train_step(cfg, g, d)
    state = shard_train_state(state, mesh)
    sh = batch_sharding(mesh)
    ms = []
    for b in batches:
        state, m = step(state, jax.device_put(
            {k: jnp.asarray(v) for k, v in b.items()}, sh))
        ms.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state), ms


def _seeded_generator(overrides):
    """A port generator from its seeded initialization, its BatchNorm
    statistics from one train-mode forward of seeded noise."""
    pcfg = port_preset("dcgan_cifar10").override(overrides)
    tg = build_generator(pcfg.model, "fp32", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    z = np.random.default_rng(0).standard_normal((8, pcfg.model.nz))
    with torch.no_grad():
        tg.train()(torch.from_numpy(z.astype(np.float32)))
    return tg.eval()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every port case in one spawn of 4 ranks, from the port's seeded
    initialization; the JAX side (that state carried into the JAX
    package, its mesh step) is computed while they run."""
    cases, ref, names = [], {}, []

    def add(name, fn, **kw):
        names.append(name)
        cases.append((fn, kw))

    # DP over a 2-rank subset mesh, and FSDP 2 x 2, from one state
    batches = _batches(port_preset("dcgan_cifar10").override(TINY))
    for name, kind, shape, bs in (("dp", "dp", (2,), batches),
                                  ("fsdp", "fsdp", (2, 2), batches[:1]),
                                  ("dp1", "dp", (2,), batches[:1])):
        add(name, "steps", preset="dcgan_cifar10", overrides=TINY,
            init_sd=None, batches=bs, kind=kind, shape=shape)
    # grad_accum x DP against the single program's accumulated step
    for name, kind, shape in (("accum", "dp", (2,)),
                              ("accum_one", "single", None)):
        add(name, "steps", preset="dcgan_cifar10", overrides=ACCUM,
            init_sd=None, batches=batches[:1], kind=kind, shape=shape)
    # the flagship fast path (resident data, FusedProp, 2 steps a call):
    # the mesh run and the single program (no mesh: every rank runs it
    # whole)
    data = {"images": np.random.default_rng(0).integers(
        0, 256, size=(64, 64, 64, 3)).astype(np.uint8)}
    tmp = tmp_path_factory.mktemp("fast")
    for name, over in (("fast", {**FAST, "train.mesh_shape": WORLD}),
                       ("fast_one", FAST)):
        add(name, "trainer", preset="dcgan_celeba64_fast", overrides=over,
            data=data, steps=2, workdir=str(tmp / name))
    # the Trainer's own (data, model) mesh, its grids, and a resume
    add("fsdp_trainer", "trainer", preset="dcgan_cifar10",
        overrides=FSDP_TRAINER, data={"images": data["images"][:, :32, :32]},
        steps=2, resume_steps=3, workdir=str(tmp_path_factory.mktemp("fsdp")))
    # ShardedSampler over all 4 ranks, both kernel paths
    tg = _seeded_generator(GEN)
    for kernels in ("xla", "pallas"):
        add(f"serve_{kernels}", "sharded_sample", preset="dcgan_cifar10",
            overrides={**GEN, "train.precision": "fp32"},
            sd=module_arrays(tg), n=10, seed=3, kernels=kernels)
    add("mesh", "mesh_facts")
    running = spawn_cases(cases, WORLD)
    # the JAX side, while the ranks run: the mesh step from the same state
    cfg = get_preset("dcgan_cifar10").override(TINY)
    g, d = build_models(cfg.model, cfg.train.precision)
    jstate = jax_state_from_port(cfg, g, d,
                                 _port_state(TINY, None))
    ref["dp"] = _jax_steps(cfg, g, d, jstate, batches, make_mesh(2))
    ref["gen"] = tg
    results = running.result()
    return ref, {n: [r[i] for r in results] for i, n in enumerate(names)}


def test_four_ranks_present(world):
    _, got = world
    facts = got["mesh"]
    assert [f["world"] for f in facts] == [WORLD] * WORLD
    assert [f["rank"] for f in facts] == list(range(WORLD))


def test_sharded_step_matches_the_jax_mesh_step(world):
    """DP over 2 ranks, 3 steps, against the JAX step on make_mesh(2): the
    metrics, then the whole state (parameters, BatchNorm statistics, both
    optimizers' moments, step and key)."""
    ref, got = world
    jstate, jms = ref["dp"]
    sd, pms, _ = got["dp"][0]
    for jm, pm in zip(jms, pms):
        for k, v in jm.items():
            np.testing.assert_allclose(pm[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    port = _port_state(TINY, sd)
    assert_state_close(jstate, port, atol=2e-4 / 20)
    assert_moments_close(jstate, port, rel=1e-5)
    # both ranks of the mesh logged the same global metrics
    assert got["dp"][1] == pms


def test_batch_actually_sharded(world):
    _, got = world
    # each of 4 ranks holds 16 / 4 = 4 rows of the batch
    assert {f["shard"] for f in got["mesh"]} == {(4, 8, 8, 3)}
    np.testing.assert_array_equal(got["mesh"][2]["gathered"],
                                  np.arange(4.0))


def test_mesh_subset(world):
    _, got = world
    assert [f["subset"] for f in got["mesh"]] == [
        (2, True), (2, True), (2, False), (2, False)]
    # ranks outside the subset mesh take no part in its step
    assert got["dp"][2] is None and got["dp"][3] is None


def test_mesh_over_request_rejected(world):
    _, got = world
    assert all("only 4 rank(s)" in f["over_request"] for f in got["mesh"])


def test_fsdp_2d_mesh_matches_dp_and_the_jax_step(world):
    """(data=2, model=2): each rank holds half of block0's ConvT weight and
    of its Adam moments; one step equals the port's DP step (which
    ``test_sharded_step_matches_the_jax_mesh_step`` holds to the JAX
    package's)."""
    ref, got = world
    sd, pms, facts = got["fsdp"][0]
    cfg = port_preset("dcgan_cifar10").override(TINY)
    full = 2 * cfg.model.ngf  # block0: ngf*4 -> ngf*2 channels
    assert facts["block0.conv.w"][-1] == full // 2
    assert facts["exp_avg"] == facts["block0.conv.w"]
    dsd, dms, _ = got["dp1"][0]
    for part in ("g", "d"):
        for k, v in sd[part].items():
            np.testing.assert_allclose(v, dsd[part][k], rtol=0, atol=1e-6,
                                       err_msg=k)
    for k, v in sd["opt_g"]["state"].items():
        for name, t in v.items():
            np.testing.assert_allclose(
                t, dsd["opt_g"]["state"][k][name], rtol=0, atol=1e-6)
    for k, v in pms[0].items():
        np.testing.assert_allclose(v, dms[0][k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_trainer_fsdp_wiring(world):
    """train.fsdp_shards: the Trainer builds the (data, model) mesh itself,
    shards over 'model', turns fuse_stats off, writes grids and metrics from
    rank 0 only, and a resume restores the sharded placement."""
    _, got = world
    r = got["fsdp_trainer"]
    assert r[0]["facts"]["mesh"] == ("data", "model")
    assert {x["facts"]["fuse"] for x in r} == {"off"}
    assert r[0]["facts"]["shard"] == r[0]["facts"]["resumed_shard"]
    assert r[0]["facts"]["shard"][-1] == 8 * 2 // 2
    assert {x["resumed_step"] for x in r} == {3}
    assert all(np.isfinite(v) for v in r[0]["resumed"].values())
    assert "samples_0000002.png" in r[0]["wrote"]
    assert "metrics.jsonl" in r[0]["wrote"]
    assert all(x["wrote"] == [] for x in r[1:])


def test_trainer_fsdp_rejects_spatial_combo(tmp_path):
    from tpugan_torch.parallel.spatial import spatial_active

    cfg = port_preset("dcgan_cifar10").override(
        {**TINY, "train.fsdp_shards": 2, "train.spatial_shards": 2})
    with pytest.raises(ValueError, match="second mesh axis"):
        Trainer(cfg, device="cpu")
    assert not spatial_active()


def test_grad_accum_composes_with_dp(world):
    """grad_accum=2 on a DP mesh of 2: each rank runs its slice of each
    microbatch, and the update equals the single program's accumulated
    one (which ``test_torch_port_train_step.py`` holds to the JAX
    step)."""
    _, got = world
    sd, pms, _ = got["accum"][0]
    one, oms, _ = got["accum_one"][0]
    for k, v in oms[0].items():
        np.testing.assert_allclose(pms[0][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for part in ("g", "d"):
        for k, v in one[part].items():
            np.testing.assert_allclose(sd[part][k], v, rtol=0,
                                       atol=2e-4 / 20, err_msg=k)


def test_grad_accum_microbatch_must_split_over_data(tmp_path):
    """A microbatch that does not split over the data ranks is refused, as
    the JAX step refuses it (checked before any collective)."""
    from tpugan_torch.train.steps import build_train_step as port_step

    class _Mesh:  # a stand-in with a 4-rank data axis
        mesh_dim_names = ("data",)

        def size(self, dim=0):
            return 4

        def get_local_rank(self, name):
            return 0

        def get_group(self, name):
            return None

    pcfg = port_preset("dcgan_cifar10").override(
        {**ACCUM, "data.batch_size": 12})
    g, d = port_models(pcfg.model, "fp32", device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not divisible"):
        port_step(pcfg, g, d, mesh=_Mesh())


def test_device_resident_dp_matches_the_single_program(world):
    """The fast path (resident data, FusedProp, 2 steps a call) on a DP
    mesh of 4: after one call the Trainer's parameters equal the port's
    single program's from the same state (every rank ran it whole) within
    the band of the JAX package's own test of this claim (rtol 2e-3, atol
    5e-5), all but at most 0.2% of each tensor's elements; those are
    elements whose gradient cancels to rounding noise (FusedProp's D tail
    has one at 3e-8 against a median of 0.1), where Adam's first
    normalized update takes either sign, so every element is held within
    2 x lr per step, the most two Adam paths can part.  (The single
    program's losses against the JAX trainer's:
    ``test_torch_port_trainer.py::test_fast_preset_logs_the_jax_trainers_losses``.)"""
    ref, got = world
    r = got["fast"][0]
    assert r["facts"]["mesh"] == ("data",)
    one_sd = got["fast_one"][0]["state"]
    assert got["fast_one"][0]["facts"]["mesh"] is None
    bound = 2 * 2e-4 * FAST["train.total_steps"]
    for part in ("g", "d"):
        for k, v in r["state"][part].items():
            want = one_sd[part][k]
            close = np.isclose(v, want, rtol=2e-3, atol=5e-5)
            assert close.mean() >= 0.998, (k, close.mean())
            np.testing.assert_allclose(v, want, rtol=0, atol=bound,
                                       err_msg=k)
    assert all(np.isfinite(v) for v in r["metrics"].values())


def test_sharded_sampler_matches_the_sampler(world):
    """ShardedSampler over 4 ranks (10 images: padded to 12) against the
    JAX Sampler's pixels (xla) and the port's one-process module path
    (pallas: kernel 1's plain version on the CPU)."""
    from tpugan.sample import Sampler as JaxSampler
    from tpugan_torch.ops import convs

    ref, got = world
    tg = ref["gen"]
    gcfg = get_preset("dcgan_cifar10").override(GEN)
    jg, _ = build_models(gcfg.model, "fp32")
    params, state = jax_module_from_port(jg, tg)
    want = np.asarray(JaxSampler(gcfg, jg, params, state).sample(10, seed=3))
    xla = got["serve_xla"][0]
    assert xla["shards"] == WORLD and xla["images"].shape == want.shape
    np.testing.assert_allclose(xla["images"], want, rtol=1e-5, atol=1e-5)
    from tpugan_torch.sample.sampler import seeded_noise

    with convs.using_impl("pallas"), torch.no_grad():
        module = tg.eval()(torch.from_numpy(seeded_noise(8, 10, 3))).numpy()
    np.testing.assert_allclose(got["serve_pallas"][0]["images"], module,
                               rtol=1e-6, atol=1e-6)


def test_fuse_stats_unchanged_at_one_rank(tmp_path):
    """mesh_shape=1 with no process group is the single program: the
    configured fuse_stats stays."""
    cfg = port_preset("dcgan_cifar10").override(
        {**TINY, "train.mesh_shape": 1, "train.fuse_stats": "on",
         "train.out_dir": str(tmp_path), "train.ckpt_dir": str(tmp_path)})
    t = Trainer(cfg, device="cpu")
    assert t.mesh is None and t._fuse_mode == "on"


def test_local_rows_follow_the_microbatches():
    """Under grad_accum each rank holds its slice of every microbatch."""
    np.testing.assert_array_equal(multihost.local_rows(8, 2, 1),
                                  np.arange(4, 8))
    np.testing.assert_array_equal(multihost.local_rows(8, 2, 1, accum=2),
                                  [2, 3, 6, 7])
    with pytest.raises(ValueError):
        multihost.local_rows(6, 4, 0)

