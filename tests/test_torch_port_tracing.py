"""The port's spans and counters (``tpugan_torch/utils/tracing.py``): off
without a profiler (one shared null context, nothing counted); under a
CPU ``torch.profiler`` a FusedProp, an alternating and a conditional step
record their spans once a step, nested as ``train/steps.py`` says; a
traced step computes the untraced step's bits; on the CPU a step draws
threefry.py's bits without the threefry kernel or its library, and counts
no draw on a card; a copy of a host array to a device is a span and
counted, one to the CPU neither; the input pipeline counts its takes and
its producer's time; the Trainer's ``profile_steps`` window writes the
counters beside its trace.  This file imports no JAX."""

import json

import numpy as np
import pytest
import torch

from tpugan_torch.configs import get_preset
from tpugan_torch.data.pipeline import make_input_pipeline
from tpugan_torch.models.registry import build_models
from tpugan_torch.ops import _build, cuda_threefry
from tpugan_torch.sample import threefry
from tpugan_torch.train.state import create_train_state
from tpugan_torch.train.steps import build_train_step
from tpugan_torch.train.trainer import Trainer
from tpugan_torch.utils import tracing

SMALL = {"model.ngf": 8, "model.ndf": 8, "model.nz": 16,
         "data.batch_size": 4, "train.precision": "fp32", "train.ema": 0.99}
# (preset, overrides, the grads and update spans of its step)
STEPS = {
    "fused": ("dcgan_celeba64_fast", {"train.steps_per_call": 2},
              ["step.grads"]),
    "alternating": ("dcgan_celeba64", {}, ["step.d_grads", "step.g_grads"]),
    "conditional": ("cdcgan_celeba64", {}, ["step.d_grads", "step.g_grads"]),
}
UPDATES = ["step.d_update", "step.g_update", "step.ema"]


def _setup(preset, over):
    cfg = get_preset(preset).override({**SMALL, **over})
    g, d = build_models(cfg.model, cfg.train.precision, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, g, d)
    rng = np.random.default_rng(0)
    s, c, n = cfg.model.image_size, cfg.model.channels, 4
    images = torch.from_numpy(rng.integers(0, 256, (n * 4, s, s, c),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, max(cfg.model.n_classes, 1),
                                           n * 4))
    if cfg.data.device_resident:
        batch = {"dataset_images": images}
    else:
        batch = {"image": images[:n]}
    if cfg.model.arch == "cdcgan":
        batch["dataset_labels" if cfg.data.device_resident
              else "label"] = labels[:len(next(iter(batch.values())))]
    return cfg, state, build_train_step(cfg, g, d), batch


def _profiled(fn):
    """fn() under a CPU profiler; (its result, [(name, start, end)] of the
    program's spans)."""
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name()[len(tracing.PREFIX):], e.start_ns(),
              e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(tracing.PREFIX)]
    return out, spans


def _parent(spans, span):
    """The name of the innermost other span that holds ``span``."""
    _, s, e = span
    holders = [x for x in spans if x is not span and x[1] <= s
               and e <= x[2]]
    return min(holders, key=lambda x: x[2] - x[1])[0] if holders else None


def test_span_off_is_one_null_context_and_counts_nothing():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("step") is tracing.span("step.draws")
    cfg, state, step, batch = _setup(*STEPS["fused"][:2])
    tracing.reset()
    step(state, batch)
    tracing.count("x")
    assert tracing.counters() == {}
    assert tracing.h2d(np.zeros(3), "cpu").shape == (3,)


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_traced_step_records_its_spans_nested(kind):
    preset, over, grads = STEPS[kind]
    cfg, state, step, batch = _setup(preset, over)
    k = max(cfg.train.steps_per_call, 1)
    _, spans = _profiled(lambda: step(state, batch))
    names = [n for n, _, _ in spans]
    for name in ["step", "step.real_batch"] + grads + UPDATES:
        assert names.count(name) == k, (name, names)
    draws = names.count("step.draws")
    assert draws == k * (1 if cfg.train.fused_prop else 2), names
    parents = {(n, _parent(spans, x)) for x, n in zip(spans, names)}
    assert parents == {("step", None), ("step.ema", "step.g_update")} | {
        (n, "step") for n in ["step.draws", "step.real_batch",
                              "step.d_update", "step.g_update"] + grads}
    # on the CPU nothing is copied to a card, nor drawn on one
    assert "h2d_blocking" not in tracing.counters()
    assert "device_draws" not in tracing.counters()


def _host_draws(cfg, rng, batch):
    """What a step of ``cfg`` from key ``rng`` draws, in order, as the host
    drew it for the device: (the next key, [(name, array)])."""
    (rng, k_zd, k_zg, _, k_yd, k_yg, k_flip,
     k_data) = threefry.split(rng, 8)
    bsz, nz, c = cfg.data.batch_size, cfg.model.nz, cfg.model.n_classes
    out = []
    if "dataset_images" in batch:
        n_set = batch["dataset_images"].shape[0]
        out.append(("randint", threefry.randint(k_data, 0, n_set, (bsz,))
                    .astype(np.int64)))
    if cfg.data.hflip:
        out.append(("bernoulli",
                    threefry.uniform(k_flip, (bsz, 1, 1, 1)) < 0.5))
    conditional = cfg.model.arch == "cdcgan"
    for k_z, k_y in ((k_zd, k_yd), (k_zg, k_yg))[:1 + (
            not cfg.train.fused_prop)]:
        out.append(("normal", threefry.normal(k_z, (bsz, nz))))
        if conditional:
            out.append(("randint", threefry.randint(k_y, 0, c, (bsz,))
                        .astype(np.int64)))
    return rng, out


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_cpu_step_draws_threefrys_bits_without_the_kernel(kind, monkeypatch):
    """On the CPU the step's draws are the host's threefry draws, bit for
    bit, in the step's order; neither the threefry kernel's library nor
    any other is loaded."""
    cfg, state, step, batch = _setup(*STEPS[kind][:2])

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel library was loaded on the CPU")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(cuda_threefry, "_lib", refuse)
    drawn = []
    for name in ("normal", "randint", "bernoulli"):
        def spy(*args, _draw=getattr(cuda_threefry, name), _name=name):
            out = _draw(*args)
            drawn.append((_name, out))
            return out
        monkeypatch.setattr(cuda_threefry, name, spy)
    rng, expected = state.rng, []
    for _ in range(max(cfg.train.steps_per_call, 1)):
        rng, draws = _host_draws(cfg, rng, batch)
        expected += draws
    _profiled(lambda: step(state, batch))
    assert [n for n, _ in drawn] == [n for n, _ in expected]
    for (name, got), (_, ref) in zip(drawn, expected):
        assert got.device.type == "cpu" and got.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    assert np.array_equal(state.rng, rng)
    assert "device_draws" not in tracing.counters()


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_traced_step_computes_the_untraced_steps_bits(kind):
    preset, over, _ = STEPS[kind]
    _, plain, step_a, batch = _setup(preset, over)
    _, traced, step_b, _ = _setup(preset, over)
    _, m_plain = step_a(plain, batch)
    (_, m_traced), _ = _profiled(lambda: step_b(traced, batch))
    assert {k: v.item() for k, v in m_plain.items()} == {
        k: v.item() for k, v in m_traced.items()}
    for mod in ("g", "d", "g_ema"):
        for (n, a), b in zip(getattr(plain, mod).state_dict().items(),
                             getattr(traced, mod).state_dict().values()):
            assert torch.equal(a, b), (mod, n)
    assert plain.step == traced.step and np.array_equal(plain.rng,
                                                        traced.rng)


def test_h2d_spans_and_counts_copies_to_a_device():
    host = np.arange(6, dtype=np.float32)
    on_cpu = tracing.h2d(host, "cpu")
    (meta, copied), spans = _profiled(lambda: (
        tracing.h2d(host, "meta"), tracing.h2d(torch.zeros(2, 3), "meta")))
    assert meta.device.type == "meta" and meta.shape == on_cpu.shape
    assert copied.device.type == "meta" and copied.shape == (2, 3)
    assert [n for n, _, _ in spans] == ["h2d", "h2d"]
    assert tracing.counters() == {"h2d_blocking": 2,
                                  "h2d_blocking_bytes": 6 * 4 + 6 * 4}
    _, spans = _profiled(lambda: (tracing.h2d(host, "cpu"),
                                  tracing.h2d(meta, "meta")))
    assert spans == [] and tracing.counters() == {}


def test_pipeline_counts_its_takes_and_producer_time():
    data = {"images": np.random.default_rng(0).integers(
        0, 256, (32, 8, 8, 3), dtype=np.uint8)}
    it = iter(make_input_pipeline(data, 4, device="cpu", with_labels=False))
    try:
        next(it)  # untraced: not counted
        _, spans = _profiled(lambda: [next(it) for _ in range(3)])
    finally:
        it.close()
    c = tracing.counters()
    assert c["input.batches"] == 3 and c["input.produce_s"] > 0
    assert 0 <= c["input.starved"] <= 3
    assert [n for n, _, _ in spans] == ["input.take"] * 3


def test_profile_steps_writes_the_counters(tmp_path):
    cfg = get_preset("dcgan_celeba64").override({
        **SMALL, "data.dataset": "synthetic", "data.synthetic_size": 16,
        "train.total_steps": 3, "train.profile_steps": 1,
        "train.log_every": 1, "train.sample_every": 0,
        "train.ckpt_every": 0, "train.out_dir": str(tmp_path / "out"),
        "train.ckpt_dir": str(tmp_path / "ckpt")})
    Trainer(cfg, device="cpu").train()
    prof = tmp_path / "out" / "prof"
    assert (prof / "steps_0000002.json.gz").is_file()
    counters = json.loads((prof / "steps_0000002.counters.json").read_text())
    assert counters["input.batches"] == 1  # the one profiled call's take
