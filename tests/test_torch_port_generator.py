"""The port's generator modules against the JAX package after carrying the
weights across: eval and train outputs, BN running-state updates, the
fused eval GBlock of the "pallas" impl, configs and the weight map."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import to_numpy, twin_generators
from tpugan.configs import Config as JaxConfig
from tpugan.configs import get_preset, list_presets
from tpugan.models import build_models
from tpugan_torch.ckpt.from_jax import flatten, load_jax_module
from tpugan_torch.configs import Config
from tpugan_torch.configs import list_presets as port_list_presets
from tpugan_torch.models.registry import build_discriminator, build_generator
from tpugan_torch.ops import convs


def _port_forward(tg, z, y=None):
    with torch.no_grad():
        z = torch.from_numpy(z)
        out = tg(z, torch.from_numpy(y)) if y is not None else tg(z)
    return out.float().numpy()


@pytest.mark.parametrize("preset,overrides", [
    ("dcgan_mnist", {"model.ngf": 8}),
    ("dcgan_cifar10", {"model.ngf": 8}),
    ("dcgan_celeba64", {"model.ngf": 8}),
    ("cdcgan_celeba128", {"model.ngf": 4, "model.nz": 16,
                          "model.embed_dim": 6}),
])
def test_generator_eval_and_train_match_jax(rng, preset, overrides):
    cfg, g, params, state, _, tg = twin_generators(preset, overrides)
    cond = cfg.model.arch == "cdcgan"
    z = rng.standard_normal((4, cfg.model.nz)).astype(np.float32)
    y = np.array([1, 0, 1, 1], np.int32) if cond else None
    zin = (jnp.asarray(z), jnp.asarray(y)) if cond else jnp.asarray(z)

    # fp32 both sides; sum order and XLA's CPU rsqrt (an ulp off torch's)
    # are the only differences, so 1e-4
    ref, _ = g.apply(params, state, zin, train=False)
    np.testing.assert_allclose(_port_forward(tg.eval(), z, y),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)

    ref_t, new_state = g.apply(params, state, zin, train=True)
    got_t = _port_forward(tg.train(), z, y)
    np.testing.assert_allclose(got_t, np.asarray(ref_t), rtol=1e-4,
                               atol=1e-4)
    want = flatten(to_numpy(new_state))
    have = {k: v.numpy() for k, v in tg.state_dict().items() if k in want}
    assert set(have) == set(want) and want
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_bf16_generator_matches_jax(rng):
    cfg, g, params, state, _, tg = twin_generators(
        "dcgan_celeba64", {"model.ngf": 8}, precision="bf16")
    z = rng.standard_normal((4, cfg.model.nz)).astype(np.float32)
    ref = np.asarray(g.apply(params, state, jnp.asarray(z), train=False)[0],
                     np.float32)
    got = _port_forward(tg, z)
    # bf16 activations: a one-ulp flip (2^-8 relative) of an activation
    # from a different sum order can reach a pixel; the mean stays tiny
    np.testing.assert_allclose(got, ref, atol=5e-2)
    assert np.abs(got - ref).mean() < 2e-3


def test_pallas_impl_module_path_matches_jax(rng):
    """Under set_default_impl("pallas"): eval GBlocks are one fused
    ConvT+BN+act call each, train GBlocks the bare kernel then BN (plain
    versions on CPU); both equal the JAX forward."""
    cfg, g, params, state, _, tg = twin_generators(
        "dcgan_cifar10", {"model.ngf": 8})
    z = rng.standard_normal((4, cfg.model.nz)).astype(np.float32)
    ref = np.asarray(g.apply(params, state, jnp.asarray(z), train=False)[0])
    ref_t = np.asarray(g.apply(params, state, jnp.asarray(z), train=True)[0])
    convs.set_default_impl("pallas")
    try:
        got = _port_forward(tg.eval(), z)
        got_t = _port_forward(tg.train(), z)
        with pytest.raises(RuntimeError, match="forward-only"):
            tg(torch.from_numpy(z))  # autograd through the kernel path
    finally:
        convs.set_default_impl("xla")
    # fp32; the fold a = scale*rsqrt(var+eps) reorders the BN arithmetic
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_t, ref_t, rtol=1e-4, atol=1e-4)


def test_weight_map_rejects_missing_extra_and_misshapen(rng):
    _, g, params, state, pcfg, tg = twin_generators(
        "dcgan_cifar10", {"model.ngf": 8})
    p, s = to_numpy(params), to_numpy(state)
    bad = {**p, "extra": {"w": np.zeros(3, np.float32)}}
    with pytest.raises(KeyError, match="extra"):
        load_jax_module(tg, bad, s)
    missing = {k: v for k, v in p.items() if k != "final"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_module(tg, missing, s)
    p["final"] = {"conv": {"w": np.zeros((4, 4, 8, 2), np.float32),
                           "b": p["final"]["conv"]["b"]}}
    with pytest.raises(ValueError, match="shape"):
        load_jax_module(tg, p, s)


def test_configs_round_trip_between_packages():
    assert port_list_presets() == list_presets()
    for name in list_presets():
        ours = Config.from_dict(json.loads(get_preset(name).to_json()))
        assert ours.to_dict() == get_preset(name).to_dict()
        theirs = JaxConfig.from_dict(json.loads(ours.to_json()))
        assert theirs.to_dict() == ours.to_dict()


def test_cuda_default_raises_without_a_card():
    cfg = get_preset("dcgan_cifar10").override({"model.ngf": 4})
    pcfg = Config.from_dict(cfg.to_dict())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        build_generator(pcfg.model)
    with pytest.raises(RuntimeError, match="cuda"):
        build_discriminator(pcfg.model)


def test_jax_init_is_not_needed_for_a_port_generator():
    """A port generator from its own seeded torch.Generator is
    deterministic in the seed and has the JAX parameter names."""
    pcfg = Config.from_dict(get_preset("dcgan_cifar10").override(
        {"model.ngf": 4}).to_dict())
    a = build_generator(pcfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    b = build_generator(pcfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    g, _ = build_models(
        get_preset("dcgan_cifar10").override({"model.ngf": 4}).model)
    params, state = g.init(jax.random.PRNGKey(0))
    names = set(flatten(params)) | set(flatten(state))
    assert names == set(a.state_dict())


# A bf16 eval GBlock against tpugan's: the port's fused block rounds once,
# after the fp32 affine and activation; tpugan rounds the ConvT output to
# bf16, then applies BN (fp32, rounded) and the activation.  As for the
# DBlock (tests/test_torch_port_discriminator.py): 2^-7 |ref| + 2^-6 of the
# largest |convT| * a, a few ulps of the layer's largest value.
@pytest.mark.parametrize("final", [False, True], ids=["BN + ReLU",
                                                      "final, Tanh"])
def test_bf16_fused_eval_gblock_matches_jax(rng, final):
    from tpugan.models.blocks import GBlock as JaxGBlock
    from tpugan_torch.models.blocks import GBlock

    cin, cout = 32, (3 if final else 16)
    jb = JaxGBlock(cin, cout, final=final, dtype=jnp.bfloat16)
    params, state = jb.init(jax.random.PRNGKey(5))
    if final:  # a bias that is not zero
        params["conv"]["b"] = jax.random.normal(jax.random.PRNGKey(6),
                                                (cout,)) * 0.1
    x = rng.standard_normal((4, 8, 8, cin)).astype(np.float32)
    for _ in range(2):  # running statistics from two train-mode batches
        _, state = jb.apply(params, state, jnp.asarray(
            rng.standard_normal(x.shape), jnp.bfloat16), train=True)
    ref, _ = jb.apply(params, state, jnp.asarray(x, jnp.bfloat16),
                      train=False)
    tb = GBlock(cin, cout, final=final, device="cpu",
                generator=torch.Generator().manual_seed(5))
    load_jax_module(tb, to_numpy(params), to_numpy(state))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    convs.set_default_impl("pallas")
    try:
        with torch.no_grad():
            got = tb.eval()(xb)
    finally:
        convs.set_default_impl("xla")
    assert got.dtype == torch.bfloat16
    a = (torch.ones(cout) if final
         else tb.bn.scale * torch.rsqrt(tb.bn.var + tb.bn.eps))
    pre = convs.conv_transpose2d(xb.float(), tb.conv.w.to(torch.bfloat16)
                                 .float(), stride=2, padding=1,
                                 impl="xla") * a
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    err = (got.float() - ref).abs()
    limit = 2.0 ** -7 * ref.abs() + 2.0 ** -6 * pre.abs().max()
    assert bool((err <= limit).all()), (
        f"max err {err.max().item()}, largest value "
        f"{ref.abs().max().item()}, largest |convT| * a "
        f"{pre.abs().max().item()}")
