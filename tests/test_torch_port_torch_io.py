"""The reference ``.pth`` interchange, port against the JAX package: the
JAX package's ``export_torch_checkpoint`` imported by the port equals the
same JAX state carried by ``ckpt/from_jax.py`` bit for bit, and the port's
export of that carried state equals the JAX package's key for key and bit
for bit, Adam and RMSprop moments included; then the port's own CLI round
trip and its refusals.  The JAX states hold random weights, buffers,
moments and counts (no train step is compiled), at small widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import port_states_equal
from tpugan.ckpt.torch_export import \
    export_torch_checkpoint as jax_export_torch
from tpugan.configs import get_preset
from tpugan.models import build_models
from tpugan.train.state import create_train_state
from tpugan_torch import cli
from tpugan_torch.ckpt.from_jax import load_jax_train_state
from tpugan_torch.ckpt.reference_nets import build_reference_nets
from tpugan_torch.ckpt.torch_export import export_torch_checkpoint
from tpugan_torch.ckpt.torch_import import (import_optimizer_state,
                                            import_torch_state)
from tpugan_torch.configs import get_preset as port_preset
from tpugan_torch.models.registry import build_models as port_models
from tpugan_torch.train.state import create_train_state as port_state

SMALL = {"model.ngf": 4, "model.ndf": 4, "model.nz": 8,
         "model.embed_dim": 4, "train.precision": "fp32"}
# every storage surface: BN in D and G (Adam, a linear LR at a count off
# zero), spectral norm's u (no BN in D), a G that took no update yet
# (n_critic 5), RMSprop's one moment, and the conditional nets' embed / proj
CASES = {
    "dcgan_cifar10": {"optim.schedule": "linear", "train.total_steps": 10},
    "sngan_cifar10": {},
    "wgan_gp_cifar10": {},
    "wgan_cifar10": {},
    "cdcgan_celeba64": {},
}


def _random_jax_state(preset, overrides, seed=0):
    """(cfg, port cfg, JAX TrainState on the host): weights (std 0.1), BN
    statistics, u, moments and counts all random (variances and second
    moments positive), step 7."""
    cfg = get_preset(preset).override({**SMALL, **overrides})
    g, d = build_models(cfg.model, cfg.train.precision)
    state = jax.device_get(create_train_state(cfg, g, d))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if a.dtype.kind in "iu":
            return np.full(a.shape, 7, a.dtype)
        v = rng.standard_normal(a.shape).astype(a.dtype)
        return np.abs(v) + 0.1 if ("var" in name or "nu" in name) else v

    fields = {k: jax.tree_util.tree_map_with_path(fill, getattr(state, k))
              for k in ("state_g", "state_d", "opt_g", "opt_d")}
    for k in ("params_g", "params_d"):
        fields[k] = jax.tree.map(lambda a: 0.1 * a, jax.tree_util.
                                 tree_map_with_path(fill, getattr(state, k)))
    if cfg.loss.n_critic > 1:  # G has taken no update: optax's init state
        fields["opt_g"] = state.opt_g
    state = state.replace(step=np.asarray(7, np.int32), **fields)
    return cfg, port_preset(preset).override({**SMALL, **overrides}), state


def _carried(pcfg, jstate):
    """The JAX state carried into a port TrainState by ``from_jax``."""
    g, d = port_models(pcfg.model, pcfg.train.precision, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    return load_jax_train_state(port_state(pcfg, g, d), jstate)


def _assert_same_dict(a, b, path=""):
    assert type(a) is type(b) or (isinstance(a, dict)
                                  and isinstance(b, dict)), path
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_same_dict(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_dict(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("preset", list(CASES))
def test_jax_export_imports_as_from_jax_carries(preset):
    """tpugan's .pth of a JAX state -> the port's import == from_jax of
    that state: modules, both optimizers' moments and counts, the step."""
    cfg, pcfg, jstate = _random_jax_state(preset, CASES[preset])
    out = jax_export_torch(cfg, jstate)
    got = import_torch_state(pcfg, out["G"], out["D"], step=out["step"],
                             device="cpu")
    import_optimizer_state(pcfg, got, out["opt_G"], out["opt_D"])
    want = _carried(pcfg, jstate)
    got.rng = want.rng  # the key is not part of a .pth
    port_states_equal(got, want)


@pytest.mark.parametrize("preset", list(CASES))
def test_port_export_equals_jax_export(preset):
    """The port's export of the carried state == tpugan's export of the
    JAX state, key for key and bit for bit (weights, buffers, moments,
    counts, the LR at the count, the markers)."""
    cfg, pcfg, jstate = _random_jax_state(preset, CASES[preset])
    _assert_same_dict(export_torch_checkpoint(pcfg, _carried(pcfg, jstate)),
                      jax_export_torch(cfg, jstate))


@pytest.mark.parametrize("preset", ["dcgan_cifar10", "cdcgan_celeba64",
                                    "sngan_cifar10"])
def test_reference_nets_compute_what_the_port_computes(preset, rng):
    """The exported state_dicts in the reference modules (NCHW) give the
    port's G image and D logit (NHWC), eval mode, fp32."""
    _, pcfg, jstate = _random_jax_state(preset, {})
    state = _carried(pcfg, jstate)
    tg, td = build_reference_nets(pcfg, state.g.state_dict(),
                                  state.d.state_dict())
    for m in (tg, td, state.g, state.d):
        m.eval()
    n, nz = 3, pcfg.model.nz
    z = torch.from_numpy(rng.standard_normal((n, nz)).astype(np.float32))
    cond = pcfg.model.arch == "cdcgan"
    y = torch.arange(n) % max(pcfg.model.n_classes, 1)
    with torch.no_grad():
        img = state.g(z, y) if cond else state.g(z)
        ref_img = (tg(z, y) if cond else tg(z)).permute(0, 2, 3, 1)
        logit = state.d(img, y) if cond else state.d(img)
        nchw = img.permute(0, 3, 1, 2)
        ref_logit = td(nchw, y) if cond else td(nchw)
    # fp32, the convolutions' sum order (NCHW against NHWC)
    np.testing.assert_allclose(ref_img.numpy(), img.numpy(), atol=1e-4)
    np.testing.assert_allclose(ref_logit.numpy(), logit.numpy(), rtol=1e-4,
                               atol=1e-4)


def _train_ckpt(tmp_path, capsys, preset="dcgan_cifar10", extra=()):
    out = str(tmp_path / "run")
    sets = ["data.dataset=synthetic", "data.batch_size=4",
            "data.synthetic_size=16", "model.ngf=4", "model.ndf=4",
            "model.nz=8", "train.total_steps=2", "train.log_every=2",
            "train.sample_every=0", "train.ckpt_every=2",
            "train.precision=fp32", *extra]
    cli.main(["--device", "cpu", "train", preset, "--out", out]
             + [a for s in sets for a in ("--set", s)])
    capsys.readouterr()
    return out + "/ckpt", sets


def _restored(ckpt):
    return cli._load_state(ckpt, "cpu")[1]


def test_cli_round_trip_bit_for_bit(tmp_path, capsys):
    """train -> export-torch -> import-torch: modules, moments (warm),
    counts and step bit for bit."""
    ckpt, sets = _train_ckpt(tmp_path, capsys)
    pth = str(tmp_path / "m.pth")
    cli.main(["--device", "cpu", "export-torch", "--ckpt", ckpt,
              "--out", pth])
    loaded = torch.load(pth, map_location="cpu", weights_only=True)
    assert set(loaded) == {"G", "D", "step", "ema", "opt_G", "opt_D",
                           "tpugan_export"}
    assert loaded["step"] == 2 and loaded["ema"] is False
    back = str(tmp_path / "back")
    cli.main(["--device", "cpu", "import-torch", "dcgan_cifar10", "--ckpt",
              pth, "--out", back] + [a for s in sets for a in ("--set", s)])
    assert "restored warm for G+D" in capsys.readouterr().out
    a, b = _restored(ckpt), _restored(back)
    assert any(float(st["exp_avg"].abs().max()) > 0
               for st in a.opt_d.state.values())
    b.rng = a.rng  # the key is not part of a .pth
    port_states_equal(b, a)


def test_cli_refusals_and_provenance(tmp_path, capsys):
    """A future export version and a foreign 'ema' dict keep the moments
    fresh / the weights raw; --g drops --ckpt's G moments and EMA flag."""
    ckpt, sets = _train_ckpt(tmp_path, capsys)
    state = _restored(ckpt)
    flags = [a for s in sets for a in ("--set", s)]

    def imp(obj, name, *extra):
        path = str(tmp_path / f"{name}.pth")
        torch.save(obj, path)
        out = str(tmp_path / name)
        cli.main(["--device", "cpu", "import-torch", "dcgan_cifar10",
                  "--ckpt", path, "--out", out, *extra] + flags)
        return capsys.readouterr().out, _restored(out)

    out = export_torch_checkpoint(cli._load_cfg_for_ckpt(ckpt), state)
    future = dict(out, tpugan_export=dict(out["tpugan_export"], version=2))
    text, got = imp(future, "future")
    assert "v2 != this build's v1" in text and not got.opt_g.state
    foreign = dict(out, ema={"head.weight": torch.zeros(1)})
    text, got = imp(foreign, "foreign")
    assert "foreign EMA" in text and "marks its G weights as EMA" not in text
    ema = dict(out, ema=True)
    g_only = str(tmp_path / "g.pth")
    torch.save({"G": out["G"]}, g_only)
    text, got = imp(ema, "override", "--g", g_only)
    assert "restored warm for D" in text and "as EMA" not in text
    assert not got.opt_g.state and got.opt_d.state


def test_import_refuses_a_wrong_architecture():
    _, pcfg, jstate = _random_jax_state("dcgan_cifar10", {})
    out = export_torch_checkpoint(pcfg, _carried(pcfg, jstate))
    wide = pcfg.override({"model.ngf": 8})
    with pytest.raises(ValueError, match="architecture mismatch"):
        import_torch_state(wide, out["G"], None, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        import_torch_state(pcfg, {k: v for k, v in out["G"].items()
                                  if k != "final.bias"}, None, device="cpu")
    with pytest.raises(ValueError, match="no port destination"):
        import_torch_state(pcfg, None, dict(out["D"], extra=torch.zeros(1)),
                           device="cpu")
    with pytest.raises(ValueError, match="param entries"):
        import_optimizer_state(pcfg, _carried(pcfg, jstate), None,
                               {"state": {0: {}}, "param_groups": []})
