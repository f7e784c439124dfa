"""The port's train step against ``tpugan.train.build_train_step``, from
one ``TrainState`` carried across (``ckpt/from_jax.load_jax_train_state``),
in fp32 on the same uint8 batches: the logged losses at each of three steps,
and the parameters and BatchNorm running statistics after one and after
three steps, with fuse_stats on and off.

Tolerances: each step's gradients differ from JAX's by fp32 sum order only
(~1e-6 relative).  Adam and RMSprop divide a gradient by its own running
RMS, so every parameter moves by up to about lr per step whatever the size
of its gradient: parameters are held absolutely, to lr / 20 (lr = 2e-4, and
5e-5 for the RMSprop row), far below one step's move, so a wrong update
shows, while sum-order noise (under 1e-6 here) does not.  A near-zero
gradient whose sign flipped between the two would move its parameter by
about 2 lr and fail the check.  The losses and BatchNorm statistics move
with the parameters: 1e-4 relative plus 1e-4 absolute, after three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import module_arrays, to_numpy, twin_train_states
from tpugan import ops as jax_ops
from tpugan.data.datasets import make_synthetic
from tpugan.train.steps import build_train_step
from tpugan_torch.ckpt.from_jax import flatten
from tpugan_torch.train.steps import build_train_step as port_step

CASES = [
    # 64 px, BN in both nets, hflip on (the chip's configuration, cut)
    ("dcgan_celeba64", {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
                        "data.batch_size": 6}),
    # 32 px schedules
    ("dcgan_cifar10", {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
                       "data.batch_size": 6}),
    # RMSprop, weight clipping, and a G update every second call
    ("wgan_cifar10", {"model.ngf": 8, "model.ndf": 8, "model.nz": 12,
                      "data.batch_size": 6, "loss.n_critic": 2}),
]


@pytest.fixture
def fuse():
    yield
    jax_ops.set_fuse_stats("off")


def _compare_state(jstate, pstate, atol):
    for mod, params, st in ((pstate.g, jstate.params_g, jstate.state_g),
                            (pstate.d, jstate.params_d, jstate.state_d)):
        arrays = module_arrays(mod)
        for k, v in flatten(to_numpy(params)).items():
            np.testing.assert_allclose(arrays[k], v, rtol=0, atol=atol,
                                       err_msg=k)
        for k, v in flatten(to_numpy(st)).items():
            np.testing.assert_allclose(arrays[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    assert pstate.step == int(jstate.step)
    np.testing.assert_array_equal(pstate.rng, np.asarray(jstate.rng))


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("preset,overrides", CASES, ids=[c[0] for c in CASES])
def test_three_steps_match_jax(fuse, preset, overrides, mode):
    overrides = {**overrides, "train.precision": "fp32",
                 "train.fuse_stats": mode}
    cfg, g, d, jstate, pcfg, pstate = twin_train_states(preset, overrides)
    jax_ops.set_fuse_stats(mode)
    jstep = build_train_step(cfg, g, d)
    pstep = port_step(pcfg, pstate.g, pstate.d)
    bsz = cfg.data.batch_size
    imgs = make_synthetic(cfg.model.image_size, cfg.model.channels, 3 * bsz,
                          seed=5)["images"]
    lr = max(cfg.optim.lr_g, cfg.optim.lr_d)
    for i in range(3):
        batch = imgs[i * bsz:(i + 1) * bsz]
        jstate, jm = jstep(jstate, {"image": jnp.asarray(batch)})
        pstate, pm = pstep(pstate, {"image": torch.from_numpy(batch)})
        for k, v in jm.items():
            np.testing.assert_allclose(pm[k].item(), float(v), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {k}")
        if i in (0, 2):
            _compare_state(jax.device_get(jstate), pstate, atol=lr / 20)
