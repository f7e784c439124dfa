"""The port's augmentation (``tpugan_torch/ops/augment.py``) against
``tpugan/ops/augment.py`` from the same key, on the CPU.

Tolerances:

- draws: ``bernoulli``, ``uniform`` and ``randint`` bit for bit;
- fp32: brightness, translation and cutout bit for bit (one add, a
  gather, a mask multiply); saturation and contrast within 1e-6 absolute
  (their means sum in another order);
- bf16: within one bf16 ulp (2^-7 relative) of the batch's largest value;
- translation's gradient: the cotangent scattered back, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugan.ops import augment as jax_aug
from tpugan_torch.ops import augment
from tpugan_torch.sample import threefry

POLICY = ("color", "translation", "cutout")
EXACT = ("rand_brightness", "rand_translation", "rand_cutout")
OPS = EXACT + ("rand_saturation", "rand_contrast")


def _batch(shape=(6, 16, 12, 3), seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _key(seed):
    return jax.random.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 0.999])
def test_bernoulli_uniform_randint_are_jaxs(p):
    jk, pk = _key(11)
    np.testing.assert_array_equal(
        threefry.bernoulli(pk, p, (64, 1, 1, 1)),
        np.asarray(jax.random.bernoulli(jk, p, (64, 1, 1, 1))))
    np.testing.assert_array_equal(
        threefry.uniform(pk, (64, 1, 1, 1)),
        np.asarray(jax.random.uniform(jk, (64, 1, 1, 1), jnp.float32)))
    np.testing.assert_array_equal(
        threefry.randint(pk, -8, 9, (64, 1, 1)),
        np.asarray(jax.random.randint(jk, (64, 1, 1), -8, 9)))


@pytest.mark.parametrize("shape", [(6, 16, 12, 3), (5, 32, 32, 1),
                                   (4, 64, 64, 3)])
@pytest.mark.parametrize("op", OPS)
def test_each_op_is_jaxs_on_fp32(op, shape):
    x = _batch(shape, seed=len(op))
    jk, pk = _key(3)
    ref = np.asarray(getattr(jax_aug, op)(jnp.asarray(x), jk))
    got = getattr(augment, op)(torch.from_numpy(x), pk).numpy()
    if op in EXACT:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("p", [1.0, 0.5, "tensor 0.5", "tensor 1.0"])
def test_apply_policy_is_jaxs(p):
    """A Python p (1.0 skips the gates) and a tensor p, ADA's, whose gates
    are drawn even at 1.0: each op from ``split(key, 3)`` in the policy's
    order."""
    x = _batch((8, 16, 16, 3), seed=5)
    jk, pk = _key(7)
    if isinstance(p, str):
        v = np.float32(p.split()[1])
        jp, pp = jnp.asarray(v), torch.tensor(v)
    else:
        jp = pp = p
    ref = np.asarray(jax_aug.apply_policy(jnp.asarray(x), jk, POLICY, jp))
    got = augment.apply_policy(torch.from_numpy(x), pk, POLICY, pp).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert not np.array_equal(got, x)


def test_apply_policy_bf16_within_an_ulp():
    x = _batch((8, 16, 16, 3), seed=6)
    jk, pk = _key(9)
    ref = np.asarray(jax_aug.apply_policy(
        jnp.asarray(x, jnp.bfloat16), jk, POLICY, 0.6).astype(jnp.float32))
    out = augment.apply_policy(torch.from_numpy(x).bfloat16(), pk, POLICY,
                               0.6)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())


def test_translation_gradient_is_jaxs():
    """The gather's backward scatters the cotangent onto the pixels each
    output read (zero on the pixels shifted out), as the one-hot matmuls'
    transposes do."""
    x = _batch((4, 16, 16, 2), seed=8)
    cot = _batch((4, 16, 16, 2), seed=9)
    jk, pk = _key(4)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(
        jax_aug.rand_translation(v, jk) * cot))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (augment.rand_translation(xt, pk) * torch.from_numpy(cot)).sum(
    ).backward()
    np.testing.assert_array_equal(xt.grad.numpy(), ref)
    assert (ref == 0).any()  # some pixels were shifted out


def test_policy_gradient_flows_through_every_op():
    x = torch.from_numpy(_batch((4, 16, 16, 3), seed=10)).requires_grad_()
    augment.apply_policy(x, threefry.prng_key(1), POLICY).square().sum(
    ).backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert x.grad.abs().sum().item() > 0


def test_parse_policy():
    assert augment.parse_policy(" color, cutout ,") == ("color", "cutout")
    assert augment.POLICY_NAMES == jax_aug.POLICY_NAMES
    with pytest.raises(ValueError, match="unknown augment op"):
        augment.parse_policy("color,blur")
