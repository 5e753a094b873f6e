"""PyTorch port, paper §5.2.2 approximations (``repro_torch.core.approx``)
against the JAX reference (``repro.core.approx``) on the same fp32 inputs:
the three bit-level functions bit-identical, clip edges included; the
softmax/squash composites (which add a reduction) within a few ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx as japprox
from repro_torch.core import approx as tapprox


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if kind == "exp":
        # the clip edges: y = log2e·x + 126.94 reaches 0 near x = -88 and
        # 254.999 near x = 88.7; below x ≈ -87.3 the bitcast is subnormal
        edges = np.array([-200.0, -100.0, -88.0, -87.99, -87.5, -87.34,
                          -87.3, -87.0, -1e-30, 0.0, 1e-30, 88.0, 88.7,
                          88.72, 88.8, 100.0, 1e4], np.float32)
        return np.concatenate([edges, rng.uniform(-100, 100, 4000)
                               .astype(np.float32)])
    # positive squash norms, tiny to huge
    return np.concatenate([
        np.array([1e-30, 1e-9, 1e-3, 0.5, 1.0, 2.0, 1e3, 1e9, 3e38],
                 np.float32),
        np.exp(rng.uniform(-20, 20, 4000)).astype(np.float32)])


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("recover", [True, False])
def test_fast_exp_bit_identical(recover):
    x = _inputs("exp")
    want = japprox.fast_exp(jnp.asarray(x), recover=recover)
    got = tapprox.fast_exp(torch.from_numpy(x), recover=recover)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("newton_iters", [0, 1, 2])
@pytest.mark.parametrize("recover", [True, False])
def test_fast_inv_sqrt_bit_identical(newton_iters, recover):
    x = _inputs("pos")
    want = japprox.fast_inv_sqrt(jnp.asarray(x), newton_iters=newton_iters,
                                 recover=recover)
    got = tapprox.fast_inv_sqrt(torch.from_numpy(x),
                                newton_iters=newton_iters, recover=recover)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("newton_iters", [0, 1, 2])
@pytest.mark.parametrize("recover", [True, False])
def test_fast_reciprocal_bit_identical(newton_iters, recover):
    x = _inputs("pos")
    want = japprox.fast_reciprocal(jnp.asarray(x), newton_iters=newton_iters,
                                   recover=recover)
    got = tapprox.fast_reciprocal(torch.from_numpy(x),
                                  newton_iters=newton_iters, recover=recover)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_constants_identical():
    for name in ("LOG2E", "EXP_AVG", "_F32_BIAS", "_F32_MANT",
                 "EXP_RECOVERY", "INV_SQRT_RECOVERY", "RECIP_RECOVERY"):
        assert getattr(tapprox, name) == getattr(japprox, name), name


@pytest.mark.parametrize("fn,scale", [("approx_softmax", 5.0),
                                      ("exact_softmax", 5.0),
                                      ("approx_squash", 1.0),
                                      ("exact_squash", 1.0)])
def test_composites_match(fn, scale):
    """A sum over the last axis joins the bit-level parts; XLA and PyTorch
    order it differently, so these agree to a few ulp, not bit for bit."""
    x = (np.random.default_rng(1).standard_normal((64, 10)) * scale
         ).astype(np.float32)
    want = np.asarray(getattr(japprox, fn)(jnp.asarray(x)))
    got = getattr(tapprox, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_calibrate_recovery_matches():
    x = np.random.default_rng(0).uniform(-10, 10, 10_000).astype(np.float32)
    want = japprox.calibrate_recovery(
        lambda v: japprox.fast_exp(v, recover=False), jnp.exp,
        jnp.asarray(x))
    got = tapprox.calibrate_recovery(
        lambda v: tapprox.fast_exp(v, recover=False), torch.exp,
        torch.from_numpy(x))
    assert abs(got - want) < 1e-6
    assert abs(got - tapprox.EXP_RECOVERY) < 5e-4
