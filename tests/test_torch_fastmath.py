"""PyTorch port, the §5.2.2 fast-math kernel (``repro_torch.kernels.fastmath``)
against the JAX package's (``repro.kernels.fastmath``, Pallas in interpret
mode) on the same numpy inputs.

Tolerances: the port's plain version rounds every fp32 operation on its
own, so it is held bitwise to an IEEE fp32 model written here in numpy
(which never contracts) — on ranges that reach the fast-exp clip at
254.999 and the subnormal bitcasts below x ≈ −87.3.  The reference's
interpret-mode kernel runs on XLA's CPU backend, which contracts
``LOG2E·x + c`` and the Newton steps into fused multiply-adds, so against
it the port is held to the reference's own ``rtol`` for that difference
(``tests/test_kernels.py::test_fastmath_matches_core_approx``): 5e-5 for
exp and 1e-6 for inv_sqrt and reciprocal, with its atol of 1e-8 for the
subnormal results.  Against the exact oracles, the reference's accuracy
bounds (exp 0.045, inv_sqrt 0.005, reciprocal 0.02).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.approx import (EXP_AVG, EXP_RECOVERY, INV_SQRT_RECOVERY,
                               LOG2E, RECIP_RECOVERY)
from repro.kernels.fastmath import kernel as jkernel
from repro.kernels.fastmath import ops as jops
from repro.kernels.fastmath import ref as jref
from repro_torch.kernels.fastmath import kernel as tkernel
from repro_torch.kernels.fastmath import ops as tops
from repro_torch.kernels.fastmath import ref as tref

RTOL = {"exp": 5e-5, "inv_sqrt": 1e-6, "reciprocal": 1e-6}
ORACLE = {"exp": (tref.exp_ref, 0.045), "inv_sqrt": (tref.inv_sqrt_ref, 0.005),
          "reciprocal": (tref.reciprocal_ref, 0.02)}
F32 = np.float32


def _x(op: str, shape, seed=0) -> np.ndarray:
    """The reference test's inputs: U[0.1, 8), shifted by −4 for exp."""
    x = np.random.default_rng(seed).uniform(0.1, 8.0, shape).astype(F32)
    return x - F32(4.0) if op == "exp" else x


# ---------------------------------------------------------------------------
# an IEEE fp32 model of the reference kernel's arithmetic, in numpy
# ---------------------------------------------------------------------------

def _ieee_model(x: np.ndarray, op: str, recover: bool) -> np.ndarray:
    x = x.astype(F32)
    with np.errstate(over="ignore", invalid="ignore"):
        if op == "exp":
            y = F32(LOG2E) * x + F32(127.0 + EXP_AVG)
            y = np.clip(y, F32(0.0), F32(254.999))
            bits = (y * F32(2.0 ** 23)).astype(np.int32)    # truncates
            out = bits.view(F32)
            if recover:   # the reference's multiply flushes a subnormal
                out = np.where(bits < 0x800000, F32(0.0),
                               out * F32(EXP_RECOVERY))
            return out
        i = x.view(np.int32)
        if op == "inv_sqrt":
            y = (np.int32(0x5F3759DF) - (i >> 1)).view(F32)
            y = y * (F32(1.5) - F32(0.5) * x * y * y)
            rec = INV_SQRT_RECOVERY
        else:
            y = (np.int32(0x7EF311C2) - i).view(F32)
            y = y * (F32(2.0) - x * y)
            rec = RECIP_RECOVERY
        return y * F32(rec) if recover else y


def _edge_inputs(op: str) -> np.ndarray:
    if op == "exp":
        # the subnormal bitcasts (x in about [-88, -87.3]), the clip at 0
        # below them and the clip at 254.999 above x ≈ 88.7
        x = np.concatenate([np.linspace(-100.0, 200.0, 6000),
                            np.linspace(-88.5, -87.0, 1500),
                            [-88.0, -87.99, -87.5, 88.5, 88.8, 176.7, 1e4]])
    else:
        x = np.concatenate([np.logspace(-30, 30, 6000),
                            np.linspace(0.01, 100.0, 1500)])
    return x.astype(F32).reshape(-1, 1)


@pytest.mark.parametrize("recover", [True, False])
@pytest.mark.parametrize("op", ["exp", "inv_sqrt", "reciprocal"])
def test_plain_is_bitwise_the_ieee_model(op, recover):
    x = _edge_inputs(op)
    got = tkernel.fastmath_2d(torch.from_numpy(x), op=op, recover=recover,
                              block_rows=1, block_cols=1).numpy()
    want = _ieee_model(x, op, recover)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if op == "exp":
        sub = (want.view(np.int32) > 0) & (want.view(np.int32) < 0x800000)
        assert sub.any() == (not recover)   # subnormals only without recovery
        assert (want == want.max()).sum() > 1    # the clip at 254.999


# ---------------------------------------------------------------------------
# against the reference kernel (interpret mode) and the exact oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recover", [True, False])
@pytest.mark.parametrize("shape", [(8,), (100,), (16, 32), (3, 5, 7)])
@pytest.mark.parametrize("op", ["exp", "inv_sqrt", "reciprocal"])
def test_ops_match_reference(op, shape, recover):
    x = _x(op, shape)
    got = getattr(tops, op)(torch.from_numpy(x), recover=recover)
    want = np.asarray(getattr(jops, op)(jnp.asarray(x), recover=recover))
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[op], atol=1e-8)
    if recover:
        oracle, tol = ORACLE[op]
        exact = oracle(torch.from_numpy(x)).numpy()
        assert (np.abs(got.numpy() - exact) / np.abs(exact)).max() < tol


@pytest.mark.parametrize("recover", [True, False])
def test_exp_edges_match_reference(recover):
    x = _edge_inputs("exp")[:, 0]
    x = np.pad(x, (0, -x.size % 512))
    got = tops.exp(torch.from_numpy(x), recover=recover).numpy()
    want = np.asarray(jops.exp(jnp.asarray(x), recover=recover))
    np.testing.assert_allclose(got, want, rtol=RTOL["exp"], atol=1e-8)
    # the clip at 254.999 saturates both to the same largest value
    top = x > 89.0
    np.testing.assert_array_equal(got[top], want[top])


@pytest.mark.parametrize("op", ["exp", "inv_sqrt", "reciprocal"])
def test_fastmath_2d_matches_reference_on_blocks(op):
    x = _x(op, (512, 1024), seed=3)
    got = tkernel.fastmath_2d(torch.from_numpy(x), op=op, block_rows=256,
                              block_cols=512)
    want = jkernel.fastmath_2d(jnp.asarray(x), op=op, block_rows=256,
                               block_cols=512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL[op],
                               atol=1e-8)


@pytest.mark.parametrize("name", ["exp_ref", "inv_sqrt_ref",
                                  "reciprocal_ref", "squash_ref"])
def test_exact_oracles_match_reference(name):
    x = _x("inv_sqrt", (6, 16), seed=4)
    got = getattr(tref, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jref, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_error_surface_matches_reference():
    for shape, blocks in (((300, 512), {}), ((8, 96), dict(block_cols=64))):
        x = np.ones(shape, F32)
        with pytest.raises(ValueError, match="not divisible by block"):
            jkernel.fastmath_2d(jnp.asarray(x), op="exp", **blocks)
        with pytest.raises(ValueError, match="not divisible by block"):
            tkernel.fastmath_2d(torch.from_numpy(x), op="exp", **blocks)
    # the shape-generic entry points pad to rows of 512 and take blocks of
    # up to 256 rows, so 300 rows fail in both packages
    flat = np.ones((300 * 512,), F32)
    with pytest.raises(ValueError, match="not divisible by block"):
        jops.exp(jnp.asarray(flat))
    with pytest.raises(ValueError, match="not divisible by block"):
        tops.exp(torch.from_numpy(flat))
    with pytest.raises(ValueError, match="op must be one of"):
        tkernel.fastmath_2d(torch.ones((4, 4)), op="log")
    x = torch.ones((4, 4), requires_grad=True)
    with pytest.raises(ValueError, match="no autograd formula"):
        tkernel.fastmath_2d(x, op="exp")
    with torch.no_grad():
        assert tkernel.fastmath_2d(x, op="exp").shape == (4, 4)
