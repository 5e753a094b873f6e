"""PyTorch port, the bf16 tensor-core flash-attention kernels' rounding and
their gate, on the CPU.

The bf16 kernels round p (and ds in the backward) to bf16 once before each
product whose operand it is.  The plain versions model that with
``round_operands=True``; these tests hold the model to the JAX package's
Pallas kernels in interpret mode and to its dense oracle ``mha_ref`` at the
reference's own bf16 tolerances (``tests/_gradcheck.py``: ``FWD_ATOL``
5e-2 for o, ``GRAD_ATOL`` 2e-2 for dq, dk, dv), check that
``round_operands=False`` is the unchanged plain arithmetic, bit for bit,
and hold ``chip_smoke.lib_gate`` — the gate of the bf16 kernels on the card
— to what it must pass and what it must refuse.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels.flash_attention import kernel as tfa_kernel

# the reference's cases (tests/test_kernels.py:641-646) and ragged S
BWD_CASES = [
    # (B, Hq, Hkv, S, D, causal)
    (1, 2, 2, 64, 16, True),
    (2, 4, 2, 64, 16, True),      # GQA group=2 (dk/dv group-sum)
    (1, 8, 2, 64, 32, True),      # GQA group=4
    (1, 2, 1, 128, 32, False),    # bidirectional
]
RAGGED_CASES = [(1, 4, 2, 75, 16, True), (2, 2, 1, 45, 32, False)]
FWD_ATOL = 5e-2                   # tests/_gradcheck.py FWD_ATOL["bf16"]
GRAD_ATOL = 2e-2                  # tests/_gradcheck.py GRAD_ATOL["bf16"]
LSE_GATE = 1e-5                   # the lse is fp32 and never rounded


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(B, Hq, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, Hq, S, D), (B, Hkv, S, D),
                               (B, Hkv, S, D), (B, Hq, S, D)))


def _bf16(arrays):
    """The same values as bf16 tensors and as fp32 numpy (bf16-valued)."""
    ts = tuple(torch.tensor(a).to(torch.bfloat16) for a in arrays)
    return ts, tuple(t.float().numpy() for t in ts)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if torch.is_tensor(got)
                                          else jnp.asarray(got, jnp.float32)),
                               np.asarray(want.float() if torch.is_tensor(want)
                                          else jnp.asarray(want,
                                                           jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", BWD_CASES + RAGGED_CASES)
def test_rounding_model_vs_pallas_and_dense_oracle(case):
    B, Hq, Hkv, S, D, causal = case
    (q, k, v, do), (nq, nk, nv, ndo) = _bf16(_inputs(B, Hq, Hkv, S, D))
    o, lse = tfa_kernel.flash_attention_fwd_lse_plain(
        q, k, v, causal=causal, block_q=64, block_k=64, round_operands=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = tfa_kernel.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal, block_q=64, block_k=64,
        round_operands=True)
    # the dense oracle in fp32 on the same bf16 values, and its vjp
    o_r, vjp = jax.vjp(lambda a, b, c: jfa_ref.mha_ref(a, b, c,
                                                      causal=causal),
                       *map(jnp.asarray, (nq, nk, nv)))
    _close(o, o_r, FWD_ATOL)
    for name, g, w, ref in zip(("dq", "dk", "dv"), grads,
                               vjp(jnp.asarray(ndo)), (q, k, v)):
        assert g.shape == ref.shape and g.dtype == torch.bfloat16, name
        _close(g, w, GRAD_ATOL)
    assert torch.equal(tfa_kernel.flash_attention_plain(
        q, k, v, causal=causal, block_q=64, block_k=64, round_operands=True),
        o)
    if S % 64:
        return                    # the Pallas kernels tile S exactly
    # the reference's Pallas kernels in interpret mode, in bf16
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (nq, nk, nv, ndo))
    block = jfa_ops._block(S)
    jkw = dict(causal=causal, block_q=block, block_k=block, interpret=True)
    jo, jlse = jfa_kernel.flash_attention_fwd_lse(jq, jk, jv, **jkw)
    _close(o, jo, FWD_ATOL)
    _close(lse, jlse, LSE_GATE)
    # the backward on the reference's own (o, lse)
    jo_t = torch.tensor(np.asarray(jo.astype(jnp.float32))).to(torch.bfloat16)
    grads = tfa_kernel.flash_attention_bwd_plain(
        q, k, v, jo_t, torch.tensor(np.asarray(jlse)), do, causal=causal,
        round_operands=True)
    jgrads = jfa_kernel.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, **jkw)
    for g, jg in zip(grads, jgrads):
        _close(g, jg, GRAD_ATOL)


def _plain_before_rounding(q, k, v, do, causal, block):
    """The plain versions' arithmetic as it stands without the rounding
    model, written out: the online-softmax forward, then the backward's
    per-block products with ds scaled before them."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    scale = 1.0 / D ** 0.5
    qf = q.float().reshape(B, -1, group, S, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    dof = do.float().reshape(qf.shape)
    out, lse = torch.empty_like(qf), torch.empty(qf.shape[:-1])
    for q0 in range(0, S, block):
        qb = qf[..., q0:q0 + block, :]
        rows = torch.arange(q0, q0 + qb.shape[-2])
        m = torch.full((*qb.shape[:-1], 1), -1e30)
        l, acc = torch.zeros_like(m), torch.zeros_like(qb)
        for k0 in range(0, S, block):
            if causal and k0 > q0 + block - 1:
                break
            s = torch.matmul(qb, kf[..., k0:k0 + block, :]
                             .transpose(-1, -2)) * scale
            if causal:
                cols = torch.arange(k0, k0 + s.shape[-1])
                s = torch.where(cols[None, :] <= rows[:, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vf[..., k0:k0 + block, :])
            m = m_new
        safe = torch.where(l == 0.0, 1.0, l)
        out[..., q0:q0 + block, :] = acc / safe
        lse[..., q0:q0 + block] = (m + torch.log(safe))[..., 0]
    o = out.reshape(q.shape).to(q.dtype)
    delta = (o.float() * do.float()).sum(-1).reshape(*qf.shape[:-1], 1)
    lsef = lse[..., None]
    dq, dk_h, dv_h = (torch.zeros_like(qf) for _ in range(3))
    for q0 in range(0, S, block):
        qb, dob = qf[..., q0:q0 + block, :], dof[..., q0:q0 + block, :]
        rows = torch.arange(q0, q0 + qb.shape[-2])
        acc = torch.zeros_like(qb)
        for k0 in range(0, S, block):
            if causal and k0 > q0 + block - 1:
                break
            kb, vb = kf[..., k0:k0 + block, :], vf[..., k0:k0 + block, :]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if causal:
                cols = torch.arange(k0, k0 + kb.shape[-2])
                s = torch.where(cols[None, :] <= rows[:, None], s, -1e30)
            p = torch.exp(s - lsef[..., q0:q0 + block, :])
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - delta[..., q0:q0 + block, :]) * scale
            acc = acc + torch.matmul(ds, kb)
            dv_h[..., k0:k0 + block, :] += torch.matmul(p.transpose(-1, -2),
                                                        dob)
            dk_h[..., k0:k0 + block, :] += torch.matmul(ds.transpose(-1, -2),
                                                        qb)
        dq[..., q0:q0 + block, :] = acc
    grads = tuple(t.reshape(q.shape).to(q.dtype) for t in (dq, dk_h, dv_h))
    return o, lse.reshape(q.shape[:3]), grads


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(2, 4, 2, 96, 16, True),
                                  (1, 2, 1, 75, 32, False)])
def test_rounding_model_off_is_the_plain_arithmetic_bitwise(case, dt):
    B, Hq, Hkv, S, D, causal = case
    q, k, v, do = (torch.tensor(a).to(dt)
                   for a in _inputs(B, Hq, Hkv, S, D, seed=7))
    want_o, want_lse, want_g = _plain_before_rounding(q, k, v, do, causal, 32)
    for kw in ({}, {"round_operands": False}):
        o, lse = tfa_kernel.flash_attention_fwd_lse_plain(
            q, k, v, causal=causal, block_q=32, block_k=32, **kw)
        assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
        grads = tfa_kernel.flash_attention_bwd_heads_plain(
            q, k, v, o, lse, do, causal=causal, block_q=32, block_k=32, **kw)
        assert all(torch.equal(g, w) for g, w in zip(grads, want_g))


def _trunc_bf16(x):
    """x rounded toward zero to bf16 (a systematic bias of one rounding)."""
    return (x.float().contiguous().view(torch.int32) & -65536).view(
        torch.float32)


def _dense_bf16(q, k, v, causal, convert):
    """Attention with p and o converted to bf16 by ``convert``: the
    library's rounding when it rounds to nearest."""
    S, D = q.shape[2:]
    group = q.shape[1] // k.shape[1]
    kf, vf = (t.float().repeat_interleave(group, 1) for t in (k, v))
    s = q.float() @ kf.transpose(-1, -2) / D ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = convert(p) @ vf / p.sum(-1, keepdim=True)
    return convert(o).to(torch.bfloat16)


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


@pytest.mark.parametrize("seed", [0, 1])
def test_lib_gate_passes_the_library_error_and_refuses_faults(seed):
    cs = _chip_smoke()
    (q, k, v, _), _ = _bf16(_inputs(2, 4, 2, 128, 32, seed=seed))
    exact = cs.attention_f64(q, k, v, True)["o"]
    lib = _dense_bf16(q, k, v, True, _round_bf16)
    # an output whose error equals the library stand-in's, and the rounding
    # model at the kernel's 64 × 64 tiles
    errs = cs.lib_gate("same error", lib.clone(), lib, exact)
    assert errs["max_err"] == errs["lib_max_err"] > 0
    model = tfa_kernel.flash_attention_plain(q, k, v, block_q=64, block_k=64,
                                             round_operands=True)
    cs.lib_gate("rounding model", model, lib, exact)
    faults = {
        "swapped KV head": tfa_kernel.flash_attention_plain(
            q, k.flip(1), v.flip(1), round_operands=True),
        "one-tile shift": tfa_kernel.flash_attention_plain(
            q, k.roll(64, dims=2), v.roll(64, dims=2), round_operands=True),
        "truncating bias": _dense_bf16(q, k, v, True, _trunc_bf16),
    }
    for name, got in faults.items():
        with pytest.raises(RuntimeError, match="check failed"):
            cs.lib_gate(name, got, lib, exact)


def test_lib_gate_refuses_non_finite_shape_and_dtype():
    cs = _chip_smoke()
    (q, k, v, _), _ = _bf16(_inputs(1, 2, 1, 64, 16, seed=3))
    exact = cs.attention_f64(q, k, v, False)["o"]
    lib = _dense_bf16(q, k, v, False, _round_bf16)
    bad = lib.clone()
    bad[0, 0, 0, 0] = float("nan")
    for got in (bad, lib.float(), lib[..., :8]):
        with pytest.raises(RuntimeError, match="check failed"):
            cs.lib_gate("bad", got, lib, exact)


def test_attention_f64_matches_dense_autograd():
    """The gate's float64 reference: o, lse, and dq, dk, dv with dk, dv
    summed over each KV head's group, against autograd through the dense
    oracle in float64."""
    cs = _chip_smoke()
    q, k, v, do = (torch.tensor(a).double()
                   for a in _inputs(2, 4, 2, 40, 16, seed=5))
    got = cs.attention_f64(q, k, v, True, do)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    kx, vx = (t.repeat_interleave(2, dim=1) for t in (kg, vg))
    s = qg @ kx.transpose(-1, -2) / 4.0
    s = s.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(),
                      float("-inf"))
    o = torch.softmax(s, -1) @ vx
    want = dict(zip(("dq", "dk", "dv"),
                    torch.autograd.grad(o, (qg, kg, vg), do)))
    want.update(o=o, lse=torch.logsumexp(s, -1))
    for name, w in want.items():
        torch.testing.assert_close(got[name], w.detach(), rtol=1e-12,
                                   atol=1e-12)
