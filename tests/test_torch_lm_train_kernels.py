"""PyTorch port, the LM training kernels (``flash_attention_fwd_lse`` and
``flash_attention_bwd`` in ``repro_torch.kernels.flash_attention``) and
``ops.attention_train`` against the JAX package's, on the same numpy
inputs.

On the CPU each wrapper runs its plain version, so these hold the plain
versions to the reference's Pallas kernels in interpret mode and to the
dense oracle, at the reference's gates (``tests/test_kernels.py``'s
``BWD_CASES`` and its lse test; ``tests/_gradcheck.py``'s ``GRAD_ATOL``):
o and lse within 1e-5, dq, dk and dv within 1e-4 in fp32 and 2e-2 in bf16;
``attention_train`` under autograd within the reference's 2e-4 of the
dense oracle's gradients and of the reference's own ``attention_train``.
Beyond the reference: any S (the ragged last block), the fixed-order group
sum after the per-head rounding, the wrappers' CPU path, launch counters
and argument checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.kernels.flash_attention import ops as jfa_ops
from repro_torch.kernels.flash_attention import kernel as tfa_kernel
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.kernels.flash_attention import ref as tfa_ref

# the reference's cases (tests/test_kernels.py:641-646)
BWD_CASES = [
    # (B, Hq, Hkv, S, D, causal)
    (1, 2, 2, 64, 16, True),
    (2, 4, 2, 64, 16, True),      # GQA group=2 (dk/dv group-sum)
    (1, 8, 2, 64, 32, True),      # GQA group=4
    (1, 2, 1, 128, 32, False),    # bidirectional
]
ODD_CASES = [(1, 4, 2, 37, 16, True), (2, 2, 1, 45, 32, False)]
FWD_GATE = 1e-5
GRAD_ATOL = {"fp32": 1e-4, "bf16": 2e-2}     # tests/_gradcheck.py:24
VJP_GATE = 2e-4                   # tests/test_kernels.py:667-668
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(B, Hq, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hq, S, D)).astype(np.float32))


def _np(t):
    return np.asarray(t.detach().float() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


def _close(got, want, tol, rtol=None):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol,
                               rtol=tol if rtol is None else rtol)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_fwd_lse_and_bwd_plain_vs_pallas(case, dt):
    B, Hq, Hkv, S, D, causal = case
    tdt, jdt = DTYPES[dt]
    arrays = _inputs(B, Hq, Hkv, S, D)
    q, k, v, do = (torch.tensor(a).to(tdt) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in arrays)
    block = jfa_ops._block(S)
    jkw = dict(causal=causal, block_q=block, block_k=block, interpret=True)
    o, lse = tfa_kernel.flash_attention_fwd_lse(q, k, v, causal=causal)
    jo, jlse = jfa_kernel.flash_attention_fwd_lse(jq, jk, jv, **jkw)
    assert o.dtype == tdt and lse.dtype == torch.float32
    _close(lse, jlse, FWD_GATE)
    _close(o, jo, FWD_GATE if dt == "fp32" else GRAD_ATOL[dt])
    # the backward on the same (o, lse): the reference's own forward output
    jo_t = torch.tensor(np.asarray(jo.astype(jnp.float32))).to(tdt)
    grads = tfa_kernel.flash_attention_bwd(
        q, k, v, jo_t, torch.tensor(np.asarray(jlse)), do, causal=causal)
    jgrads = jfa_kernel.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, **jkw)
    for name, g, jg, ref in zip(("dq", "dk", "dv"), grads, jgrads, (q, k, v)):
        assert g.shape == ref.shape and g.dtype == tdt, name
        _close(g, jg, GRAD_ATOL[dt])


@pytest.mark.parametrize("case", BWD_CASES + ODD_CASES)
def test_attention_train_matches_dense_autograd(case):
    """o, dq, dk, dv of ``attention_train`` against autograd through the
    dense oracle (the reference's test), and on the reference's cases
    against the reference's ``attention_train`` (its custom_vjp over the
    Pallas kernels in interpret mode)."""
    B, Hq, Hkv, S, D, causal = case
    arrays = _inputs(B, Hq, Hkv, S, D, seed=1)
    q, k, v = (torch.tensor(a, requires_grad=True) for a in arrays[:3])
    do = torch.tensor(arrays[3])
    o = tfa_ops.attention_train(q, k, v, causal)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    qr, kr, vr = (torch.tensor(a, requires_grad=True) for a in arrays[:3])
    o_r = tfa_ref.mha_ref(qr, kr, vr, causal=causal)
    want = (o_r,) + torch.autograd.grad(o_r, (qr, kr, vr), do)
    for got, w in zip((o, dq, dk, dv), want):
        _close(got, w, VJP_GATE)
    if case in BWD_CASES:
        o_j, vjp = jax.vjp(lambda a, b, c: jfa_ops.attention_train(
            a, b, c, causal), *map(jnp.asarray, arrays[:3]))
        jgrads = vjp(jnp.asarray(arrays[3]))
        for got, w in zip((o, dq, dk, dv), (o_j,) + tuple(jgrads)):
            _close(got, w, VJP_GATE)


def test_lse_matches_dense():
    """The reference's ``test_flash_attention_lse_matches_dense``, with the
    plain version's blocks at its 32 × 32 and at the default."""
    q, k, v, _ = _inputs(1, 2, 2, 64, 16, seed=2)
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / 16 ** 0.5
    logits = np.where(np.tril(np.ones((64, 64), bool)), logits, -np.inf)
    want = jax.nn.logsumexp(jnp.asarray(logits), axis=-1)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    for blocks in ({"block_q": 32, "block_k": 32}, {}):
        _, lse = tfa_kernel.flash_attention_fwd_lse_plain(tq, tk, tv,
                                                          **blocks)
        _close(lse, want, FWD_GATE)


@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 32), (16, 64), (128, 128)])
def test_bwd_plain_block_sweep_and_ragged_edge(bq, bk):
    """Any blocks and any S give the same gradients (to round-off): the
    plain version's blocks are not part of the function."""
    q, k, v, do = map(torch.tensor, _inputs(1, 4, 2, 75, 16, seed=3))
    o, lse = tfa_kernel.flash_attention_fwd_lse_plain(q, k, v)
    want = tfa_kernel.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                block_q=75, block_k=75)
    got = tfa_kernel.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                               block_q=bq, block_k=bk)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_group_sum_rounds_per_head_then_sums_in_order():
    """dk, dv in bf16: each query head's value is rounded to bf16 first,
    then the group is summed in fp32 in head order and rounded once — the
    reference's order (``dk_h ... .sum(2).astype(k.dtype)``)."""
    q, k, v, do = (torch.tensor(a).to(torch.bfloat16)
                   for a in _inputs(1, 4, 1, 40, 16, seed=4))
    o, lse = tfa_kernel.flash_attention_fwd_lse(q, k, v)
    dq, dk_h, dv_h = tfa_kernel.flash_attention_bwd_heads_plain(
        q, k, v, o, lse, do)
    assert dk_h.dtype == torch.bfloat16 and dk_h.shape == q.shape
    _, dk, dv = tfa_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    want = ((dk_h[:, 0].float() + dk_h[:, 1].float()) + dk_h[:, 2].float()
            + dk_h[:, 3].float()).to(torch.bfloat16)[:, None]
    assert torch.equal(dk, want)
    assert torch.equal(dv, tfa_kernel.group_sum(dv_h, 1, torch.bfloat16))
    # delta is fp32 Σ_D o·dO, outside the kernels
    assert torch.equal(tfa_kernel.bwd_delta(o, do),
                       (o.float() * do.float()).sum(-1))


def test_training_wrappers_cpu_path_counters_and_checks():
    q, k, v, do = map(torch.tensor, _inputs(1, 4, 2, 24, 16, seed=5))
    before = (tfa_kernel.flash_attention_fwd_lse.launches,
              tfa_kernel.flash_attention_bwd.launches)
    o, lse = tfa_kernel.flash_attention_fwd_lse(q, k, v)
    po, plse = tfa_kernel.flash_attention_fwd_lse_plain(q, k, v)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert torch.equal(o, tfa_kernel.flash_attention(q, k, v))
    got = tfa_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    want = tfa_kernel.flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tfa_kernel.flash_attention_fwd_lse.launches,
            tfa_kernel.flash_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="lse must be"):
        tfa_kernel.flash_attention_bwd(q, k, v, o, lse[..., 1:], do)
    with pytest.raises(ValueError, match="do must be"):
        tfa_kernel.flash_attention_bwd(q, k, v, o, lse, do[:, :2])
    with pytest.raises(ValueError, match="not a multiple"):
        tfa_kernel.flash_attention_fwd_lse(q, k[:, :1].expand(1, 3, 24, 16),
                                           v[:, :1].expand(1, 3, 24, 16))
    # a meta tensor takes the fake route (the dry run's): shapes, no launch
    meta = tfa_kernel.flash_attention_bwd(*(t.to("meta") for t in
                                            (q, k, v, o, lse, do)))
    assert all(m.is_meta and m.shape == w.shape for m, w in zip(meta, want))
    assert (tfa_kernel.flash_attention_fwd_lse.launches,
            tfa_kernel.flash_attention_bwd.launches) == before
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="attention_train"):
        tfa_kernel.flash_attention_fwd_lse(q, k, v)
