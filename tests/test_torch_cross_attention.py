"""PyTorch port, cross attention (Sk ≠ Sq) and bidirectional attention in
the three flash-attention kernels' plain versions, against the JAX package
on the same numpy inputs:

* the forward and the forward with lse at Sk ≠ Sq, both orders, head dims
  16, 64, 112 and 160, GQA, against the reference's pure-JAX
  ``_chunked_attention`` (the only form of cross attention it has: its
  Pallas kernel takes one S), the dense ``mha_ref`` and a dense
  logsumexp, within ``FWD_ATOL``; at Sq = Sk, bidirectional, against the
  reference's Pallas kernel in interpret mode; the CPU wrappers run the
  plain versions and launch nothing;
* the backward at Sk ≠ Sq against torch autograd of ``mha_ref`` and the
  vjp of ``_chunked_attention``, and ``layers.attention_forward`` with
  ``kv_override`` (and bidirectional) on every route against the
  reference's, its gradients against ``jax.grad``, within ``GRAD_ATOL``;
* the bf16 rounding model (``round_operands``) at Sk ≠ Sq within the bf16
  gate of the float64 function;
* causal attention with Sk ≠ Sq refused by every entry point.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.models import layers as jL
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.models import layers as tL

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
BF16_GATE = 2e-2           # the reference's bf16 gate
ROUTES = ("kernels", "train", "plain")
# (B, Hq, Hkv, Sq, Sk, D, chunk of the reference, which divides Sq and Sk):
# fewer and more keys than queries, GQA groups of 1, 2 and 4, every head
# dim class the kernels instantiate
CROSS_CASES = [(1, 4, 2, 24, 40, 16, 8), (2, 4, 4, 48, 16, 16, 16),
               (1, 8, 2, 16, 64, 64, 16), (1, 2, 1, 40, 24, 64, 8),
               (1, 4, 2, 8, 24, 112, 8), (1, 4, 2, 32, 16, 160, 16)]


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(B, Hq, Hkv, Sq, Sk, D, seed=0):
    return (torch.from_numpy(_np(seed, B, Hq, Sq, D)),
            torch.from_numpy(_np(seed + 1, B, Hkv, Sk, D)),
            torch.from_numpy(_np(seed + 2, B, Hkv, Sk, D)))


def _reference(q, k, v, chunk):
    """The reference's ``_chunked_attention(causal=False)`` in its (B, S,
    H, D) layout, KV expanded to the query heads as its
    ``attention_forward`` does: (f, its inputs)."""
    group = q.shape[1] // k.shape[1]

    def bshd(t):
        return jnp.asarray(t.numpy()).transpose(0, 2, 1, 3)

    def f(qj, kj, vj):
        o = jL._chunked_attention(qj, jnp.repeat(kj, group, axis=2),
                                  jnp.repeat(vj, group, axis=2),
                                  causal=False, chunk=chunk)
        return o.transpose(0, 2, 1, 3)

    return f, (bshd(q), bshd(k), bshd(v))


def _dense_lse(q, k):
    kk = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return torch.logsumexp(q @ kk.transpose(-1, -2) / q.shape[3] ** 0.5,
                           dim=-1)


@pytest.mark.parametrize("case", CROSS_CASES)
def test_cross_forward_matches_reference_chunked_attention(case):
    B, Hq, Hkv, Sq, Sk, D, chunk = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, D)
    f, jin = _reference(q, k, v, chunk)
    want = np.asarray(f(*jin))
    got = fk.flash_attention_plain(q, k, v, causal=False, block_q=16,
                                   block_k=8)
    assert got.shape == (B, Hq, Sq, D)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)
    o, lse = fk.flash_attention_fwd_lse_plain(q, k, v, causal=False)
    assert lse.shape == (B, Hq, Sq)
    np.testing.assert_allclose(o.numpy(), want, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _dense_lse(q, k).numpy(),
                               atol=FWD_ATOL, rtol=FWD_ATOL)
    np.testing.assert_allclose(mha_ref(q, k, v, causal=False).numpy(), want,
                               atol=FWD_ATOL, rtol=0)
    # the wrappers run the plain versions on a CPU tensor, launching nothing
    before = (fk.flash_attention.launches, fk.flash_attention_fwd_lse.launches)
    assert torch.equal(fops.attention(q, k, v, causal=False), o)
    assert all(torch.equal(a, b) for a, b in zip(
        fk.flash_attention_fwd_lse(q, k, v, causal=False), (o, lse)))
    assert (fk.flash_attention.launches,
            fk.flash_attention_fwd_lse.launches) == before


@pytest.mark.parametrize("S,D", [(64, 16), (128, 64), (64, 112), (64, 160)])
def test_bidirectional_plain_matches_pallas_interpret_at_sq_eq_sk(S, D):
    """At Sq = Sk the reference's Pallas kernel takes bidirectional
    attention; the port's plain version (cross attention's code path with
    Sk = Sq) equals it in interpret mode."""
    q, k, v = _qkv(1, 4, 2, S, S, D, seed=7)
    want = jfa_kernel.flash_attention(q.numpy(), k.numpy(), v.numpy(),
                                      causal=False, block_q=64, block_k=64,
                                      interpret=True)
    got = fk.flash_attention_plain(q, k, v, causal=False, block_q=64,
                                   block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL,
                               rtol=0)


# fewer keys than queries and more, each under GQA, at the smallest and
# the largest head dim
@pytest.mark.parametrize("case", [CROSS_CASES[i] for i in (0, 5)])
def test_cross_backward_matches_autograd_and_jax_vjp(case):
    B, Hq, Hkv, Sq, Sk, D, chunk = case
    q, k, v = _qkv(B, Hq, Hkv, Sq, Sk, D, seed=3)
    do = torch.from_numpy(_np(9, B, Hq, Sq, D))
    o, lse = fk.flash_attention_fwd_lse_plain(q, k, v, causal=False)
    dq, dk, dv = fk.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                              causal=False, block_q=16,
                                              block_k=8)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(mha_ref(*leaves, causal=False), leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=name)
    f, jin = _reference(q, k, v, chunk)
    _, vjp = jax.vjp(f, *jin)
    for name, g, jg in zip(("dq", "dk", "dv"), (dq, dk, dv),
                           vjp(jnp.asarray(do.numpy()))):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(jg).transpose(0, 2, 1, 3),
                                   atol=GRAD_ATOL, rtol=GRAD_ATOL,
                                   err_msg=name)
    # the autograd Function carries Sk through to the backward
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fops.attention_train(*leaves, causal=False)
    got = torch.autograd.grad(out, leaves, do)
    assert torch.equal(out.detach(), o)
    for g, w in zip(got, fk.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      causal=False)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("Sq,Sk", [(37, 200), (333, 129)])
def test_rounding_model_at_odd_lengths_within_the_bf16_gate(Sq, Sk):
    """chip_smoke.py's odd pairs at small heads: the bf16 kernels'
    rounding model (p and ds rounded before their products) stays within
    the reference's bf16 gate of the float64 function, o and the three
    gradients."""
    q, k, v = (t.bfloat16() for t in _qkv(1, 2, 1, Sq, Sk, 64, seed=11))
    do = torch.from_numpy(_np(12, 1, 2, Sq, 64)).bfloat16()
    o, lse = fk.flash_attention_fwd_lse_plain(
        q, k, v, causal=False, block_q=64, block_k=64, round_operands=True)
    grads = fk.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=False, block_q=64, block_k=64,
        round_operands=True)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    exact = mha_ref(*leaves, causal=False)
    want = torch.autograd.grad(exact, leaves, do.double())
    for name, g, w in zip(("o", "dq", "dk", "dv"), (o, *grads),
                          (exact.detach(), *want)):
        np.testing.assert_allclose(g.double().numpy(), w.numpy(),
                                   atol=BF16_GATE, rtol=BF16_GATE,
                                   err_msg=name)


def _attn_params(seed=1, d=32, heads=4, kv=2, dh=8):
    jp = {"wq": _np(seed, d, heads * dh) / 6, "wk": _np(seed + 1, d, kv * dh)
          / 6, "wv": _np(seed + 2, d, kv * dh) / 6,
          "wo": _np(seed + 3, heads * dh, d) / 6}
    return jp, {n: torch.from_numpy(w) for n, w in jp.items()}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("use_rope", [False, True])
def test_attention_forward_cross_and_bidirectional_match_reference(
        route, use_rope):
    """``kv_override`` (Sq = 12 text rows over Sk = 20 memory rows, no
    RoPE on the memory) and bidirectional self-attention on every route
    against the reference's ``attention_forward``."""
    jp, tp = _attn_params()
    jpj = {n: jnp.asarray(w) for n, w in jp.items()}
    x, mem = _np(5, 2, 12, 32), _np(6, 2, 20, 32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy()
    kw = dict(n_heads=4, n_kv=2, d_head=8, rope_theta=1e4)
    mk, mv = jL.project_kv(jpj, jnp.asarray(mem), None, n_kv=2, d_head=8,
                           rope_theta=1e4, use_rope=False)
    want = jL.attention_forward(jpj, jnp.asarray(x), jnp.asarray(pos),
                                causal=False, chunk=4, use_rope=use_rope,
                                kv_override=(mk, mv), **kw)
    tk, tv = tL.project_kv(tp, torch.from_numpy(mem), None, n_kv=2,
                           d_head=8, rope_theta=1e4, use_rope=False)
    got = tL.attention_forward(tp, torch.from_numpy(x), torch.from_numpy(pos),
                               causal=False, use_rope=use_rope,
                               kv_override=(tk, tv), route=route, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=0)
    want = jL.attention_forward(jpj, jnp.asarray(x), jnp.asarray(pos),
                                causal=False, chunk=4, use_rope=use_rope,
                                **kw)
    got = tL.attention_forward(tp, torch.from_numpy(x), torch.from_numpy(pos),
                               causal=False, use_rope=use_rope, route=route,
                               **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=0)


def test_cross_attention_gradients_match_jax_grad():
    """The "train" route's gradients of a cross-attention block (the
    query input, the memory and the four projections) against
    ``jax.grad`` of the reference's ``attention_forward(kv_override=...)``
    with the memory projected by ``project_kv``."""
    jp, _ = _attn_params(seed=21)
    x, mem, g = _np(25, 2, 12, 32), _np(26, 2, 20, 32), _np(27, 2, 12, 32)
    kw = dict(n_heads=4, n_kv=2, d_head=8, rope_theta=1e4)

    def jloss(p, xx, mm):
        mk, mv = jL.project_kv(p, mm, None, n_kv=2, d_head=8,
                               rope_theta=1e4, use_rope=False)
        o = jL.attention_forward(p, xx, None, causal=False, chunk=4,
                                 use_rope=False, kv_override=(mk, mv), **kw)
        return jnp.sum(o * g)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        {n: jnp.asarray(w) for n, w in jp.items()}, jnp.asarray(x),
        jnp.asarray(mem))
    tp = {n: torch.from_numpy(w).requires_grad_(True) for n, w in jp.items()}
    tx, tm = (torch.from_numpy(a).requires_grad_(True) for a in (x, mem))
    tk, tv = tL.project_kv(tp, tm, None, n_kv=2, d_head=8, rope_theta=1e4,
                           use_rope=False)
    o = tL.attention_forward(tp, tx, None, causal=False, use_rope=False,
                             kv_override=(tk, tv), route="train", **kw)
    leaves = [tp[n] for n in jp] + [tx, tm]
    got = torch.autograd.grad((o * torch.from_numpy(g)).sum(), leaves)
    want = [jgrads[0][n] for n in jp] + [jgrads[1], jgrads[2]]
    for name, a, b in zip(list(jp) + ["x", "memory"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=name)


def test_causal_attention_with_sk_ne_sq_is_refused():
    q, k, v = _qkv(1, 2, 1, 8, 12, 16)
    o, lse = fk.flash_attention_fwd_lse_plain(q, k, v, causal=False)
    calls = [lambda: fk.flash_attention(q, k, v),
             lambda: fk.flash_attention_plain(q, k, v),
             lambda: fk.flash_attention_fwd_lse(q, k, v),
             lambda: fk.flash_attention_fwd_lse_plain(q, k, v),
             lambda: fk.flash_attention_bwd(q, k, v, o, lse, o),
             lambda: fk.flash_attention_bwd_plain(q, k, v, o, lse, o),
             lambda: fk.flash_attention_bwd_heads_plain(q, k, v, o, lse, o),
             lambda: fops.attention(q, k, v),
             lambda: fops.attention_train(q, k, v)]
    for call in calls:
        with pytest.raises(ValueError, match="causal attention needs"):
            call()
    # other mismatches still raise: batch, head dim, a window without
    # causal attention
    for bad in (torch.zeros(2, 1, 12, 16), torch.zeros(1, 1, 12, 8)):
        with pytest.raises(ValueError, match="does not match"):
            fk.flash_attention(q, bad, bad, causal=False)
    with pytest.raises(ValueError, match="window"):
        fk.flash_attention(q, k, v, causal=False, window=4)
