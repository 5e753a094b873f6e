"""PyTorch port, sliding-window attention and the rolling decode cache
(mixtral-8x7b) against the JAX package on the same numpy inputs:

* the flash-attention plain versions with ``window`` — the forward, the
  forward with lse and the backward — against the reference's pure-JAX
  ``_chunked_attention(window=...)`` (and ``jax.grad`` of it) and an
  autograd band ``mha_ref``, within ``FWD_ATOL`` / ``GRAD_ATOL``; a
  window of S or more gives the causal result bitwise; a window on
  bidirectional attention raises;
* ``layers.attention_forward(window=...)`` on every route against the
  reference's;
* mixtral-8x7b's smoke config: ``prefill`` and ``decode_step`` logits
  against the reference's where the reference is right (a prompt no
  longer than the window, and one a multiple of it), and, for a 40-token
  prompt under a 32-token window, against a full windowed forward over
  the same tokens, where the reference's rolling cache holds the wrong
  positions (its decode is off by tenths of max|logit| there); prefill
  puts position p in slot ``p % window``; ``generate`` past the window
  equals the reference's; the serving CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.runtime import serve_loop as jserve
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import mha_ref
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.runtime import serve_loop as tserve
from repro_torch.runtime.wave_serve import ServeConfig

CPU = "cpu"
ARCH = "mixtral-8x7b"
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
# (B, Hq, Hkv, S, D, window, chunk of the reference): windows below, at and
# past one block of the plain versions, S not a multiple of the block
ATTN_CASES = [(1, 4, 2, 64, 16, 16, 16), (2, 4, 1, 48, 8, 7, 8),
              (1, 2, 2, 40, 16, 32, 8), (1, 6, 3, 33, 8, 1, 11),
              (1, 4, 2, 96, 16, 40, 32)]
ROUTES = ("kernels", "train", "plain")


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(B, Hq, Hkv, S, D, seed=0):
    return (torch.from_numpy(_np(seed, B, Hq, S, D)),
            torch.from_numpy(_np(seed + 1, B, Hkv, S, D)),
            torch.from_numpy(_np(seed + 2, B, Hkv, S, D)))


def _reference_attention(q, k, v, window, chunk):
    """The reference's ``_chunked_attention`` in its (B, S, H, D) layout,
    KV expanded to the query heads as its ``attention_forward`` does."""
    group = q.shape[1] // k.shape[1]

    def bshd(t, rep=1):
        return jnp.repeat(jnp.asarray(t.numpy()).transpose(0, 2, 1, 3), rep,
                          axis=2)

    def f(qj, kj, vj):
        o = jL._chunked_attention(qj, jnp.repeat(kj, group, axis=2),
                                  jnp.repeat(vj, group, axis=2), causal=True,
                                  chunk=chunk, window=window)
        return o.transpose(0, 2, 1, 3)

    return f, (bshd(q), bshd(k), bshd(v))


def _band_lse(q, k, window):
    B, Hq, S, D = q.shape
    kk = k.repeat_interleave(Hq // k.shape[1], dim=1)
    s = q @ kk.transpose(-1, -2) / D ** 0.5
    keep = torch.ones(S, S, dtype=torch.bool).tril().triu(1 - window)
    return torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)


# ---------------------------------------------------------------------------
# the windowed flash-attention plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ATTN_CASES)
def test_windowed_forward_matches_reference_chunked_attention(case):
    B, Hq, Hkv, S, D, window, chunk = case
    q, k, v = _qkv(B, Hq, Hkv, S, D)
    f, jin = _reference_attention(q, k, v, window, chunk)
    want = np.asarray(f(*jin))
    got = fk.flash_attention_plain(q, k, v, window=window, block_q=16,
                                   block_k=16)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)
    o, lse = fk.flash_attention_fwd_lse_plain(q, k, v, window=window)
    np.testing.assert_allclose(o.numpy(), want, atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _band_lse(q, k, window).numpy(),
                               atol=FWD_ATOL, rtol=FWD_ATOL)
    np.testing.assert_allclose(mha_ref(q, k, v, window=window).numpy(), want,
                               atol=FWD_ATOL, rtol=0)
    # the wrappers run the plain versions on a CPU tensor, launching nothing
    before = fk.flash_attention.launches
    assert torch.equal(fk.flash_attention(q, k, v, window=window),
                       fk.flash_attention_plain(q, k, v, window=window))
    assert torch.equal(fops.attention(q, k, v, window=window),
                       fk.flash_attention_plain(q, k, v, window=window))
    assert fk.flash_attention.launches == before


@pytest.mark.parametrize("case", ATTN_CASES)
def test_windowed_backward_matches_autograd_and_jax_grad(case):
    B, Hq, Hkv, S, D, window, chunk = case
    q, k, v = _qkv(B, Hq, Hkv, S, D, seed=3)
    do = torch.from_numpy(_np(9, B, Hq, S, D))
    o, lse = fk.flash_attention_fwd_lse_plain(q, k, v, window=window)
    dq, dk, dv = fk.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                              window=window, block_q=16,
                                              block_k=32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(mha_ref(*leaves, window=window), leaves, do)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=name)
    # the vjp of the reference's chunked attention (its KV gradients summed
    # over each group by the transpose of the head repeat)
    f, jin = _reference_attention(q, k, v, window, chunk)
    jdo = jnp.asarray(do.numpy())
    _, vjp = jax.vjp(f, *jin)
    for name, g, jg in zip(("dq", "dk", "dv"), (dq, dk, dv), vjp(jdo)):
        jg = np.asarray(jg).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(g.numpy(), jg, atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=name)
    # the autograd Function over both carries the window
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fops.attention_train(*leaves, window=window)
    got = torch.autograd.grad(out, leaves, do)
    assert torch.equal(out.detach(), o)
    for g, w in zip(got, fk.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      window=window)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("S,extra", [(40, 0), (40, 3), (33, 200)])
def test_window_of_s_or_more_is_causal_bitwise(S, extra):
    q, k, v = _qkv(2, 4, 2, S, 16, seed=5)
    do = torch.from_numpy(_np(6, 2, 4, S, 16))
    w = S + extra
    assert torch.equal(fk.flash_attention(q, k, v, window=w),
                       fk.flash_attention(q, k, v))
    o, lse = fk.flash_attention_fwd_lse(q, k, v)
    ow, lsew = fk.flash_attention_fwd_lse(q, k, v, window=w)
    assert torch.equal(o, ow) and torch.equal(lse, lsew)
    for a, b in zip(fk.flash_attention_bwd(q, k, v, o, lse, do),
                    fk.flash_attention_bwd(q, k, v, o, lse, do, window=w)):
        assert torch.equal(a, b)
    for ro in (False, True):     # the bf16 rounding model too
        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        assert torch.equal(
            fk.flash_attention_plain(qb, kb, vb, round_operands=ro),
            fk.flash_attention_plain(qb, kb, vb, round_operands=ro,
                                     window=w))


def test_window_needs_causal_attention():
    q, k, v = _qkv(1, 2, 1, 8, 8)
    o, lse = fk.flash_attention_fwd_lse(q, k, v)
    for call in (lambda: fk.flash_attention(q, k, v, causal=False, window=4),
                 lambda: fk.flash_attention_fwd_lse(q, k, v, causal=False,
                                                    window=4),
                 lambda: fk.flash_attention_bwd(q, k, v, o, lse, o,
                                                causal=False, window=4),
                 lambda: mha_ref(q, k, v, causal=False, window=4),
                 lambda: fk.flash_attention(q, k, v, window=0)):
        with pytest.raises(ValueError, match="window"):
            call()


@pytest.mark.parametrize("route", ROUTES)
def test_attention_forward_with_window_matches_reference(route):
    jp = {"wq": _np(1, 32, 32) / 6, "wk": _np(2, 32, 16) / 6,
          "wv": _np(3, 32, 16) / 6, "wo": _np(4, 32, 32) / 6}
    tp = {name: torch.from_numpy(w) for name, w in jp.items()}
    x = _np(5, 2, 24, 32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    want = jL.attention_forward(
        {n: jnp.asarray(w) for n, w in jp.items()}, jnp.asarray(x),
        jnp.asarray(pos), n_heads=4, n_kv=2, d_head=8, rope_theta=1e4,
        window=10, chunk=8)
    got = tL.attention_forward(tp, torch.from_numpy(x), torch.from_numpy(
        pos.copy()), n_heads=4, n_kv=2, d_head=8, rope_theta=1e4, window=10,
        route=route)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# mixtral-8x7b: prefill, the rolling cache and decode
# ---------------------------------------------------------------------------

def _smoke(capacity_factor=None, attn_chunk=32):
    """(reference config, port config): mixtral's smoke config with the
    reference's attention chunk set (it must divide the prompt) and,
    where given, the capacity factor (n_experts / top_k keeps every
    token, so only the window can differ between two token counts)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    jcfg = type(jcfg)(**{**jcfg.__dict__, "attn_chunk": attn_chunk})
    if capacity_factor is not None:
        jcfg = type(jcfg)(**{**jcfg.__dict__, "moe": jcfg.moe._replace(
            capacity_factor=capacity_factor)})
        tcfg = type(tcfg)(**{**tcfg.__dict__, "moe": tcfg.moe._replace(
            capacity_factor=capacity_factor)})
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    """The reference's mixtral smoke weights (numpy), drawn once."""
    jcfg, _ = _smoke()
    return jax.tree.map(np.asarray,
                        jlm.init_params(jcfg, jax.random.PRNGKey(0)))


def _tokens(n, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, S),
                                                dtype=np.int32)


def _greedy(prefill, step, toks, steps):
    """Prefill ``toks`` then ``steps`` greedy decode steps; the logits of
    the prefill and of each step, and the tokens fed."""
    logits, state = prefill(toks)
    out, fed = [np.asarray(logits)], []
    for _ in range(steps):
        nxt = np.asarray(np.argmax(np.asarray(logits), -1), np.int32)[:, None]
        fed.append(nxt)
        logits, state = step(state, nxt)
        out.append(np.asarray(logits))
    return out, np.concatenate([toks] + fed, axis=1)


def _port_greedy(tparams, tcfg, toks, steps, max_len):
    with torch.inference_mode():
        out, seq = _greedy(
            lambda t: tlm.prefill(tparams, tcfg,
                                  {"tokens": torch.from_numpy(t)}, max_len),
            lambda st, t: tlm.decode_step(tparams, tcfg, st,
                                          torch.from_numpy(t)),
            toks, steps)
    return out, seq


@pytest.mark.parametrize("S,chunk", [(24, 8), (32, 32), (64, 32)])
def test_prefill_and_decode_match_reference_where_it_is_right(weights, S,
                                                              chunk):
    """S <= window, or S a multiple of the window: the reference's rolling
    cache holds the right positions, and the port's logits equal its."""
    jcfg, tcfg = _smoke(attn_chunk=chunk)
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    jparams = jax.tree.map(jnp.asarray, weights)
    toks = _tokens(2, S)
    max_len = S + 6
    want, jseq = _greedy(
        lambda t: jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(t)},
                              max_len),
        lambda st, t: jlm.decode_step(jparams, jcfg, st, jnp.asarray(t)),
        toks, 6)
    got, seq = _port_greedy(tparams, tcfg, toks, 6, max_len)
    np.testing.assert_array_equal(seq, jseq)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=FWD_ATOL, rtol=0)


def test_rolling_cache_after_a_prompt_longer_than_the_window(weights):
    """A 40-token prompt under a 32-token window: each of 8 decode steps'
    logits equal the last row of a full windowed forward over the same
    tokens, the port's and the reference's (whose full forward is right);
    the reference's own decode, which keeps the last 32 positions in
    slots 0..31, is off there by tenths of max|logit|."""
    S, steps = 40, 8
    jcfg, tcfg = _smoke(capacity_factor=2.0, attn_chunk=8)
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    jparams = jax.tree.map(jnp.asarray, weights)
    toks = _tokens(2, S, seed=3)
    got, seq = _port_greedy(tparams, tcfg, toks, steps, S + steps)
    with torch.inference_mode():
        full, _ = tlm.forward_train(tparams, tcfg,
                                    {"tokens": torch.from_numpy(seq)})
    jfull, _ = jlm.forward_train(jparams, jcfg, {"tokens": jnp.asarray(seq)})
    jfull = np.asarray(jfull)
    scale = float(np.abs(jfull).max())
    for j, g in enumerate(got):
        at = S - 1 + j
        np.testing.assert_allclose(g, full[:, at].numpy(),
                                   atol=FWD_ATOL * scale, rtol=0)
        np.testing.assert_allclose(g, jfull[:, at], atol=FWD_ATOL * scale,
                                   rtol=0)
    # the reference's decode on the same tokens: wrong from the first step
    jst = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                      S + steps)[1]
    jlog, _ = jlm.decode_step(jparams, jcfg, jst, jnp.asarray(seq[:, S:S + 1]))
    assert np.abs(np.asarray(jlog) - jfull[:, S]).max() > 0.1 * scale


def test_prefill_puts_position_p_in_slot_p_mod_window(weights):
    _, tcfg = _smoke()
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    S, W = 45, tcfg.sliding_window
    toks = torch.from_numpy(_tokens(1, S, seed=4))
    with torch.inference_mode():
        _, state = tlm.prefill(tparams, tcfg, {"tokens": toks}, S + 4)
        x, positions = tlm._embed_inputs(tparams, tcfg, {"tokens": toks})
        lp = tlm.layer(tparams["layers"], 0)
        k, v = tL.project_kv(lp["attn"], tL.apply_norm(
            lp["attn_norm"], x, tcfg.norm_type), positions, n_kv=tcfg.n_kv,
            d_head=tcfg.d_head, rope_theta=tcfg.rope_theta)
    ck, cv = state.kv
    assert ck.shape[2] == W and int(state.pos[0]) == S
    for p in range(S - W, S):
        assert torch.equal(ck[0, :, p % W], k[:, p])
        assert torch.equal(cv[0, :, p % W], v[:, p])


def test_generate_past_the_window_matches_reference(weights):
    """A 16-token prompt and 24 generated tokens: the cache is the 32-slot
    window, which wraps during decode (the reference is right here: its
    prompt is shorter than the window)."""
    jcfg, tcfg = _smoke(attn_chunk=16)
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    toks = _tokens(3, 16, seed=5)
    out, stats = tserve.generate(tparams, tcfg, {"tokens": toks}, 24)
    jout, jstats = jserve.generate(jax.tree.map(jnp.asarray, weights), jcfg,
                                   {"tokens": jnp.asarray(toks)}, 24)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert stats.steps == jstats.steps
    assert tlm._cache_len(tcfg, 40) == 32
    adapter = tserve.LMDecodeAdapter(tparams, tcfg, prompt_len=16,
                                     max_new_tokens=24)
    scfg = ServeConfig(microbatch=3, n_micro=1, pipeline=None)
    wave = adapter.make_wave_fn(scfg)(adapter.pack(list(toks), scfg))
    np.testing.assert_array_equal(np.stack(adapter.unpack(wave, 3)),
                                  out.numpy())


def test_mixtral_configs_match_reference_and_serve_cli(capsys):
    jcfg, tcfg = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    for f in ("name", "family", "n_layers", "d_model", "vocab", "n_heads",
              "n_kv", "d_head", "rope_theta", "sliding_window",
              "block_kind"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tuple(tcfg.moe) == tuple(jcfg.moe)
    assert tcfg.param_count() == jcfg.param_count() == 46_702_792_704
    js, ts = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    assert tuple(ts.moe) == tuple(js.moe)
    assert ts.sliding_window == js.sliding_window == 32
    out = tserve_cli.main(["--arch", ARCH, "--smoke", "--prompt-len", "40",
                           "--gen", "8", "--requests", "4", "--device",
                           "cpu"])
    assert out["tokens"] == 32
    assert "served 4 requests" in capsys.readouterr().out
