"""PyTorch port, head dims above 256 in the three flash-attention kernels
(``csrc/flash_attention_wide.cu`` on the card, the plain versions here)
against the JAX package on the same numpy inputs:

* ``flash_attention``, ``flash_attention_fwd_lse`` and
  ``flash_attention_bwd`` (their plain versions, which the wrappers run on
  a CPU tensor) at D = 257, 288, 300, 320, 512, 640 and 1024 (257 and 300
  leave rows that are not 16-byte aligned; above 512 the kernels cut o
  and dq into pieces) against the reference's Pallas
  kernels in interpret mode, causal and bidirectional, GQA, fp32: o, lse,
  dq, dk and dv within 1e-5; at Sk ≠ Sq (the reference's Pallas kernels
  take one length) against its ``_chunked_attention`` with keys of
  another length and ``jax.vjp`` of it, o within 1e-5 and the gradients
  within its fp32 ``GRAD_ATOL``;
* with a sliding window against ``_chunked_attention(window=...)`` and
  ``jax.vjp`` of it (o within 1e-5, gradients within ``GRAD_ATOL``);
* the bf16 wide forward's rounding model (``round_operands=True`` at the
  kernel's 64 × 64 tiles: p rounded to bf16 before p·v, l summing the
  unrounded p) at D = 288, 300 and 320 against the reference in bf16: the
  Pallas forward in interpret mode causal and, for cross attention (Sq 8
  over Sk 24), on q padded to Sk rows (bidirectional rows are
  independent); ``_chunked_attention(window=...)`` for a window (the
  Pallas kernels take none); o within the reference's bf16 ``FWD_ATOL``
  5e-2, lse within 1e-5 (fp32, never rounded);
* the bf16 wide backward's rounding model (``round_operands=True`` at
  the kernels' 64 × 64 tiles: p and the unscaled ds rounded to bf16
  before their products, the scale on the sums of dq and dk) at D = 288,
  300 and 320 against the reference in bf16: its Pallas backward in
  interpret mode on its own (o, lse), causal and, for cross attention, on
  q and dO padded to Sk rows; ``jax.vjp`` of ``_chunked_attention(window=
  ...)`` for a window; dq, dk and dv within the reference's bf16
  ``GRAD_ATOL`` 2e-2;
* the wrappers' routes on a stand-in library: above 256 each wrapper
  reaches the wide entry point once, at D itself with no pad, and counts
  one launch — in bf16 the forwards ``flash_attention_wide_fwd_tc`` with
  ``wide_fwd_geometry(D)`` and the backward ``flash_attention_wide_bwd_tc``
  with ``wide_bwd_geometry(D)``, in fp32 ``flash_attention_wide_fwd`` and
  ``flash_attention_wide_bwd`` with dtype code 0 and
  ``wide_f32_fwd_geometry(D)``, ``wide_f32_bwd_geometry(D)``; at D ≤ 256
  the entry points and head dims of before;
* granite-3-2b's smoke config with ``d_head`` 320: prefill logits within
  the reference's 2e-4 and the loss and whole-tree gradients within
  ``GRAD_ATOL`` of ``jax.value_and_grad``, on the reference's weights
  carried across by ``convert.lm_params_from_jax``;
* a dry run of that config's training step and prefill on fake tensors:
  each flash-attention kernel's calls equal to the calls that reach its
  wrapper in a real run of the same step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tck
from repro_torch.data import synthetic as tsynthetic
from repro_torch.kernels import cudalib
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch import dryrun
from repro_torch.models import lm as tlm
from repro_torch.runtime import train_loop

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
LOGIT_GATE = 2e-4          # tests/test_models.py:79-86
WIDE_DIMS = (257, 288, 300, 320, 512)
# above 512 the fp32 and bf16 kernels cut o and dq into pieces
PIECED_DIMS = (640, 1024)
# (B, Hq, Hkv, S, causal): GQA groups of 2 and 1, both masks
CASES = [(1, 4, 2, 24, True), (2, 2, 1, 16, False)]
# (B, Hq, Hkv, Sq, Sk, chunk of the reference): fewer and more keys
CROSS_CASES = [(1, 4, 2, 8, 24, 8), (1, 2, 1, 16, 8, 8)]
# (B, Hq, Hkv, S, window, chunk of the reference)
WINDOW_CASES = [(1, 4, 2, 24, 8, 8), (1, 2, 1, 20, 7, 4)]
D_HEAD = 320


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _arrays(B, Hq, Hkv, Sq, Sk, D, seed=0):
    return (_np(seed, B, Hq, Sq, D), _np(seed + 1, B, Hkv, Sk, D),
            _np(seed + 2, B, Hkv, Sk, D), _np(seed + 3, B, Hq, Sq, D))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("D", WIDE_DIMS + PIECED_DIMS)
@pytest.mark.parametrize("case", CASES)
def test_plain_versions_vs_pallas_at_wide_head_dims(case, D):
    B, Hq, Hkv, S, causal = case
    arrays = _arrays(B, Hq, Hkv, S, S, D)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    jkw = dict(causal=causal, block_q=8, block_k=8, interpret=True)
    before = (fk.flash_attention.launches, fk.flash_attention_fwd_lse.launches,
              fk.flash_attention_bwd.launches)
    o, lse = fk.flash_attention_fwd_lse(q, k, v, causal=causal)
    jo, jlse = jfa_kernel.flash_attention_fwd_lse(jq, jk, jv, **jkw)
    _close(o, jo, FWD_ATOL)
    _close(lse, jlse, FWD_ATOL)
    _close(fk.flash_attention(q, k, v, causal=causal),
           jfa_kernel.flash_attention(jq, jk, jv, **jkw), FWD_ATOL)
    grads = fk.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = jfa_kernel.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, **jkw)
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        _close(got, w, FWD_ATOL)
    # on the CPU the wrappers ran their plain versions, launching nothing
    assert (fk.flash_attention.launches, fk.flash_attention_fwd_lse.launches,
            fk.flash_attention_bwd.launches) == before


def _chunked(group, chunk, causal, window=None):
    """The reference's ``_chunked_attention`` in the port's (B, H, S, D)
    layout, KV expanded to the query heads as its ``attention_forward``
    does."""
    def f(qj, kj, vj):
        t = lambda a: a.transpose(0, 2, 1, 3)
        o = jL._chunked_attention(t(qj), jnp.repeat(t(kj), group, axis=2),
                                  jnp.repeat(t(vj), group, axis=2),
                                  causal=causal, chunk=chunk, window=window)
        return t(o)
    return f


def _check_against_chunked(arrays, f, **kw):
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays[:3]))
    _close(fk.flash_attention(q, k, v, **kw), want, FWD_ATOL)
    o, lse = fk.flash_attention_fwd_lse(q, k, v, **kw)
    _close(o, want, FWD_ATOL)
    grads = fk.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for got, want_g in zip(grads, vjp(jnp.asarray(arrays[3]))):
        assert got.shape == want_g.shape
        _close(got, want_g, GRAD_ATOL)
    return q, k, lse


@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("case", CROSS_CASES)
def test_cross_attention_vs_reference_at_wide_head_dims(case, D):
    B, Hq, Hkv, Sq, Sk, chunk = case
    arrays = _arrays(B, Hq, Hkv, Sq, Sk, D, seed=5)
    q, k, lse = _check_against_chunked(
        arrays, _chunked(Hq // Hkv, chunk, False), causal=False)
    kk = k.repeat_interleave(Hq // Hkv, dim=1)
    dense = torch.logsumexp(q @ kk.transpose(-1, -2) / D ** 0.5, dim=-1)
    _close(lse, dense.numpy(), FWD_ATOL)


@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windowed_kernels_vs_reference_at_wide_head_dims(case, D):
    B, Hq, Hkv, S, window, chunk = case
    arrays = _arrays(B, Hq, Hkv, S, S, D, seed=3)
    _check_against_chunked(arrays,
                           _chunked(Hq // Hkv, chunk, True, window),
                           causal=True, window=window)


BF16_FWD_ATOL = 5e-2       # tests/_gradcheck.py FWD_ATOL["bf16"]
LSE_ATOL = 1e-5            # lse is fp32 and never rounded
ROUNDING_DIMS = (288, 300, 320)


def _bf16(*arrays):
    """The arrays as bf16 tensors and, with the same values, as bf16 JAX
    arrays."""
    ts = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    return ts, tuple(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                     for t in ts)


def _rounding_model(q, k, v, **kw):
    return fk.flash_attention_fwd_lse_plain(q, k, v, block_q=64, block_k=64,
                                            round_operands=True, **kw)


@pytest.mark.parametrize("D", ROUNDING_DIMS)
def test_bf16_rounding_model_vs_pallas_causal_at_wide_head_dims(D):
    B, Hq, Hkv, S = 1, 4, 2, 24
    (q, k, v), (jq, jk, jv) = _bf16(*_arrays(B, Hq, Hkv, S, S, D, seed=7)[:3])
    o, lse = _rounding_model(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    jo, jlse = jfa_kernel.flash_attention_fwd_lse(
        jq, jk, jv, causal=True, block_q=8, block_k=8, interpret=True)
    _close(o, np.asarray(jo.astype(jnp.float32)), BF16_FWD_ATOL)
    _close(lse, jlse, LSE_ATOL)


@pytest.mark.parametrize("D", ROUNDING_DIMS)
def test_bf16_rounding_model_vs_pallas_cross_at_wide_head_dims(D):
    """Sq = 8 rows over Sk = 24 keys: the Pallas kernel takes one length,
    so it runs on q padded with zero rows to 24, and its first 8 rows are
    the cross attention's (each bidirectional row sees every key alone)."""
    B, Hq, Hkv, Sq, Sk = 1, 4, 2, 8, 24
    (q, k, v), (_, jk, jv) = _bf16(*_arrays(B, Hq, Hkv, Sq, Sk, D,
                                            seed=9)[:3])
    o, lse = _rounding_model(q, k, v, causal=False)
    q_pad = torch.cat([q, torch.zeros(B, Hq, Sk - Sq, D,
                                      dtype=torch.bfloat16)], dim=2)
    jq_pad = jnp.asarray(q_pad.float().numpy()).astype(jnp.bfloat16)
    jo, jlse = jfa_kernel.flash_attention_fwd_lse(
        jq_pad, jk, jv, causal=False, block_q=8, block_k=8, interpret=True)
    _close(o, np.asarray(jo.astype(jnp.float32))[:, :, :Sq], BF16_FWD_ATOL)
    _close(lse, np.asarray(jlse)[:, :, :Sq], LSE_ATOL)


@pytest.mark.parametrize("D", ROUNDING_DIMS)
def test_bf16_rounding_model_vs_reference_windowed_at_wide_head_dims(D):
    """A window of 8 over S = 24: o against the reference's
    ``_chunked_attention(window=...)`` in bf16, lse against the band-masked
    logsumexp of the same bf16 values in float64."""
    B, Hq, Hkv, S, window = 1, 4, 2, 24, 8
    (q, k, v), (jq, jk, jv) = _bf16(*_arrays(B, Hq, Hkv, S, S, D,
                                             seed=11)[:3])
    o, lse = _rounding_model(q, k, v, causal=True, window=window)
    want = _chunked(Hq // Hkv, 8, True, window)(jq, jk, jv)
    _close(o, np.asarray(want.astype(jnp.float32)), BF16_FWD_ATOL)
    qd, kd = (t.double() for t in (q, k))
    kd = kd.repeat_interleave(Hq // Hkv, dim=1)
    s = qd @ kd.transpose(-1, -2) / D ** 0.5
    rows, cols = torch.arange(S)[:, None], torch.arange(S)[None, :]
    s = s.masked_fill((cols > rows) | (cols <= rows - window),
                      float("-inf"))
    _close(lse, torch.logsumexp(s, dim=-1).numpy(), LSE_ATOL)


GRAD_BF16_ATOL = 2e-2      # tests/_gradcheck.py GRAD_ATOL["bf16"]


def _bwd_rounding_model(q, k, v, o, lse, do, **kw):
    return fk.flash_attention_bwd_plain(q, k, v, o, lse, do, block_q=64,
                                        block_k=64, round_operands=True,
                                        **kw)


def _f32(x) -> np.ndarray:
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _grads_close(grads, want, refs):
    for got, w, ref in zip(grads, want, refs):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        _close(got, _f32(w), GRAD_BF16_ATOL)


@pytest.mark.parametrize("D", ROUNDING_DIMS)
def test_bf16_bwd_rounding_model_vs_pallas_causal(D):
    """The bf16 wide backward's rounding model (p and the unscaled ds
    rounded to bf16 before their products, the scale on the sums of dq
    and dk, at the kernels' 64 × 64 tiles) on the reference's own (o,
    lse), against its Pallas backward in interpret mode in bf16."""
    B, Hq, Hkv, S = 1, 4, 2, 24
    (q, k, v, do), (jq, jk, jv, jdo) = _bf16(*_arrays(B, Hq, Hkv, S, S, D,
                                                      seed=13))
    jkw = dict(causal=True, block_q=8, block_k=8, interpret=True)
    jo, jlse = jfa_kernel.flash_attention_fwd_lse(jq, jk, jv, **jkw)
    o = torch.from_numpy(_f32(jo)).to(torch.bfloat16)
    grads = _bwd_rounding_model(q, k, v, o, torch.from_numpy(_f32(jlse)),
                                do, causal=True)
    _grads_close(grads, jfa_kernel.flash_attention_bwd(
        jq, jk, jv, jo, jlse, jdo, **jkw), (q, k, v))


@pytest.mark.parametrize("D", ROUNDING_DIMS)
def test_bf16_bwd_rounding_model_vs_pallas_cross(D):
    """Sq = 8 rows over Sk = 24 keys: the Pallas kernels take one length,
    so they run on q and dO padded with zero rows to 24.  Bidirectional
    rows are independent, and a zero dO row adds nothing to dk or dv (its
    dp and delta are 0), so dq's first 8 rows, dk and dv are the cross
    attention's."""
    B, Hq, Hkv, Sq, Sk = 1, 4, 2, 8, 24
    (q, k, v, do), (_, jk, jv, _) = _bf16(*_arrays(B, Hq, Hkv, Sq, Sk, D,
                                                   seed=15))
    zeros = torch.zeros(B, Hq, Sk - Sq, D, dtype=torch.bfloat16)
    jq_pad, jdo_pad = (jnp.asarray(torch.cat([t, zeros], dim=2).float()
                                   .numpy()).astype(jnp.bfloat16)
                       for t in (q, do))
    jkw = dict(causal=False, block_q=8, block_k=8, interpret=True)
    jo, jlse = jfa_kernel.flash_attention_fwd_lse(jq_pad, jk, jv, **jkw)
    o = torch.from_numpy(_f32(jo)[:, :, :Sq]).to(torch.bfloat16)
    grads = _bwd_rounding_model(q, k, v, o,
                                torch.from_numpy(_f32(jlse)[:, :, :Sq]), do,
                                causal=False)
    jdq, jdk, jdv = jfa_kernel.flash_attention_bwd(jq_pad, jk, jv, jo, jlse,
                                                   jdo_pad, **jkw)
    _grads_close(grads, (jdq[:, :, :Sq], jdk, jdv), (q, k, v))


@pytest.mark.parametrize("D", ROUNDING_DIMS)
def test_bf16_bwd_rounding_model_vs_reference_windowed(D):
    """A window of 8 over S = 24 (the Pallas kernels take none): the
    rounding model on its own forward's (o, lse) against ``jax.vjp`` of
    the reference's ``_chunked_attention(window=...)`` on the same bf16
    values in fp32."""
    B, Hq, Hkv, S, window = 1, 4, 2, 24, 8
    (q, k, v, do), _ = _bf16(*_arrays(B, Hq, Hkv, S, S, D, seed=17))
    o, lse = _rounding_model(q, k, v, causal=True, window=window)
    grads = _bwd_rounding_model(q, k, v, o, lse, do, causal=True,
                                window=window)
    _, vjp = jax.vjp(_chunked(Hq // Hkv, 8, True, window),
                     *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    _grads_close(grads, vjp(jnp.asarray(do.float().numpy())), (q, k, v))


class _Library:
    """Stands in for the CUDA library: records each entry point's name and
    arguments and the tensors behind its pointers."""

    def __init__(self):
        self.tensors, self.calls = {}, []

    def ptr(self, t):
        if t is None:
            return None
        self.tensors[t.data_ptr()] = t
        return t.data_ptr()

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture()
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(fk, "plain_mode", lambda t: False)
    monkeypatch.setattr(cudalib, "ptr", lib.ptr)
    monkeypatch.setattr(cudalib, "stream", lambda device: 0)
    monkeypatch.setattr(cudalib, "build", lambda: lib)
    monkeypatch.setattr(cudalib, "check", lambda err: None)
    return lib


# D -> (entry point prefix, the head dim the entry point is given)
ROUTES = {64: ("flash_attention", 64), 96: ("flash_attention", 112),
          256: ("flash_attention", 256), 257: ("flash_attention_wide", 257),
          320: ("flash_attention_wide", 320),
          513: ("flash_attention_wide", 513)}


@pytest.mark.parametrize("D", sorted(ROUTES))
def test_wrappers_route_by_head_dim(library, D):
    q, k, v, do = (torch.from_numpy(a)
                   for a in _arrays(1, 4, 2, 40, 40, D))
    before = (fk.flash_attention.launches,
              fk.flash_attention_fwd_lse.launches,
              fk.flash_attention_bwd.launches)
    o = fk.flash_attention(q, k, v)
    o2, lse = fk.flash_attention_fwd_lse(q, k, v)
    dq, dk, dv = fk.flash_attention_bwd(q, k, v, o2, lse, do)
    prefix, d_arg = ROUTES[D]
    assert [f for f, _ in library.calls] == [
        f"{prefix}_fwd", f"{prefix}_fwd", f"{prefix}_bwd"]
    for f, args in library.calls:
        i = 15 if f.endswith("bwd") else 11        # D, then the scale
        assert args[i] == d_arg and args[i + 1] == pytest.approx(D ** -0.5)
        assert library.tensors[args[0]].shape[-1] == d_arg
    assert o.shape == o2.shape == dq.shape == q.shape
    assert dk.shape == dv.shape == k.shape and lse.shape == (1, 4, 40)
    assert (fk.flash_attention.launches, fk.flash_attention_fwd_lse.launches,
            fk.flash_attention_bwd.launches) == tuple(b + 1 for b in before)
    assert fk.kernel_head_dim(D) == d_arg
    # a zero-size input launches nothing, as at every head dim
    library.calls.clear()
    empty = torch.zeros(1, 4, 0, D)
    assert fk.flash_attention(empty, empty[:, :2], empty[:, :2]).shape == \
        empty.shape
    assert library.calls == []


WIDE_ROUTE_DIMS = (257, 300, 320, 513, 1024)


@pytest.mark.parametrize("D", WIDE_ROUTE_DIMS)
def test_bf16_wide_forward_passes_its_geometry(library, D):
    """bf16 above 256: both forwards reach the tensor-core entry point with
    the sizes and ``wide_fwd_geometry(D)``, the backward its tensor-core
    entry point with ``wide_bwd_geometry(D)``; fp32 reaches
    ``flash_attention_wide_fwd`` with ``wide_f32_fwd_geometry(D)``."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _arrays(1, 4, 2, 40, 40, D))
    o = fk.flash_attention(q, k, v)
    o2, lse = fk.flash_attention_fwd_lse(q, k, v)
    fk.flash_attention_bwd(q, k, v, o2, lse, do)
    fk.flash_attention(q.float(), k.float(), v.float())
    assert [f for f, _ in library.calls] == [
        "flash_attention_wide_fwd_tc", "flash_attention_wide_fwd_tc",
        "flash_attention_wide_bwd_tc", "flash_attention_wide_fwd"]
    (_, a1), (_, a2), (_, a3), (_, a4) = library.calls
    for args in (a1, a2):
        assert args[5:11] == (1, 4, 2, 40, 40, D)
        assert args[11] == pytest.approx(D ** -0.5)
        assert args[12:14] == (1, 0)                  # causal, no window
        assert args[14:18] == tuple(fk.wide_fwd_geometry(D))
        assert library.tensors[args[3]].dtype == torch.bfloat16
    assert a1[4] is None and library.tensors[a2[4]] is lse
    assert a3[9:15] == (1, 4, 2, 40, 40, D)           # the tc entry's sizes
    assert a3[18:26] == tuple(fk.wide_bwd_geometry(D))
    assert a4[5] == 0                                 # fp32's dtype code
    assert a4[6:12] == (1, 4, 2, 40, 40, D) and a4[13:15] == (1, 0)
    assert a4[15:19] == tuple(fk.wide_f32_fwd_geometry(D)) and len(a4) == 20
    assert o.shape == q.shape and lse.shape == (1, 4, 40)


@pytest.mark.parametrize("D", WIDE_ROUTE_DIMS)
def test_wide_backward_routes_by_dtype(library, D):
    """The backward above 256: bf16 reaches ``flash_attention_wide_bwd_tc``
    once with the sizes, the scale, the mask and ``wide_bwd_geometry(D)``,
    dq, dk_h and dv_h in bf16 (dk and dv per query head, summed outside);
    fp32 reaches ``flash_attention_wide_bwd`` with dtype code 0 and
    ``wide_f32_bwd_geometry(D)``.  Each wrapper call counts one launch."""
    B, Hq, Hkv, Sq, Sk = 2, 4, 2, 24, 40
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _arrays(B, Hq, Hkv, Sq, Sk, D))
    lse = torch.zeros(B, Hq, Sq)
    before = fk.flash_attention_bwd.launches
    dq, dk, dv = fk.flash_attention_bwd(q, k, v, q, lse, do, causal=False)
    fk.flash_attention_bwd(*(t.float() for t in (q, k, v, q)), lse,
                           do.float(), causal=False)
    assert fk.flash_attention_bwd.launches == before + 2
    (f1, a1), (f2, a2) = library.calls
    assert (f1, f2) == ("flash_attention_wide_bwd_tc",
                        "flash_attention_wide_bwd")
    assert a1[9:15] == (B, Hq, Hkv, Sq, Sk, D)
    assert a1[15] == pytest.approx(D ** -0.5) and a1[16:18] == (0, 0)
    g = fk.wide_bwd_geometry(D)
    assert a1[18:26] == tuple(g) and len(a1) == 27
    assert g.dq_pieces == (1 if D <= 512 else 2)
    assert g.dkv_pieces <= -(-D // 256)
    assert library.tensors[a1[4]] is lse
    for i, shape in ((6, (B, Hq, Sq, D)), (7, (B, Hq, Sk, D)),
                     (8, (B, Hq, Sk, D))):
        t = library.tensors[a1[i]]
        assert tuple(t.shape) == shape and t.dtype == torch.bfloat16
    assert a2[9] == 0 and a2[10:16] == (B, Hq, Hkv, Sq, Sk, D)
    assert a2[16] == pytest.approx(D ** -0.5) and a2[17:19] == (0, 0)
    g32 = fk.wide_f32_bwd_geometry(D)
    assert a2[19:23] == tuple(g32) and len(a2) == 24
    assert g32.pieces == (1 if D <= 512 else 2)
    assert library.tensors[a2[6]].dtype == torch.float32
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert dk.dtype == dv.dtype == torch.bfloat16


def _configs(remat=False):
    """granite-3-2b's smoke config, both packages, with ``d_head`` 320
    (the ``ArchConfig`` field qwen3-moe sets away from d_model / H)."""
    jcfg = jconfigs.get_smoke_config("granite-3-2b")
    jcfg = type(jcfg)(**{**jcfg.__dict__, "d_head": D_HEAD, "remat": remat})
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("granite-3-2b"),
                               d_head=D_HEAD, remat=remat)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def wide_model():
    jcfg, _ = _configs()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(4))
    return jparams, jax.tree.map(np.asarray, jparams)


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_wide_head_lm_prefill_vs_reference(wide_model):
    jparams, params_np = wide_model
    jcfg, tcfg = _configs()
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 14),
                                             dtype=np.int32)
    tparams = convert.lm_params_from_jax(params_np, tcfg, device="cpu")
    assert tparams["layers"]["attn"]["wq"].shape[-1] == \
        tcfg.n_heads * D_HEAD
    with torch.no_grad():
        lg, _ = tlm.prefill(tparams, tcfg, {"tokens": toks}, max_len=16)
    jlg, _ = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                         max_len=16)
    np.testing.assert_allclose(lg.float().numpy(), np.asarray(jlg),
                               atol=LOGIT_GATE, rtol=LOGIT_GATE)


@pytest.mark.parametrize("remat", [False, True])
def test_wide_head_lm_gradients_vs_reference(wide_model, remat):
    _, params_np = wide_model
    jcfg, tcfg = _configs(remat)
    batch = tsynthetic.SyntheticLMDataset(vocab=tcfg.vocab,
                                          seq_len=12).batch(0, 2)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True)(
        jax.tree.map(jnp.asarray, params_np), batch)
    tparams = convert.lm_params_from_jax(params_np, tcfg, device="cpu")
    leaves = {k: p.requires_grad_(True)
              for k, p in tck.flatten(tparams).items()}
    loss, _ = tlm.loss_fn(tparams, tcfg, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               atol=GRAD_ATOL, rtol=GRAD_ATOL)
    want = _flat_jax(jgrads)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=k)


def _counted(monkeypatch) -> dict:
    """Count the calls that reach each flash-attention wrapper through the
    entry points the models use (``kernels.flash_attention.ops``)."""
    calls = {}
    for name in ("flash_attention", "flash_attention_fwd_lse",
                 "flash_attention_bwd"):
        fn = getattr(fops, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kw)
        monkeypatch.setattr(fops, name, counted)
    return calls


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dry_run_of_wide_head_config_counts_the_real_calls(monkeypatch,
                                                           kind):
    _, tcfg = _configs(remat=True)
    shape = tconfigs.ShapeCell(f"wide_{kind}", 16, 2, kind)
    pred = dryrun.analyze_step(tcfg, shape, device="cpu")
    dry = {k: v["calls"] for k, v in pred["ops"]["kernels"].items()}
    calls = _counted(monkeypatch)
    batch = {k: torch.zeros(s, dtype=torch.int32)
             for k, (s, _) in tconfigs.input_specs(tcfg, shape).items()}
    if kind == "train":
        params, opt = train_loop.init_train_state(tcfg, seed=0, device="cpu")
        train_loop.make_train_step(tcfg)(params, opt, batch)
        assert set(dry) == {"flash_attention_fwd_lse", "flash_attention_bwd"}
    else:
        params = tlm.init_params(tcfg, seed=0, device="cpu")
        with torch.no_grad():
            tlm.prefill(params, tcfg, batch, max_len=16)
        assert set(dry) == {"flash_attention"}
    assert dry == calls
    assert pred["ops"]["flops"] > 0
