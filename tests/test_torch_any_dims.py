"""PyTorch port: the routes that let the flash-attention kernels take any
head dim up to 256 and the selective scan any state size, against the JAX
package's Pallas kernels (interpret mode) on the same numpy inputs.

* ``forward_padded`` / ``backward_padded`` around the plain versions at
  D = 48, 80 and 96 (zero-padded to 64, 112 and 112): o, lse, dq, dk and
  dv within 1e-5 of the reference's kernels at the unpadded D, causal and
  bidirectional (the reference's kernels take one length);
* ``scan_padded`` around the plain version at N = 2 and 12 (zero-padded
  to 4 and 16) and 48 (chunks of 32 and 16): y and h_T within 1e-5 of the
  reference's kernel and its oracle; in bf16, y within one bf16 ulp of
  the plain version at N;
* the wrappers' routes on a stand-in library: D = 96 reaches the C
  interface as 112 and comes back 96 wide, D = 320 reaches the wide
  kernels' entry points at 320, unpadded; N = 12 launches once at 16,
  N = 48 twice (32 and 16) with D added once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.kernels.ssm_scan import kernel as jss_kernel
from repro.kernels.ssm_scan import ref as jss_ref
from repro_torch.kernels import cudalib
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.ssm_scan import kernel as sk

TOL = 1e-5
# (B, Hq, Hkv, Sq, Sk, causal)
ATTN_CASES = [(1, 4, 2, 40, 40, True), (2, 2, 1, 24, 24, False)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _attn_arrays(B, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hq, Sq, D)).astype(np.float32))


@pytest.mark.parametrize("D", (48, 80, 96))
@pytest.mark.parametrize("case", ATTN_CASES)
def test_padded_attention_route_vs_pallas(case, D):
    B, Hq, Hkv, Sq, Sk, causal = case
    arrays = _attn_arrays(B, Hq, Hkv, Sq, Sk, D)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    jkw = dict(causal=causal, block_q=8, block_k=8, interpret=True)
    padded = []

    def fwd(q, k, v, scale):
        padded.append(q.shape[-1])
        return fk.flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                                scale=scale)

    def bwd(q, k, v, o, lse, do, scale):
        padded.append(q.shape[-1])
        return fk.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal, scale=scale)

    o, lse = fk.forward_padded(fwd, q, k, v)
    assert o.shape == q.shape and o.is_contiguous()
    jo, jlse = jfa_kernel.flash_attention_fwd_lse(jq, jk, jv, **jkw)
    _close(o, jo)
    _close(lse, jlse)
    _close(fk.forward_padded(fwd, q, k, v)[0],
           jfa_kernel.flash_attention(jq, jk, jv, **jkw))
    grads = fk.backward_padded(bwd, q, k, v, o, lse, do)
    want = jfa_kernel.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, **jkw)
    for got, w in zip(grads, want):
        assert got.shape == w.shape
        _close(got, w)
    assert padded == [fk.kernel_head_dim(D)] * 3
    assert fk.kernel_head_dim(D) in fk.HEAD_DIMS and \
        fk.kernel_head_dim(D) > D


def _scan_arrays(B, T, Din, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Din)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, Din)))).astype(
        np.float32) * 0.5
    A = -np.abs(rng.standard_normal((Din, N))).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    Dv = rng.standard_normal((Din,)).astype(np.float32)
    return x, dt, A, Bm, Cm, Dv


def _plain(calls):
    def callee(x, dt, A, B, C, D, h0):
        calls.append((A.shape[1], x.dtype))
        return sk.selective_scan_plain(x, dt, A, B, C, D, chunk=8, h0=h0)
    return callee


@pytest.mark.parametrize("N", (2, 12, 48))
def test_scan_route_vs_pallas(N):
    arrays = _scan_arrays(2, 16, 8, N)
    calls = []
    y, h_T = sk.scan_padded(_plain(calls),
                            *(torch.from_numpy(a) for a in arrays))
    assert y.shape == (2, 16, 8) and h_T.shape == (2, 8, N)
    _close(y, jss_kernel.selective_scan(*(jnp.asarray(a) for a in arrays),
                                        chunk=8))
    want_y, want_h = jss_ref.selective_scan_ref(
        *(jnp.asarray(a) for a in arrays))
    _close(y, want_y)
    _close(h_T, want_h)
    assert [n for n, _ in calls] == sk.launch_state_dims(N) == \
        {2: [4], 12: [16], 48: [32, 16]}[N]
    if N > 32:      # chunks run in fp32 without D; the sum adds D once
        assert all(dt == torch.float32 for _, dt in calls)


@pytest.mark.parametrize("N", (12, 48))
def test_scan_route_bf16_within_one_ulp(N):
    x, dt, A, Bm, Cm, Dv = (torch.from_numpy(a)
                            for a in _scan_arrays(2, 16, 8, N, seed=2))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    h0 = torch.randn(2, 8, N, generator=torch.Generator().manual_seed(0))
    y, h_T = sk.scan_padded(_plain([]), x, dt, A, Bm, Cm, Dv, h0)
    want_y, want_h = sk.selective_scan_plain(x, dt, A, Bm, Cm, Dv, chunk=8,
                                             h0=h0)
    assert y.dtype == torch.bfloat16
    ulp = torch.finfo(torch.bfloat16).eps * want_y.float().abs().clamp(
        min=torch.finfo(torch.bfloat16).tiny)
    assert bool(((y.float() - want_y.float()).abs() <= ulp).all())
    torch.testing.assert_close(h_T, want_h, rtol=TOL, atol=TOL)


class _Library:
    """Stands in for the CUDA library: records each entry point's
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
    for mod in (fk, sk):
        monkeypatch.setattr(mod, "plain_mode", lambda t: False)
    monkeypatch.setattr(cudalib, "ptr", lib.ptr)
    monkeypatch.setattr(cudalib, "stream", lambda device: 0)
    monkeypatch.setattr(cudalib, "build", lambda: lib)
    monkeypatch.setattr(cudalib, "check", lambda err: None)
    return lib


def test_attention_wrappers_pad_d96_to_112(library):
    q, k, v, do = (torch.from_numpy(a)
                   for a in _attn_arrays(1, 4, 2, 40, 40, 96))
    before = (fk.flash_attention.launches,
              fk.flash_attention_fwd_lse.launches,
              fk.flash_attention_bwd.launches)
    o = fk.flash_attention(q, k, v)
    o2, lse = fk.flash_attention_fwd_lse(q, k, v)
    dq, dk, dv = fk.flash_attention_bwd(q, k, v, o2, lse, do)
    (f1, a1), (f2, a2), (f3, a3) = library.calls
    assert (f1, f2, f3) == ("flash_attention_fwd", "flash_attention_fwd",
                            "flash_attention_bwd")
    for args in (a1, a2):
        assert args[11] == 112 and args[12] == pytest.approx(96 ** -0.5)
        assert library.tensors[args[0]].shape[-1] == 112
    assert a3[15] == 112 and a3[16] == pytest.approx(96 ** -0.5)
    assert o.shape == o2.shape == dq.shape == q.shape
    assert dk.shape == dv.shape == k.shape and lse.shape == (1, 4, 40)
    assert (fk.flash_attention.launches, fk.flash_attention_fwd_lse.launches,
            fk.flash_attention_bwd.launches) == tuple(b + 1 for b in before)
    library.calls.clear()
    q320 = torch.zeros(1, 2, 8, 320)
    fk.flash_attention(q320, q320, q320)
    o320, lse320 = fk.flash_attention_fwd_lse(q320, q320, q320)
    fk.flash_attention_bwd(q320, q320, q320, o320, lse320, q320)
    assert [f for f, _ in library.calls] == [
        "flash_attention_wide_fwd", "flash_attention_wide_fwd",
        "flash_attention_wide_bwd"]
    for f, args in library.calls:
        d_arg = args[15] if f.endswith("bwd") else args[11]
        assert d_arg == 320 and library.tensors[args[0]].shape[-1] == 320


def test_scan_wrapper_pads_and_chunks_states(library):
    for N, launched in ((12, [16]), (48, [32, 16])):
        library.calls.clear()
        x, dt, A, Bm, Cm, Dv = (torch.from_numpy(a)
                                for a in _scan_arrays(1, 8, 64, N))
        before = sk.selective_scan.launches
        y, h_T = sk.selective_scan(x, dt, A, Bm, Cm, Dv, chunk=8)
        assert [args[13] for _, args in library.calls] == launched
        assert sk.selective_scan.launches == before + len(launched)
        assert y.shape == x.shape and h_T.shape == (1, 64, N)
