"""PyTorch port, the LM stack's two kernels (``repro_torch.kernels.
flash_attention`` and ``repro_torch.kernels.ssm_scan``) against the JAX
package's on the same numpy inputs.

On the CPU each wrapper runs its plain version, so these hold the plain
versions to the reference's Pallas kernels in interpret mode and to its
oracles, at the reference's own gates (``tests/test_kernels.py``): flash
attention fp32 1e-4 and bf16 2e-2 (``FLASH_CASES``, the block sweep and
the dtypes test), the selective scan 1e-4 (``SSM_CASES``).  Beyond the
reference: any S (the ragged last block), the scan's final state and its
initial state ``h0`` against ``selective_scan_ref``, the wrappers' CPU path
and launch counters, the forward wrappers' refusal to record a gradient,
and ``ops.attention_train``'s gradients (the training kernels' own tests
are ``tests/test_torch_lm_train_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.ssm_scan import kernel as jss_kernel
from repro.kernels.ssm_scan import ops as jss_ops
from repro.kernels.ssm_scan import ref as jss_ref
from repro_torch.kernels.flash_attention import kernel as tfa_kernel
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.kernels.flash_attention import ref as tfa_ref
from repro_torch.kernels.ssm_scan import kernel as tss_kernel
from repro_torch.kernels.ssm_scan import ops as tss_ops
from repro_torch.kernels.ssm_scan import ref as tss_ref

# the reference's cases (tests/test_kernels.py:602-608, 700-706)
FLASH_CASES = [
    # (B, Hq, Hkv, S, D, causal)
    (1, 2, 2, 128, 32, True),
    (2, 4, 2, 128, 64, True),       # GQA group=2
    (1, 8, 2, 256, 64, True),       # GQA group=4
    (2, 2, 2, 128, 32, False),      # bidirectional
    (1, 2, 1, 64, 128, True),       # small S < block
]
SSM_CASES = [
    # (B, T, Din, N, chunk)
    (1, 64, 16, 8, 16),
    (2, 128, 32, 16, 32),
    (2, 64, 8, 4, 64),      # chunk == T
    (1, 96, 16, 8, 32),     # T = 3 chunks
]
GATE = {"fp32": 1e-4, "bf16": 2e-2}
# the reference's scan oracle, jitted once (op by op it dispatches hundreds
# of small XLA calls per shape)
_jscan_ref = jax.jit(jss_ref.selective_scan_ref)


def _qkv(B, Hq, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.tensor(a).to(dtype) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_vs_pallas_and_ref(case):
    B, Hq, Hkv, S, D, causal = case
    q, k, v = _qkv(B, Hq, Hkv, S, D)
    got = tfa_ops.attention(*_t(q, k, v), causal=causal)
    _close(got, jfa_ops.attention(q, k, v, causal=causal), GATE["fp32"])
    _close(got, jfa_ref.mha_ref(q, k, v, causal=causal), GATE["fp32"])
    _close(tfa_ref.mha_ref(*_t(q, k, v), causal=causal),
           jfa_ref.mha_ref(q, k, v, causal=causal), 1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_plain_dtypes(dtype):
    """The reference's dtypes test: the kernel in the dtype against the
    fp32 oracle; the port's plain version also against the reference's
    interpret-mode kernel in the same dtype."""
    q, k, v = _qkv(1, 2, 2, 128, 32, seed=1)
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tq, tk, tv = _t(q, k, v, dtype=tdt)
    got = tfa_kernel.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tdt
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = jfa_ref.mha_ref(*(x.astype(jnp.float32) for x in (jq, jk, jv)),
                           causal=True)
    _close(got.float(), want, GATE[dtype])
    _close(got.float(), jfa_kernel.flash_attention(jq, jk, jv, causal=True,
                                                   block_q=128, block_k=128),
           GATE[dtype])


@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 32), (32, 64)])
def test_flash_plain_block_sweep(bq, bk):
    q, k, v = _qkv(1, 2, 2, 128, 32, seed=2)
    got = tfa_kernel.flash_attention_plain(*_t(q, k, v), causal=True,
                                           block_q=bq, block_k=bk)
    _close(got, jfa_kernel.flash_attention(q, k, v, causal=True, block_q=bq,
                                           block_k=bk), GATE["fp32"])
    _close(got, jfa_ref.mha_ref(q, k, v, causal=True), GATE["fp32"])


@pytest.mark.parametrize("S,causal", [(37, True), (37, False), (200, True),
                                      (1, True)])
def test_flash_plain_any_sequence_length(S, causal):
    """The reference's kernel needs S divisible by its block; the port's
    versions mask the ragged last block, so any S runs and still equals
    the dense oracle."""
    q, k, v = _qkv(2, 4, 2, S, 16, seed=3)
    want = jfa_ref.mha_ref(q, k, v, causal=causal)
    _close(tfa_ops.attention(*_t(q, k, v), causal=causal), want,
           GATE["fp32"])
    _close(tfa_kernel.flash_attention_plain(*_t(q, k, v), causal=causal,
                                            block_q=64, block_k=48), want,
           GATE["fp32"])


def test_flash_wrapper_cpu_path_and_counter():
    q, k, v = _t(*_qkv(1, 4, 2, 40, 16, seed=4))
    before = tfa_kernel.flash_attention.launches
    got = tfa_kernel.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, tfa_kernel.flash_attention_plain(q, k, v,
                                                             causal=True))
    assert tfa_kernel.flash_attention.launches == before
    k3, v3 = (t[:, :1].expand(1, 3, 40, 16) for t in (k, v))
    with pytest.raises(ValueError, match="not a multiple"):
        tfa_kernel.flash_attention(q, k3, v3)
    # a meta tensor takes the fake route (the dry run's): shapes, no launch
    meta = tfa_kernel.flash_attention(q.to("meta"), k.to("meta"),
                                      v.to("meta"))
    assert meta.is_meta and meta.shape == got.shape
    assert tfa_kernel.flash_attention.launches == before


def test_flash_refuses_autograd():
    """The serving forward refuses to record a gradient; the training
    entry point records one and agrees with the dense oracle's."""
    q, k, v = _t(*_qkv(1, 2, 2, 16, 16, seed=5))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="attention_train"):
        tfa_ops.attention(q, k, v)
    with torch.no_grad():
        tfa_ops.attention(q, k, v)
    o = tfa_ops.attention_train(q, k, v)
    (g,) = torch.autograd.grad(o.sum(), q)
    (want,) = torch.autograd.grad(tfa_ref.mha_ref(q, k, v).sum(), q)
    _close(g.detach(), want.detach(), GATE["fp32"])


# ---------------------------------------------------------------------------
# selective scan
# ---------------------------------------------------------------------------

def _ssm_inputs(B, T, Din, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Din)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, Din)))).astype(
        np.float32)
    A = -np.abs(rng.standard_normal((Din, N))).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    Dv = rng.standard_normal((Din,)).astype(np.float32)
    h0 = rng.standard_normal((B, Din, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, Dv, h0


@pytest.mark.parametrize("case", SSM_CASES)
def test_scan_plain_vs_pallas(case):
    B, T, Din, N, chunk = case
    x, dt, A, Bm, Cm, Dv, _ = _ssm_inputs(B, T, Din, N)
    chunk = min(chunk, T)
    while T % chunk:
        chunk //= 2
    y, h_T = tss_kernel.selective_scan(*_t(x, dt, A, Bm, Cm, Dv),
                                       chunk=chunk)
    _close(y, jss_kernel.selective_scan(x, dt, A, Bm, Cm, Dv, chunk=chunk),
           1e-4)
    want_y, want_h = _jscan_ref(x, dt, A, Bm, Cm, Dv)
    _close(y, want_y, 1e-4)
    _close(h_T, want_h, 1e-4)


@pytest.mark.parametrize("T", [16, 37])
def test_scan_initial_and_final_state(T):
    """h0 in, h_T out, against the reference's oracle (which folds h0 into
    the first element); the port's oracle matches it too."""
    x, dt, A, Bm, Cm, Dv, h0 = _ssm_inputs(2, T, 12, 8, seed=1)
    y, h_T = tss_kernel.selective_scan(*_t(x, dt, A, Bm, Cm, Dv), chunk=1,
                                       h0=torch.tensor(h0))
    want_y, want_h = _jscan_ref(x, dt, A, Bm, Cm, Dv, h0)
    _close(y, want_y, 1e-4)
    _close(h_T, want_h, 1e-4)
    ry, rh = tss_ref.selective_scan_ref(*_t(x, dt, A, Bm, Cm, Dv, h0))
    _close(ry, want_y, 1e-4)
    _close(rh, want_h, 1e-4)


def test_scan_ops_chunk_rule_and_step():
    x, dt, A, Bm, Cm, Dv, h0 = _ssm_inputs(2, 96, 16, 8, seed=2)
    y, _ = tss_ops.scan(*_t(x, dt, A, Bm, Cm, Dv))
    _close(y, jss_ops.scan(x, dt, A, Bm, Cm, Dv), 1e-4)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tss_kernel.selective_scan(*_t(x, dt, A, Bm, Cm, Dv), chunk=64)
    t = 5
    got = tss_ref.selective_step_ref(*_t(h0, x[:, t], dt[:, t], A, Bm[:, t],
                                         Cm[:, t], Dv))
    want = jss_ref.selective_step_ref(h0, x[:, t], dt[:, t], A, Bm[:, t],
                                      Cm[:, t], Dv)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_scan_bf16_output_dtype():
    x, dt, A, Bm, Cm, Dv, _ = _ssm_inputs(1, 32, 16, 4, seed=3)
    tx, tb, tc = _t(x, Bm, Cm, dtype=torch.bfloat16)
    tdt, tA, tD = _t(dt, A, Dv)
    y, h_T = tss_ops.scan(tx, tdt, tA, tb, tc, tD)
    assert y.dtype == torch.bfloat16 and h_T.dtype == torch.float32
    want, _ = _jscan_ref(
        *(np.asarray(t.float()) for t in (tx, tdt, tA, tb, tc, tD)))
    _close(y.float(), want, GATE["bf16"])


def test_scan_wrapper_cpu_path_counter_and_autograd():
    args = _t(*_ssm_inputs(1, 24, 8, 4, seed=4)[:6])
    before = tss_kernel.selective_scan.launches
    y, h_T = tss_kernel.selective_scan(*args, chunk=8)
    py, ph = tss_kernel.selective_scan_plain(*args, chunk=8)
    assert torch.equal(y, py) and torch.equal(h_T, ph)
    assert tss_kernel.selective_scan.launches == before
    with pytest.raises(ValueError, match="A must be"):
        tss_kernel.selective_scan(args[0], args[1], args[2][:4], *args[3:])
    args[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="_chunked_selective_scan"):
        tss_ops.scan(*args)
    with torch.inference_mode():
        tss_ops.scan(*args)
