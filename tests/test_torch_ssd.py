"""PyTorch port, the Mamba-2 (SSD) half of ``models/ssm.py`` against the JAX
package's on the same numpy inputs:

* ``_ssd_chunked`` (the matmul-form chunk loop) and ``_ssm_core_m2`` with
  ``algo="ssd"`` and ``"diag"``, T a multiple of the chunk and not, from
  zero and from a state, within 1e-5 (fp32);
* the Mamba-2 ``mamba_forward`` from zero and from a state, and
  ``mamba_decode_step``, at the reference's gates (rtol 1e-4, atol 1e-5:
  ``tests/test_models.py:259-271``); the forward against step-by-step
  decode (the reference's ``test_ssm_mamba2_forward_vs_decode``);
* gradients through the SSD (every input of ``_ssd_chunked``, and a
  block's parameters through ``mamba_forward``) against ``jax.grad``
  within the reference's fp32 ``GRAD_ATOL`` (1e-4).

The reference's Mamba-2 parameters start at A = −1, dt bias 0 and D = 1
for every head; the tests draw them at random so that a head mixed up
with another shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

FWD_TOL = 1e-5
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
MODEL_GATE = dict(rtol=1e-4, atol=1e-5)     # tests/test_models.py:270-271
_jforward = jax.jit(jssm.mamba_forward, static_argnames=("cfg", "chunk"))
_jstep = jax.jit(jssm.mamba_decode_step, static_argnames=("cfg",))


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol=FWD_TOL, atol=FWD_TOL, err_msg=""):
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def _ssd_inputs(B, T, H, P, N, seed=0):
    """(log_a ≤ 0, u, Bm, Cm, h0) as the SSM core hands them over."""
    rng = np.random.default_rng(seed)
    log_a = -np.abs(rng.standard_normal((B, T, H))).astype(np.float32) * 0.5
    return (log_a, _np(seed + 1, B, T, H, P), _np(seed + 2, B, T, N),
            _np(seed + 3, B, T, N), _np(seed + 4, B, H, P, N))


def _mamba2(algo="ssd", headdim=8, seed=1):
    kw = dict(d_model=16, d_inner=32, d_state=8, dt_rank=4, version=2,
              headdim=headdim, algo=algo)
    jcfg, tcfg = jssm.SSMConfig(**kw), tssm.SSMConfig(**kw)
    jp = {k: np.asarray(v) for k, v in jssm.init_mamba(
        jax.random.PRNGKey(seed), jcfg, jnp.float32).items()}
    H = jcfg.n_heads
    jp["a_log_h"] = _np(seed + 10, H) * 0.5
    jp["dt_head_bias"] = _np(seed + 11, H) * 0.5
    jp["d_h"] = _np(seed + 12, H)
    tp = {k: torch.tensor(v) for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


def test_ssm_config_and_init_match_reference():
    jcfg, jp, tcfg, _ = _mamba2()
    assert tcfg.n_heads == jcfg.n_heads == 4
    for f in ("headdim", "n_groups", "algo"):
        assert getattr(tssm.SSMConfig(1, 2, 3, 4), f) == \
            getattr(jssm.SSMConfig(1, 2, 3, 4), f)
    tp = tssm.init_mamba(torch.Generator().manual_seed(0), tcfg,
                         torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert {k: v.dtype for k, v in tp.items()}["a_log_h"] == torch.float32


@pytest.mark.parametrize("T,chunk", [(16, 8), (24, 24), (12, 5), (9, 1)])
def test_ssd_chunked_vs_reference(T, chunk):
    B, H, P, N = 2, 3, 4, 5
    arrays = _ssd_inputs(B, T, H, P, N)
    if T % chunk:
        # the reference's chunks must divide T; the port also runs a
        # shorter last chunk, which equals the divisor's chunking
        y, h = tssm._ssd_chunked(*(torch.tensor(a) for a in arrays), chunk)
        y2, h2 = tssm._ssd_chunked(*(torch.tensor(a) for a in arrays),
                                   tssm._pick_chunk(T, chunk))
        _close(y, y2.numpy())
        _close(h, h2.numpy())
        chunk = tssm._pick_chunk(T, chunk)
    y, h = tssm._ssd_chunked(*(torch.tensor(a) for a in arrays), chunk)
    jy, jh = jssm._ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk)
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("algo", ["ssd", "diag"])
@pytest.mark.parametrize("T,chunk", [(16, 4), (12, 16), (10, 4)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_core_m2_vs_reference(algo, T, chunk, with_state):
    jcfg, jp, tcfg, tp = _mamba2(algo)
    x = _np(20, 2, T, jcfg.d_inner)
    h0 = _np(21, 2, jcfg.d_inner, jcfg.d_state) if with_state else None
    y, h = tssm._ssm_core_m2(tp, torch.tensor(x), tcfg,
                             None if h0 is None else torch.tensor(h0),
                             chunk=chunk)
    jy, jh = jssm._ssm_core_m2(jp, jnp.asarray(x), jcfg, chunk,
                               None if h0 is None else jnp.asarray(h0),
                               jssm.NO_RULES)
    _close(y, jy)
    _close(h, jh)


@pytest.mark.parametrize("algo", ["ssd", "diag"])
def test_mamba2_forward_from_zero_and_from_a_state(algo):
    jcfg, jp, tcfg, tp = _mamba2(algo)
    x = _np(30, 2, 14, 16)
    y, st = tssm.mamba_forward(tp, torch.tensor(x[:, :6]), tcfg, chunk=4)
    jy, jst = _jforward(jp, x[:, :6], cfg=jcfg, chunk=4)
    _close(y, jy, **MODEL_GATE)
    _close(st.ssm, jst.ssm, **MODEL_GATE)
    _close(st.conv, jst.conv, **MODEL_GATE)
    y2, st2 = tssm.mamba_forward(tp, torch.tensor(x[:, 6:]), tcfg, chunk=4,
                                 state=st)
    jy2, jst2 = _jforward(jp, x[:, 6:], cfg=jcfg, chunk=4, state=jst)
    _close(y2, jy2, **MODEL_GATE)
    _close(st2.ssm, jst2.ssm, **MODEL_GATE)
    # every route computes the same chunk loop: there is no SSD kernel
    for route in ("kernels", "train", "plain"):
        yr, _ = tssm.mamba_forward(tp, torch.tensor(x[:, :6]), tcfg, chunk=4,
                                   route=route)
        assert torch.equal(yr, y)


def test_mamba2_decode_vs_reference_and_forward_vs_decode():
    """The reference's ``test_ssm_mamba2_forward_vs_decode`` on the port,
    and each decode step against the reference's."""
    jcfg, jp, tcfg, tp = _mamba2()
    x = _np(31, 2, 12, 16)
    y_full, st_full = tssm.mamba_forward(tp, torch.tensor(x), tcfg, chunk=4)
    state = tssm.init_ssm_state(2, tcfg, torch.float32, device="cpu")
    jstate = jssm.init_ssm_state(2, jcfg, jnp.float32)
    ys = []
    for t in range(12):
        yt, state = tssm.mamba_decode_step(tp, torch.tensor(x[:, t:t + 1]),
                                           state, tcfg)
        jyt, jstate = _jstep(jp, x[:, t:t + 1], jstate, cfg=jcfg)
        _close(yt, jyt, **MODEL_GATE)
        _close(state.ssm, jstate.ssm, **MODEL_GATE)
        ys.append(yt)
    _close(torch.cat(ys, 1), y_full.numpy(), **MODEL_GATE)
    _close(state.ssm, st_full.ssm.numpy(), **MODEL_GATE)


def test_ssd_gradients_vs_jax_grad():
    B, T, H, P, N, chunk = 2, 12, 3, 4, 5, 4
    arrays = _ssd_inputs(B, T, H, P, N, seed=5)
    w_y, w_h = _np(40, B, T, H, P), _np(41, B, H, P, N)

    def jloss(*a):
        y, h = jssm._ssd_chunked(*a, chunk)
        return jnp.sum(y * w_y) + jnp.sum(h * w_h)

    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in arrays))
    ins = [torch.tensor(a, requires_grad=True) for a in arrays]
    y, h = tssm._ssd_chunked(*ins, chunk)
    loss = (y * torch.tensor(w_y)).sum() + (h * torch.tensor(w_h)).sum()
    grads = torch.autograd.grad(loss, ins)
    for name, g, jg in zip(("log_a", "u", "Bm", "Cm", "h0"), grads, jgrads):
        _close(g, jg, GRAD_ATOL, GRAD_ATOL, name)


@pytest.mark.parametrize("algo", ["ssd", "diag"])
def test_mamba2_block_gradients_vs_jax_grad(algo):
    jcfg, jp, tcfg, tp = _mamba2(algo)
    x = _np(50, 2, 10, 16)
    w = _np(51, 2, 10, 16)

    def jloss(p, xx):
        y, st = jssm.mamba_forward(p, xx, jcfg, chunk=4)
        return jnp.sum(y * w) + jnp.sum(st.ssm)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, st = tssm.mamba_forward(leaves, xt, tcfg, chunk=4, route="train")
    loss = (y * torch.tensor(w)).sum() + st.ssm.sum()
    grads = torch.autograd.grad(loss, [*leaves.values(), xt])
    for name, g in zip([*leaves, "x"], grads):
        want = jgx if name == "x" else jg[name]
        _close(g, want, GRAD_ATOL, GRAD_ATOL, name)
