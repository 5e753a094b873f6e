"""PyTorch port, the flash-attention head dims 112 (zamba2-7b) and 160
(stablelm-12b) against the JAX package on the same numpy inputs.

* ``flash_attention``, ``flash_attention_fwd_lse`` and
  ``flash_attention_bwd`` (their plain versions, which the wrappers run on
  a CPU tensor) at D = 112 and 160 against the reference's Pallas kernels
  in interpret mode, causal and bidirectional, fp32, o, lse, dq, dk and
  dv within 1e-5 (measured: 5e-6 at most);
* with a sliding window against the reference's pure-JAX
  ``_chunked_attention(window=...)`` (o within 1e-5) and ``jax.vjp`` of it
  (dq, dk, dv within the reference's fp32 ``GRAD_ATOL``, 1e-4; the
  reference's Pallas kernels take no window);
* ``HEAD_DIMS`` holds both, and 256; a head dim the kernels do not
  instantiate (96) runs zero-padded to the next one (112), where the
  kernels' checks pass, and one above 256 (320) runs as it is, unpadded,
  on the wide kernels, whose check it passes; on a card the wrapper
  launches the 112 kernel for D = 96 and the wide kernel for D = 320.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.models import layers as jL
from repro_torch.kernels.flash_attention import kernel as fk

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
NEW_DIMS = (112, 160)
# (B, Hq, Hkv, S, causal): GQA groups of 2 and 1, both masks
CASES = [(1, 4, 2, 64, True), (2, 2, 2, 32, False)]
# (B, Hq, Hkv, S, window, chunk of the reference)
WINDOW_CASES = [(1, 4, 2, 48, 16, 16), (1, 2, 1, 40, 7, 8)]


def _arrays(B, Hq, Hkv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hq, S, D)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_head_dims_hold_112_and_160():
    assert fk.HEAD_DIMS == (16, 32, 64, 112, 128, 160, 256)


@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("case", CASES)
def test_three_kernels_plain_vs_pallas_at_new_head_dims(case, D):
    B, Hq, Hkv, S, causal = case
    arrays = _arrays(B, Hq, Hkv, S, D)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrays)
    jkw = dict(causal=causal, block_q=32, block_k=32, interpret=True)
    before = (fk.flash_attention.launches, fk.flash_attention_fwd_lse.launches,
              fk.flash_attention_bwd.launches)
    o = fk.flash_attention(q, k, v, causal=causal)
    _close(o, jfa_kernel.flash_attention(jq, jk, jv, **jkw), FWD_ATOL)
    o2, lse = fk.flash_attention_fwd_lse(q, k, v, causal=causal)
    jo, jlse = jfa_kernel.flash_attention_fwd_lse(jq, jk, jv, **jkw)
    _close(o2, jo, FWD_ATOL)
    _close(lse, jlse, FWD_ATOL)
    # the backward on the reference's own forward output
    jo_t = torch.from_numpy(np.array(jo))
    jlse_t = torch.from_numpy(np.array(jlse))
    dq, dk, dv = fk.flash_attention_bwd(q, k, v, jo_t, jlse_t, do,
                                        causal=causal)
    jdq, jdk, jdv = jfa_kernel.flash_attention_bwd(jq, jk, jv, jo, jlse,
                                                   jdo, **jkw)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.shape == want.shape
        _close(got, want, FWD_ATOL)
    # on the CPU the wrappers ran their plain versions, launching nothing
    assert (fk.flash_attention.launches, fk.flash_attention_fwd_lse.launches,
            fk.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_windowed_kernels_plain_vs_reference_at_new_head_dims(case, D):
    B, Hq, Hkv, S, window, chunk = case
    arrays = _arrays(B, Hq, Hkv, S, D, seed=3)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    group = Hq // Hkv

    def reference(qj, kj, vj):
        # the reference's (B, S, H, D) layout, KV expanded to the q heads
        t = lambda a: a.transpose(0, 2, 1, 3)
        o = jL._chunked_attention(t(qj), jnp.repeat(t(kj), group, axis=2),
                                  jnp.repeat(t(vj), group, axis=2),
                                  causal=True, chunk=chunk, window=window)
        return t(o)

    jin = tuple(jnp.asarray(a) for a in arrays[:3])
    want, vjp = jax.vjp(reference, *jin)
    _close(fk.flash_attention(q, k, v, window=window), want, FWD_ATOL)
    o, lse = fk.flash_attention_fwd_lse(q, k, v, window=window)
    _close(o, want, FWD_ATOL)
    grads = fk.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    for got, want_g in zip(grads, vjp(jnp.asarray(arrays[3]))):
        _close(got, want_g, GRAD_ATOL)


def test_an_uninstantiated_head_dim_is_refused():
    """96 is not instantiated: the kernels' own check refuses it, and the
    wrappers' route pads it to 112, which the check takes; 320 is past
    every instantiation and runs as it is on the wide kernels, whose check
    it passes."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(1, 2, 2, 8, 96))
    with pytest.raises(ValueError, match="head dims"):
        fk._check_kernel_args(q, k, v)
    assert fk.kernel_head_dim(96) == 112
    seen = []
    fk.forward_padded(lambda *t: seen.append(fk._check_kernel_args(*t[:3]))
                      or (t[0], None), q, k, v)
    assert seen == [None]
    for D in NEW_DIMS + (256,):     # the instantiated dims pass as they are
        assert fk.kernel_head_dim(D) == D
        fk._check_kernel_args(*(torch.from_numpy(a)
                                for a in _arrays(1, 2, 2, 8, D)[:3]))
    assert fk.kernel_head_dim(320) == 320
    fk._check_kernel_args(*(torch.from_numpy(a)
                            for a in _arrays(1, 2, 2, 8, 320)[:3]))


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card: "
                    "the kernels launch only on a CUDA tensor")
def test_wrapper_raises_for_d96_on_the_card():
    """D = 96 launches the 112 kernel once, zero-padded, and agrees with
    the plain version at 96; D = 320 launches the wide kernel once,
    unpadded, and agrees with the plain version too."""
    q, k, v, _ = (torch.from_numpy(a).cuda()
                  for a in _arrays(1, 2, 2, 8, 96))
    before = fk.flash_attention.launches
    o = fk.flash_attention(q, k, v)
    assert fk.flash_attention.launches == before + 1
    want = fk.flash_attention_plain(q, k, v)
    torch.testing.assert_close(o, want, rtol=FWD_ATOL, atol=FWD_ATOL)
    q, k, v, _ = (torch.from_numpy(a).cuda()
                  for a in _arrays(1, 2, 2, 8, 320))
    o = fk.flash_attention(q, k, v)
    assert fk.flash_attention.launches == before + 2
    want = fk.flash_attention_plain(q, k, v)
    torch.testing.assert_close(o, want, rtol=FWD_ATOL, atol=FWD_ATOL)
