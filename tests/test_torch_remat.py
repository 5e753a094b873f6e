"""PyTorch port, the two-level remat of ``forward_train`` (the reference's
``_remat_group`` and ``_nested_scan``).

* ``lm._remat_group(n)`` equals the reference's for n = 1..100;
* at 16 layers (groups of 4) the gradients of every parameter with the
  two-level remat are bitwise those without remat, and so is the loss
  (fp32 on the CPU: the recomputation repeats the same operations);
* layer inputs kept alive, counted by weak references to the tensors each
  layer is called with: 16 with single-level remat before the backward,
  16 / 4 = 4 with two levels, and at most 16 / 4 + 4 while the backward
  recomputes a group (5 on the CPU);
* the training forward runs 3·16 − 16/4 = 44 times a step under the two
  levels (torch's checkpoint stops a group's recomputation once its last
  layer's input is back), 2·16 under single-level remat; the backward
  kernel 16 times either way;
* qwen3-moe smoke at 9 layers (groups of 3): the load-balance aux counted
  once under the nesting, equal to the reference's and to the run without
  remat, its gradients too.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tck
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.models import lm as tlm

CPU = "cpu"
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
L16 = 16


def _batch(cfg, B=2, S=8, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _granite(n_layers=L16, remat=True):
    cfg = tconfigs.get_smoke_config("granite-3-2b")
    return dataclasses.replace(cfg, n_layers=n_layers, remat=remat)


def _grads(params, cfg, batch):
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in tck.flatten(params).items()}
    loss, metrics = tlm.loss_fn(tck.unflatten_like(params, leaves), cfg,
                                batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


def test_remat_group_matches_reference():
    got = [tlm._remat_group(n) for n in range(1, 101)]
    assert got == [jlm._remat_group(n) for n in range(1, 101)]
    assert tlm._remat_group(L16) == 4 and tlm._remat_group(40) == 5


def test_two_level_gradients_equal_no_remat_bitwise():
    cfg = _granite(remat=True)
    params = tlm.init_params(cfg, seed=1, device=CPU)
    batch = _batch(cfg)
    loss_r, _, g_r = _grads(params, cfg, batch)
    loss_n, _, g_n = _grads(params, dataclasses.replace(cfg, remat=False),
                            batch)
    assert torch.equal(loss_r, loss_n)
    assert g_r.keys() == g_n.keys()
    for k in g_r:
        assert torch.equal(g_r[k], g_n[k]), k


def _alive_layer_inputs(monkeypatch, cfg, params, batch):
    """(layer inputs alive when the forward returns, the most alive when a
    layer's forward starts during the backward)."""
    seen, peak = [], [0]
    in_backward = [False]
    train_layer = tlm._train_layer

    def counted(lp, x, positions, cfg_):
        if in_backward[0]:
            peak[0] = max(peak[0], sum(r() is not None for r in seen))
        seen.append(weakref.ref(x))
        return train_layer(lp, x, positions, cfg_)

    monkeypatch.setattr(tlm, "_train_layer", counted)
    leaves = {k: p.detach().clone().requires_grad_(True)
              for k, p in tck.flatten(params).items()}
    loss, _ = tlm.loss_fn(tck.unflatten_like(params, leaves), cfg, batch)
    gc.collect()
    before = sum(r() is not None for r in seen)
    in_backward[0] = True
    torch.autograd.grad(loss, list(leaves.values()))
    return before, peak[0]


def test_layer_inputs_kept_alive(monkeypatch):
    cfg = _granite(remat=True)
    params = tlm.init_params(cfg, seed=2, device=CPU)
    batch = _batch(cfg)
    G = tlm._remat_group(L16)
    before, peak = _alive_layer_inputs(monkeypatch, cfg, params, batch)
    assert before == L16 // G
    assert peak <= L16 // G + G
    # single-level remat (groups of 1) keeps every layer's input
    monkeypatch.setattr(tlm, "_remat_group", lambda n: 1)
    before, peak = _alive_layer_inputs(monkeypatch, cfg, params, batch)
    assert before == peak == L16


@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_backward_kernel_calls_a_step(monkeypatch, remat):
    calls = {"fwd_lse": 0, "bwd": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tfa_ops, "flash_attention_fwd_lse", counted(
        "fwd_lse", tfa_ops.flash_attention_fwd_lse))
    monkeypatch.setattr(tfa_ops, "flash_attention_bwd", counted(
        "bwd", tfa_ops.flash_attention_bwd))
    cfg = _granite(remat=remat)
    _grads(tlm.init_params(cfg, device=CPU), cfg, _batch(cfg))
    G = tlm._remat_group(L16)
    want = 3 * L16 - L16 // G if remat else L16
    assert calls == {"fwd_lse": want, "bwd": L16}


def test_moe_aux_counted_once_under_nesting():
    n = 9
    jcfg = dataclasses.replace(
        jconfigs.get_smoke_config("qwen3-moe-30b-a3b"), n_layers=n,
        remat=True)
    tcfg = dataclasses.replace(
        tconfigs.get_smoke_config("qwen3-moe-30b-a3b"), n_layers=n,
        remat=True)
    assert tlm._remat_group(n) == 3
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         tcfg, device=CPU)
    batch = _batch(tcfg, seed=5)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _grads(tparams, tcfg, batch)
    loss_n, metrics_n, grads_n = _grads(
        tparams, dataclasses.replace(tcfg, remat=False), batch)
    np.testing.assert_allclose(float(metrics["moe_aux"]),
                               float(jmetrics["moe_aux"]), rtol=1e-5)
    assert torch.equal(metrics["moe_aux"], metrics_n["moe_aux"])
    assert torch.equal(loss, loss_n)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=GRAD_ATOL,
                               atol=GRAD_ATOL)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    for k, g in grads.items():
        assert torch.equal(g, grads_n[k]), k
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_ATOL,
                                   atol=GRAD_ATOL, err_msg=k)
