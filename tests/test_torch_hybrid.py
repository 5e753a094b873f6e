"""PyTorch port, the hybrid family (zamba2-7b: Mamba-2 layers and one shared
attention block) against the JAX package on the same numpy inputs, with
the reference's smoke weights carried across by
``convert.lm_params_from_jax``.  The smoke config has 5 layers and
``attn_every`` 2: two super-blocks of two Mamba-2 layers, each followed by
the shared block, and one tail layer.

* the parameter tree (doubly stacked ``blocks``, ``shared_attn``,
  ``tail``) carried across leaf by leaf, a missing or extra leaf refused;
* ``prefill`` and ``decode_step`` logits within the reference's 2e-4
  (``tests/test_models.py:79-86``); the decode state's KV caches hold
  n_super entries; ``generate`` tokens and an ``LMDecodeAdapter`` wave
  equal to the reference's ``generate``;
* ``forward_train`` logits and ``loss_fn``'s loss and whole-tree gradients
  against ``jax.value_and_grad`` within ``GRAD_ATOL``, remat on and off;
* the train and serve CLIs with ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.runtime import serve_loop as jserve
from repro_torch import checkpoint as tck
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import lm as tlm
from repro_torch.runtime import serve_loop as tserve
from repro_torch.runtime.wave_serve import ServeConfig, WaveServer

CPU = "cpu"
ARCH = "zamba2-7b"
LOGIT_GATE = 2e-4          # tests/test_models.py:79-86
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _close(got, want, tol, err_msg=""):
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=err_msg)


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def model():
    """(reference config, reference params, port config, port params)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         tcfg, device=CPU)
    return jcfg, jparams, tcfg, tparams


def test_parameters_carried_across(model):
    jcfg, jparams, tcfg, tparams = model
    assert (tcfg.n_layers, tcfg.attn_every) == (5, 2)
    assert tlm.hybrid_layout(tcfg) == (2, 1)
    flat = _flat_jax(jparams)
    got = tck.flatten(tparams)
    assert got.keys() == flat.keys()
    for key, arr in flat.items():
        assert tuple(got[key].shape) == arr.shape, key
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert got["blocks/mamba/bc_proj"].shape[:2] == (2, 2)
    assert got["tail/mamba/a_log_h"].shape[0] == 1
    # the shapes alone, on the meta device, give the reference's count
    assert tcfg.param_count() == jcfg.param_count()
    missing = dict(flat)
    missing.pop("shared_attn/attn/wq")
    with pytest.raises(KeyError, match="no leaf"):
        convert.lm_params_from_jax(missing, tcfg, device=CPU)
    with pytest.raises(KeyError, match="no counterpart"):
        convert.lm_params_from_jax({**flat, "layers/x": np.zeros(1)}, tcfg,
                                   device=CPU)
    bad = {**flat, "blocks/mamba/d_h": np.zeros((2, 3, 4), np.float32)}
    with pytest.raises(ValueError, match="blocks/mamba/d_h"):
        convert.lm_params_from_jax(bad, tcfg, device=CPU)


def test_prefill_and_decode_logits_vs_reference(model):
    jcfg, jparams, tcfg, tparams = model
    toks = _prompts(tcfg, 2, 16)
    lg, st = tlm.prefill(tparams, tcfg, {"tokens": toks[:, :13]}, max_len=16)
    jlg, jst = jlm.prefill(jparams, jcfg,
                           {"tokens": jnp.asarray(toks[:, :13])}, max_len=16)
    _close(lg, jlg, LOGIT_GATE)
    # one KV cache a super-block, the SSM state of every Mamba layer
    assert st.kv[0].shape == jst.kv[0].shape == (2, 2, 16, 4, 16)
    assert st.ssm.ssm.shape == jst.ssm.ssm.shape
    _close(st.ssm.ssm, jst.ssm.ssm, LOGIT_GATE)
    _close(st.kv[0], jst.kv[0], LOGIT_GATE)
    for t in range(13, 16):
        lg, st = tlm.decode_step(tparams, tcfg, st, toks[:, t:t + 1])
        jlg, jst = jlm.decode_step(jparams, jcfg, jst,
                                   jnp.asarray(toks[:, t:t + 1]))
        _close(lg, jlg, LOGIT_GATE)
    assert st.pos.tolist() == [16, 16]


def test_decode_equals_a_full_forward(model):
    """Every decode step from a 6-token prefill against the full forward's
    logits at its position."""
    _, _, tcfg, tparams = model
    toks = _prompts(tcfg, 2, 12, seed=3)
    logits, aux = tlm.forward_train(tparams, tcfg, {"tokens": toks})
    assert float(aux) == 0.0
    lg, st = tlm.prefill(tparams, tcfg, {"tokens": toks[:, :6]}, 12)
    _close(lg, logits[:, 5].numpy(), LOGIT_GATE)
    for t in range(6, 12):
        lg, st = tlm.decode_step(tparams, tcfg, st, toks[:, t:t + 1])
        _close(lg, logits[:, t].numpy(), LOGIT_GATE)


def test_generate_and_adapter_wave_match_reference(model):
    jcfg, jparams, tcfg, tparams = model
    toks = _prompts(tcfg, 3, 8, seed=1)
    out, stats = tserve.generate(tparams, tcfg, {"tokens": toks}, 5)
    jout, jstats = jserve.generate(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)}, 5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert (stats.prefill_tokens, stats.decode_tokens, stats.steps) == (
        jstats.prefill_tokens, jstats.decode_tokens, jstats.steps)
    adapter = tserve.LMDecodeAdapter(tparams, tcfg, prompt_len=8,
                                     max_new_tokens=5)
    scfg = ServeConfig(microbatch=2, n_micro=2, pipeline=None)
    wave = adapter.make_wave_fn(scfg)
    got = adapter.unpack(wave(adapter.pack(list(toks), scfg)), 3)
    np.testing.assert_array_equal(np.stack(got), np.asarray(jout))
    server = WaveServer(adapter, cfg=scfg)
    server.submit(toks)
    done = sorted(server.drain(), key=lambda c: c.rid)
    np.testing.assert_array_equal(np.stack([c.pred for c in done]),
                                  np.asarray(jout))
    assert server.metrics.summary()["failed"] == 0


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_whole_tree_gradients_vs_reference(model, remat):
    jcfg, jparams, tcfg, _ = model
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    toks = _prompts(tcfg, 2, 12, seed=2)
    labels = _prompts(tcfg, 2, 12, seed=4)
    labels[0, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(jparams, batch)
    jlogits, _ = jlm.forward_train(jparams, jcfg, batch)
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         tcfg, device=CPU)
    leaves = {k: p.requires_grad_(True)
              for k, p in tck.flatten(tparams).items()}
    logits, _ = tlm.forward_train(tparams, tcfg, batch)
    _close(logits, jlogits, LOGIT_GATE)
    loss, metrics = tlm.loss_fn(tparams, tcfg, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    _close(loss, jloss, GRAD_ATOL)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == 21
    want = _flat_jax(jgrads)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        _close(g, want[k], GRAD_ATOL, k)


def test_hybrid_checks():
    cfg = tconfigs.get_smoke_config(ARCH)
    for bad in (dict(attn_every=0), dict(attn_every=6), dict(ssm=None)):
        with pytest.raises(ValueError, match="hybrid family needs"):
            tlm.init_params(dataclasses.replace(cfg, **bad), device=CPU)
    with pytest.raises(ValueError, match="no sliding window"):
        tlm.init_params(dataclasses.replace(cfg, sliding_window=4),
                        device=CPU)
    # a depth cut keeps the super-blocks and leaves the rest as the tail
    cut = dataclasses.replace(tconfigs.get_config(ARCH), n_layers=39)
    assert tlm.hybrid_layout(cut) == (6, 3)
    assert tlm.hybrid_layout(tconfigs.get_config(ARCH)) == (13, 3)


def test_train_and_serve_clis_on_cpu(capsys):
    out = ttrain_cli.main(["--arch", ARCH, "--smoke", "--steps", "3",
                           "--device", CPU, "--global-batch", "2",
                           "--seq", "16"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    # --layers keeps the super-block structure and its tail
    out = ttrain_cli.main(["--arch", ARCH, "--smoke", "--steps", "1",
                           "--device", CPU, "--layers", "4",
                           "--global-batch", "2", "--seq", "8"])
    flat = tck.flatten(out["params"])
    assert flat["blocks/norm/scale"].shape[:2] == (2, 2)
    assert "tail/norm/scale" not in flat
    served = tserve_cli.main(["--arch", ARCH, "--smoke", "--device", CPU,
                              "--requests", "3", "--batch", "2",
                              "--prompt-len", "5", "--gen", "4"])
    assert served["tokens"] == 12
    text = capsys.readouterr().out
    assert "done" in text and "served 3 requests (12 tokens)" in text
