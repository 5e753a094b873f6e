"""PyTorch port, the audio encoder–decoder (seamless-m4t-large-v2) against
the JAX package on the same numpy inputs, with the reference's smoke
weights carried across by ``convert.lm_params_from_jax``:

* ``encode`` (the bidirectional encoder over stub frames), the
  teacher-forced ``forward_train`` logits (each decoder layer's cross
  attention over the encoder's output, Sk = T_src ≠ Sq) within
  1e-5·max(1, max|logit|), ``loss_fn`` and whole-tree gradients (the
  encoder's included) against ``jax.grad`` within ``GRAD_ATOL``;
* ``prefill`` (the cross K/V kept in ``DecodeState.cross``) and greedy
  decode steps against the reference's and against a full forward;
  ``generate`` tokens equal to the reference's ``generate``;
* training's attention launches a step on the kernel route with remat:
  the encoder's stack and the decoder's two attention blocks a layer, as
  ``chip_smoke.train_attention_launches`` counts them for the card;
* a batch without frames: ``ValueError`` naming them (the reference
  raises ``KeyError``), ``LMDecodeAdapter`` refusing an enc-dec config
  when it is built; the parameter tree, ``param_count``, the serving and
  training CLIs with ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.runtime import serve_loop as jserve
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tck
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import lm as tlm
from repro_torch.runtime import serve_loop as tserve

CPU = "cpu"
ARCH = "seamless-m4t-large-v2"
TOL = 1e-5                 # fp32 logits: 1e-5·max(1, max|logit|)
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
B, S, G = 2, 12, 4         # batch, text tokens, generated tokens


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _configs(remat=False):
    """(reference, port) smoke configs: 32 frames; the reference's
    attention chunk 4 divides every length used here."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               attn_chunk=4, remat=remat)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), remat=remat)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs()
    return jax.tree.map(np.asarray,
                        jlm.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(cfg, seq=S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, seq + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[1, -3:] = -1
    return {"tokens": toks[:, :-1], "labels": labels,
            "frames": _np(seed + 1, B, cfg.source_len, cfg.d_model)}


def _gate(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def test_encoder_forward_and_loss_match_reference(weights):
    jcfg, tcfg = _configs()
    batch = _batch(tcfg)
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    jparams = jax.tree.map(jnp.asarray, weights)
    with torch.no_grad():
        mem = tlm.encode(tparams, tcfg, batch["frames"])
        logits, _ = tlm.forward_train(tparams, tcfg, batch)
        loss, metrics = tlm.loss_fn(tparams, tcfg, batch)
    _gate(mem.numpy(), jlm.encode(jparams, jcfg, jnp.asarray(batch["frames"]),
                                  jlm.NO_RULES))
    jlogits, _ = jax.jit(jlm.forward_train, static_argnums=1)(
        jparams, jcfg, batch)
    assert logits.shape == (B, S, tcfg.vocab_padded)
    _gate(logits.numpy(), jlogits)
    jloss, jmetrics = jax.jit(jlm.loss_fn, static_argnums=1)(jparams, jcfg,
                                                            batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == B * S - 3
    # the frames reach the logits through the cross attention
    other = dict(batch, frames=_np(99, B, tcfg.source_len, tcfg.d_model))
    with torch.no_grad():
        moved, _ = tlm.forward_train(tparams, tcfg, other)
    assert not torch.allclose(moved, logits)


def test_whole_tree_gradients_match_jax_grad(weights):
    jcfg, tcfg = _configs(remat=True)
    batch = _batch(tcfg, seed=3)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
            jax.tree.map(jnp.asarray, weights), batch)
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    leaves = {k: p.requires_grad_(True)
              for k, p in tck.flatten(tparams).items()}
    loss, _ = tlm.loss_fn(tparams, tcfg, batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=GRAD_ATOL, atol=GRAD_ATOL)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert grads.keys() == want.keys()
    assert {"encoder/layers/attn/wq", "layers/cross/wk"} <= grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_ATOL,
                                   atol=GRAD_ATOL, err_msg=k)


def _greedy(prefill, step, batch, steps):
    logits, state = prefill(batch)
    out, fed = [np.asarray(logits)], []
    for _ in range(steps):
        nxt = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        fed.append(nxt)
        logits, state = step(state, nxt)
        out.append(np.asarray(logits))
    return out, np.concatenate([batch["tokens"]] + fed, axis=1), state


def test_prefill_and_decode_match_reference_and_full_forward(weights):
    jcfg, tcfg = _configs()
    batch = _batch(tcfg, seed=5)
    del batch["labels"]
    max_len = S + G
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    jparams = jax.tree.map(jnp.asarray, weights)
    with torch.inference_mode():
        got, seq, state = _greedy(
            lambda b: tlm.prefill(tparams, tcfg, b, max_len),
            lambda st, t: tlm.decode_step(tparams, tcfg, st,
                                          torch.from_numpy(t)), batch, G)
        full, _ = tlm.forward_train(tparams, tcfg, {**batch, "tokens": seq})
    want, jseq, jstate = _greedy(
        lambda b: jlm.prefill(jparams, jcfg, b, max_len),
        lambda st, t: jlm.decode_step(jparams, jcfg, st, jnp.asarray(t)),
        batch, G)
    np.testing.assert_array_equal(seq, jseq)
    # the cross K/V of every decoder layer, kept for decode
    assert state.cross[0].shape == (tcfg.n_layers, B, tcfg.source_len,
                                    tcfg.n_kv, tcfg.d_head)
    _gate(state.cross[0].numpy(), jstate.cross[0])
    _gate(state.cross[1].numpy(), jstate.cross[1])
    for j, g in enumerate(got):
        _gate(g, want[j])
        _gate(g, full[:, S - 1 + j].numpy())


def test_generate_matches_reference_generate(weights):
    jcfg, tcfg = _configs()
    batch = _batch(tcfg, seed=7)
    del batch["labels"]
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    jout, _ = jserve.generate(jax.tree.map(jnp.asarray, weights), jcfg,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              max_new_tokens=G)
    out, stats = tserve.generate(tparams, tcfg, batch, max_new_tokens=G)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert bool(stats.finite.all())
    plain, _ = tserve.generate(tparams, tcfg, batch, max_new_tokens=G,
                               route="plain")
    assert torch.equal(out, plain)


def test_training_attention_launches_a_step(monkeypatch):
    """The kernel route's attention calls in one training step with the
    two-level remat: the encoder's stack and the decoder's self and cross
    attention, as ``chip_smoke.train_attention_launches`` counts them."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tfa_ops, "flash_attention_fwd_lse", counted(
        "fwd", tfa_ops.flash_attention_fwd_lse))
    monkeypatch.setattr(tfa_ops, "flash_attention_bwd", counted(
        "bwd", tfa_ops.flash_attention_bwd))
    cfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), n_layers=4,
                              n_enc_layers=9, remat=True)
    params = tlm.init_params(cfg, seed=1, device=CPU)
    leaves = {k: p.requires_grad_(True)
              for k, p in tck.flatten(params).items()}
    loss, _ = tlm.loss_fn(params, cfg, _batch(cfg))
    torch.autograd.grad(loss, list(leaves.values()))
    fwd, bwd = chip_smoke.train_attention_launches(cfg)
    # two-level remat, groups of 2 of the decoder's 4 and 3 of the
    # encoder's 9 layers: 3n − n/G forwards a stack, a decoder layer's two
    assert (fwd, bwd) == ((3 * 9 - 3) + 2 * (3 * 4 - 2), 9 + 2 * 4)
    assert calls == {"fwd": fwd, "bwd": bwd}


def test_frames_are_required_and_the_adapter_refuses(weights):
    jcfg, tcfg = _configs()
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    batch = _batch(tcfg)
    del batch["frames"]
    # the reference fails with a KeyError; the port names what is missing
    with pytest.raises(KeyError, match="frames"):
        jlm.loss_fn(jax.tree.map(jnp.asarray, weights), jcfg, batch)
    for call in (lambda: tlm.loss_fn(tparams, tcfg, batch),
                 lambda: tlm.prefill(tparams, tcfg, batch, S + 2),
                 lambda: tserve.generate(tparams, tcfg, batch, 2)):
        with pytest.raises(ValueError, match="needs 'frames'"):
            call()
    with pytest.raises(ValueError, match="token rows only"):
        tserve.LMDecodeAdapter(tparams, tcfg, prompt_len=S, max_new_tokens=2)


def test_params_from_jax_and_param_count(weights):
    _, tcfg = _configs()
    flat = tck.flatten(weights)
    tparams = convert.lm_params_from_jax(flat, tcfg, device=CPU)
    assert tck.flatten(tparams).keys() == flat.keys()
    assert tparams["encoder"]["layers"]["attn"]["wq"].shape[0] == \
        tcfg.n_enc_layers
    missing = {k: v for k, v in flat.items()
               if k != "encoder/final_norm/bias"}
    with pytest.raises(KeyError, match="no leaf"):
        convert.lm_params_from_jax(missing, tcfg, device=CPU)
    full = tconfigs.get_config(ARCH)
    assert full.param_count() == jconfigs.get_config(ARCH).param_count()
    cut = tconfigs.with_layers(full, 2)
    assert (cut.n_layers, cut.n_enc_layers) == (2, 2)


def test_serve_and_train_clis_on_cpu(capsys):
    res = tserve_cli.main(["--arch", ARCH, "--smoke", "--requests", "3",
                           "--batch", "2", "--prompt-len", "5", "--gen", "3",
                           "--layers", "1", "--device", CPU])
    assert res["tokens"] == 9
    out = ttrain_cli.main(["--arch", ARCH, "--smoke", "--steps", "3",
                           "--global-batch", "4", "--microbatches", "2",
                           "--seq", "8", "--device", CPU])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "done" in capsys.readouterr().out
