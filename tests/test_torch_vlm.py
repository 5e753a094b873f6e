"""PyTorch port, the VLM family (llava-next-mistral-7b) against the JAX
package on the same numpy inputs, with the reference's smoke weights
carried across by ``convert.lm_params_from_jax``:

* ``forward_train`` logits (the projected image embeddings before the
  text) within 1e-5·max(1, max|logit|), ``loss_fn`` with the labels padded
  by −1 over the image tokens, whole-tree gradients against ``jax.grad``
  within ``GRAD_ATOL``;
* ``prefill`` with a cache of n_img + S + G positions and greedy decode
  steps against a full forward over the same tokens (the port's and the
  reference's) and against the reference's ``prefill`` at that size and
  its ``decode_step``; ``generate`` tokens equal to that reference path;
* the reference's own ``generate`` sizes its cache S + G, so its prefill
  drops the first image positions and its decode is off by more than 0.1
  of max|logit| — the port does not copy it;
* the parameter tree both ways, the full config's ``param_count``, the
  serving and training CLIs with ``--device cpu``.
"""
import dataclasses

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
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import lm as tlm
from repro_torch.runtime import serve_loop as tserve
from repro_torch.runtime.wave_serve import ServeConfig

CPU = "cpu"
ARCH = "llava-next-mistral-7b"
TOL = 1e-5                 # fp32 logits: 1e-5·max(1, max|logit|)
GRAD_ATOL = 1e-4           # tests/_gradcheck.py:24, fp32
B, S, G = 2, 8, 4          # batch, text tokens, generated tokens


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _configs(remat=False):
    """(reference, port) smoke configs; the reference's attention chunk 4
    divides every length used here (16 image tokens + 8 + up to 4)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    jcfg = dataclasses.replace(jcfg, attn_chunk=4, remat=remat)
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
    labels[0, :2] = -1
    return {"tokens": toks[:, :-1], "labels": labels,
            "image_embeds": _np(seed + 1, B, cfg.n_img_tokens, cfg.d_model)}


def _gate(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def test_forward_and_loss_match_reference(weights):
    jcfg, tcfg = _configs()
    batch = _batch(tcfg)
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    jparams = jax.tree.map(jnp.asarray, weights)
    jlogits, _ = jax.jit(jlm.forward_train, static_argnums=1)(
        jparams, jcfg, batch)
    with torch.no_grad():
        logits, aux = tlm.forward_train(tparams, tcfg, batch)
        loss, metrics = tlm.loss_fn(tparams, tcfg, batch)
    assert logits.shape == (B, tcfg.n_img_tokens + S, tcfg.vocab_padded)
    _gate(logits.numpy(), jlogits)
    jloss, jmetrics = jax.jit(jlm.loss_fn, static_argnums=1)(jparams, jcfg,
                                                            batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    # the image positions carry no label: only the text's count
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == B * S - 2


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
    assert grads.keys() == want.keys() and "img_proj" in grads
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_ATOL,
                                   atol=GRAD_ATOL, err_msg=k)


def _greedy(prefill, step, batch, steps):
    """The logits of the prefill and of each decode step, and the text
    tokens with the fed ones appended."""
    logits, state = prefill(batch)
    out, fed = [np.asarray(logits)], []
    for _ in range(steps):
        nxt = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        fed.append(nxt)
        logits, state = step(state, nxt)
        out.append(np.asarray(logits))
    return out, np.concatenate([batch["tokens"]] + fed, axis=1)


def test_prefill_and_decode_match_full_forward_and_reference(weights):
    """A cache of n_img + S + G positions: each step's logits equal the
    matching row of a full forward over the image tokens, the prompt and
    the tokens fed (the port's and the reference's), and the reference's
    own prefill and decode at that size."""
    jcfg, tcfg = _configs()
    batch = _batch(tcfg, seed=5)
    del batch["labels"]
    n_img = tcfg.n_img_tokens
    max_len = n_img + S + G
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    jparams = jax.tree.map(jnp.asarray, weights)
    with torch.inference_mode():
        got, seq = _greedy(
            lambda b: tlm.prefill(tparams, tcfg, b, max_len),
            lambda st, t: tlm.decode_step(tparams, tcfg, st,
                                          torch.from_numpy(t)), batch, G)
        full, _ = tlm.forward_train(tparams, tcfg, {**batch, "tokens": seq})
    want, jseq = _greedy(
        lambda b: jlm.prefill(jparams, jcfg, b, max_len),
        lambda st, t: jlm.decode_step(jparams, jcfg, st, jnp.asarray(t)),
        batch, G)
    jfull, _ = jlm.forward_train(jparams, jcfg, {**batch, "tokens": seq})
    np.testing.assert_array_equal(seq, jseq)
    for j, g in enumerate(got):
        at = n_img + S - 1 + j
        _gate(g, want[j])
        _gate(g, full[:, at].numpy())
        _gate(g, np.asarray(jfull)[:, at])


def test_generate_matches_the_correctly_sized_reference(weights):
    jcfg, tcfg = _configs()
    batch = _batch(tcfg, seed=7)
    del batch["labels"]
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    jparams = jax.tree.map(jnp.asarray, weights)
    want, _ = _greedy(
        lambda b: jlm.prefill(jparams, jcfg, b, tcfg.n_img_tokens + S + G),
        lambda st, t: jlm.decode_step(jparams, jcfg, st, jnp.asarray(t)),
        batch, G - 1)
    out, stats = tserve.generate(tparams, tcfg, batch, max_new_tokens=G)
    np.testing.assert_array_equal(
        out.numpy(), np.stack([np.argmax(w, -1) for w in want], axis=1))
    assert bool(stats.finite.all()) and stats.prefill_tokens == B * S
    # the kernel route and the plain route agree on the CPU
    plain, _ = tserve.generate(tparams, tcfg, batch, max_new_tokens=G,
                               route="plain")
    assert torch.equal(out, plain)


def test_reference_generate_serves_from_a_cache_too_small(weights):
    """The reference's ``generate`` sizes the cache S + G from the text
    alone (``repro/runtime/serve_loop.py:93``); its prefill keeps the last
    S + G of the n_img + S positions, and its decode is then off by more
    than 0.1 of max|logit| from a full forward.  The port's sizing above
    agrees with the full forward to 1e-5."""
    jcfg, tcfg = _configs()
    batch = _batch(tcfg, seed=9)
    del batch["labels"]
    jparams = jax.tree.map(jnp.asarray, weights)
    _, state = jlm.prefill(jparams, jcfg, batch, S + G)   # its size
    assert state.kv[0].shape[2] == S + G < tcfg.n_img_tokens + S
    steps, seq = _greedy(
        lambda b: jlm.prefill(jparams, jcfg, b, S + G),
        lambda st, t: jlm.decode_step(jparams, jcfg, st, jnp.asarray(t)),
        batch, G)
    jfull, _ = jlm.forward_train(jparams, jcfg, {**batch, "tokens": seq})
    jfull = np.asarray(jfull)[:, tcfg.n_img_tokens + S:]
    err = max(np.abs(g - jfull[:, j]).max()
              for j, g in enumerate(steps[1:]))
    assert err > 0.1 * np.abs(jfull).max()
    # the port refuses a cache that cannot hold the prompt
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    with pytest.raises(ValueError, match="cannot hold"):
        tlm.prefill(tparams, tcfg, batch, S + G)


def test_params_from_jax_both_trees_and_param_count(weights):
    _, tcfg = _configs()
    flat = tck.flatten(weights)
    tparams = convert.lm_params_from_jax(flat, tcfg, device=CPU)
    np.testing.assert_array_equal(tparams["img_proj"].numpy(),
                                  flat["img_proj"])
    assert tck.flatten(tparams).keys() == flat.keys()
    missing = {k: v for k, v in flat.items() if k != "img_proj"}
    with pytest.raises(KeyError, match="no leaf"):
        convert.lm_params_from_jax(missing, tcfg, device=CPU)
    full = tconfigs.get_config(ARCH)
    assert full.param_count() == jconfigs.get_config(ARCH).param_count()
    assert (full.n_img_tokens, full.d_head, full.n_kv) == (2304, 128, 8)


def test_adapter_serves_text_rows(weights):
    """``LMDecodeAdapter`` takes token rows only, as the reference's: a
    VLM's wave is its text alone, equal to ``generate`` without images."""
    _, tcfg = _configs()
    tparams = convert.lm_params_from_jax(weights, tcfg, device=CPU)
    adapter = tserve.LMDecodeAdapter(tparams, tcfg, prompt_len=S,
                                     max_new_tokens=3)
    scfg = ServeConfig(microbatch=B, n_micro=1, pipeline=None)
    toks = _batch(tcfg)["tokens"]
    out = adapter.make_wave_fn(scfg)(adapter.pack(list(toks), scfg))
    want, _ = tserve.generate(tparams, tcfg, {"tokens": toks},
                              max_new_tokens=3)
    np.testing.assert_array_equal(out, want.numpy())


def test_serve_and_train_clis_on_cpu(capsys):
    res = tserve_cli.main(["--arch", ARCH, "--smoke", "--requests", "3",
                           "--batch", "2", "--prompt-len", "6", "--gen", "3",
                           "--device", CPU])
    assert res["tokens"] == 9
    assert all(len(r) == 3 for r in res["results"])
    out = ttrain_cli.main(["--arch", ARCH, "--smoke", "--steps", "2",
                           "--global-batch", "2", "--seq", "8", "--layers",
                           "1", "--device", CPU])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert "done" in capsys.readouterr().out
