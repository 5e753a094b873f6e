"""PyTorch port, LM serving (slice 6) against the JAX package on the same
numpy inputs, with the reference's weights carried across by
``convert.lm_params_from_jax``:

* norms, RoPE, SwiGLU, ``attention_decode`` (with a rolling window and a
  static memory too) and ``update_cache_stack`` within 1e-5;
  ``attention_forward`` (the flash-attention kernel's plain version) within
  1e-5 of the reference's pure-JAX chunked attention;
* ``mamba_forward`` and ``mamba_decode_step`` (the selective-scan kernel's
  plain version in prefill) against the reference at its gates (rtol 1e-4,
  atol 1e-5: ``tests/test_models.py:243-256``);
* ``prefill`` and ``decode_step`` logits for both smoke configs within the
  reference's 2e-4 (``tests/test_models.py:79-86``); ``generate`` tokens
  equal to the reference's; an ``LMDecodeAdapter`` wave equal to
  ``generate``, padding-invariant; both CLIs with ``--device cpu``;
* the surface slices 11 and 8 ported (the sharding tables, the
  vocab-sharded loss, MoE and ``forward_train`` under sharding rules) on
  a 1-rank mesh, equal to the reference's tables and the unsharded
  functions (several ranks: ``tests/test_torch_sharding.py``,
  ``tests/test_torch_sharded_train.py``); the vlm and audio (enc-dec)
  families, bidirectional and cross attention run (their parity tests are
  ``tests/test_torch_vlm.py``, ``tests/test_torch_encdec.py`` and
  ``tests/test_torch_cross_attention.py``); Mamba-2 and the hybrid
  family run (their parity tests are ``tests/test_torch_ssd.py`` and
  ``tests/test_torch_hybrid.py``); ``forward_train`` and
  ``loss_fn`` run (their parity tests are ``tests/test_torch_lm_train.py``
  and, for the MoE family, ``tests/test_torch_moe_train.py``), and so do
  the sliding window (``tests/test_torch_swa.py``) and MoE training that
  slice 11a brought.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.runtime import serve_loop as jserve
from repro_torch import checkpoint as tck
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention import kernel as tfa_kernel
from repro_torch.kernels.ssm_scan import kernel as tss_kernel
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import serve_caps as tcaps_cli
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.runtime import mesh_utils
from repro_torch.runtime import serve_loop as tserve
from repro_torch.runtime import sharding as tsharding
from repro_torch.runtime.wave_serve import ServeConfig, WaveServer

CPU = "cpu"
ARCHS = ("granite-3-2b", "falcon-mamba-7b")
LOGIT_GATE = 2e-4          # tests/test_models.py:79-86
# the reference's Mamba block, jitted once per config (op by op it
# dispatches hundreds of small XLA calls a step)
_jmamba_forward = jax.jit(jssm.mamba_forward, static_argnames=("cfg",
                                                               "chunk"))
_jmamba_step = jax.jit(jssm.mamba_decode_step, static_argnames=("cfg",))


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol=1e-5, atol=1e-5):
    if torch.is_tensor(got):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference config, reference params, port config, port params)
    — the reference's smoke weights, carried across."""
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         tcfg, device=CPU)
    return arch, jcfg, jparams, tcfg, tparams


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_rope_and_swiglu():
    x, scale, bias = _np(0, 2, 5, 32), _np(1, 32), _np(2, 32)
    tx, ts, tb = (torch.tensor(a) for a in (x, scale, bias))
    _close(tL.rms_norm(tx, ts), jL.rms_norm(x, scale))
    _close(tL.layer_norm(tx, ts, tb), jL.layer_norm(x, scale, bias))
    _close(tL.apply_norm({"scale": ts, "bias": tb}, tx, "ln"),
           jL.apply_norm({"scale": scale, "bias": bias}, x, "ln"))
    _close(tL.rope_freqs(16, 1e4), jL.rope_freqs(16, 1e4))
    h = _np(3, 2, 7, 4, 16)
    pos = np.broadcast_to(np.arange(7), (2, 7)) + 3
    _close(tL.apply_rope(torch.tensor(h), torch.tensor(pos), 1e4),
           jL.apply_rope(h, pos, 1e4))
    mlp = {"w_gate": _np(4, 32, 48), "w_up": _np(5, 32, 48),
           "w_down": _np(6, 48, 32)}
    _close(tL.swiglu({k: torch.tensor(v) for k, v in mlp.items()}, tx),
           jL.swiglu(mlp, x))


def _attn_params(d_model=32, n_heads=4, n_kv=2, d_head=8, seed=10):
    p = {"wq": _np(seed, d_model, n_heads * d_head) * 0.3,
         "wk": _np(seed + 1, d_model, n_kv * d_head) * 0.3,
         "wv": _np(seed + 2, d_model, n_kv * d_head) * 0.3,
         "wo": _np(seed + 3, n_heads * d_head, d_model) * 0.3}
    return p, {k: torch.tensor(v) for k, v in p.items()}


def test_attention_forward_and_project_kv():
    jp, tp = _attn_params()
    x = _np(20, 2, 19, 32)
    pos = np.broadcast_to(np.arange(19), (2, 19))
    kw = dict(n_heads=4, n_kv=2, d_head=8, rope_theta=1e4)
    got = tL.attention_forward(tp, torch.tensor(x), torch.tensor(pos), **kw)
    _close(got, jL.attention_forward(jp, x, pos, chunk=19, **kw))
    for g, w in zip(tL.project_kv(tp, torch.tensor(x), torch.tensor(pos),
                                  n_kv=2, d_head=8, rope_theta=1e4),
                    jL.project_kv(jp, x, pos, n_kv=2, d_head=8,
                                  rope_theta=1e4)):
        _close(g, w)


@pytest.mark.parametrize("window,update_cache,pos", [
    (None, True, 5), (None, False, 6), (8, True, 11), (8, True, 3)],
    ids=["cache", "static-memory", "rolling-wrapped", "rolling-filling"])
def test_attention_decode_and_cache_write(window, update_cache, pos):
    jp, tp = _attn_params(seed=30)
    S = 8 if window else 12
    x = _np(31, 2, 1, 32)
    ck, cv = _np(32, 2, S, 2, 8), _np(33, 2, S, 2, 8)
    p = np.full((2,), pos, np.int32)
    kw = dict(n_heads=4, n_kv=2, d_head=8, rope_theta=1e4, window=window,
              update_cache=update_cache, kv_chunk=5)
    got = tL.attention_decode(tp, torch.tensor(x), torch.tensor(ck),
                              torch.tensor(cv), torch.tensor(p), **kw)
    want = jL.attention_decode(jp, x, ck, cv, p, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    stack = _np(34, 3, 2, S, 2, 8)
    new = _np(35, 3, 2, 1, 2, 8)
    _close(tL.update_cache_stack(torch.tensor(stack), torch.tensor(new),
                                 torch.tensor(p), window),
           jL.update_cache_stack(stack, new, p, window))


# ---------------------------------------------------------------------------
# Mamba-1
# ---------------------------------------------------------------------------

def _mamba():
    jcfg = jssm.SSMConfig(d_model=16, d_inner=32, d_state=8, dt_rank=4,
                          version=1)
    tcfg = tssm.SSMConfig(d_model=16, d_inner=32, d_state=8, dt_rank=4,
                          version=1)
    jp = jssm.init_mamba(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return jcfg, jp, tcfg, tp


def test_mamba_forward_and_decode_vs_reference():
    jcfg, jp, tcfg, tp = _mamba()
    x = _np(40, 2, 12, 16)
    y, st = tssm.mamba_forward(tp, torch.tensor(x), tcfg)
    jy, jst = _jmamba_forward(jp, x, cfg=jcfg, chunk=4)
    _close(y, jy, rtol=1e-4)
    _close(st.ssm, jst.ssm, rtol=1e-4)
    _close(st.conv, jst.conv, rtol=1e-4)
    # the port's decode steps from zero reproduce its own full forward
    state = tssm.init_ssm_state(2, tcfg, torch.float32, device=CPU)
    jstate = jssm.init_ssm_state(2, jcfg, jnp.float32)
    ys = []
    for t in range(12):
        yt, state = tssm.mamba_decode_step(tp, torch.tensor(x[:, t:t + 1]),
                                           state, tcfg)
        jyt, jstate = _jmamba_step(jp, x[:, t:t + 1], jstate, cfg=jcfg)
        _close(yt, jyt)
        ys.append(yt)
    _close(torch.cat(ys, 1), y.numpy(), rtol=1e-4)
    _close(state.ssm, st.ssm.numpy(), rtol=1e-4)


def test_mamba_forward_from_a_state():
    """The prefill kernel's h0 path: a forward over the second half from
    the first half's state equals the reference's."""
    jcfg, jp, tcfg, tp = _mamba()
    x = _np(41, 2, 10, 16)
    _, st = tssm.mamba_forward(tp, torch.tensor(x[:, :4]), tcfg)
    _, jst = _jmamba_forward(jp, x[:, :4], cfg=jcfg, chunk=4)
    y, st2 = tssm.mamba_forward(tp, torch.tensor(x[:, 4:]), tcfg, state=st)
    jy, jst2 = _jmamba_forward(jp, x[:, 4:], cfg=jcfg, chunk=2,
                                state=jst)
    _close(y, jy, rtol=1e-4)
    _close(st2.ssm, jst2.ssm, rtol=1e-4)


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def test_prefill_and_decode_logits_vs_reference(model):
    arch, jcfg, jparams, tcfg, tparams = model
    toks = _prompts(jcfg, 2, 16)
    launches = (tfa_kernel.flash_attention.launches,
                tss_kernel.selective_scan.launches)
    lg, st = tlm.prefill(tparams, tcfg, {"tokens": toks[:, :15]}, max_len=16)
    jlg, jst = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :15])},
                           max_len=16)
    _close(lg, jlg, rtol=LOGIT_GATE, atol=LOGIT_GATE)
    lg2, st2 = tlm.decode_step(tparams, tcfg, st, toks[:, 15:])
    jlg2, jst2 = jlm.decode_step(jparams, jcfg, jst,
                                 jnp.asarray(toks[:, 15:]))
    _close(lg2, jlg2, rtol=LOGIT_GATE, atol=LOGIT_GATE)
    assert lg.shape == (2, tcfg.vocab_padded)
    assert st2.pos.tolist() == [16, 16]
    # the decode step equals a prefill over the whole prompt
    full, _ = tlm.prefill(tparams, tcfg, {"tokens": toks}, max_len=16)
    _close(lg2, full.numpy(), rtol=LOGIT_GATE, atol=LOGIT_GATE)
    # on the CPU the wrappers ran their plain versions, not the kernels
    assert launches == (tfa_kernel.flash_attention.launches,
                        tss_kernel.selective_scan.launches)


def test_generate_matches_reference(model):
    arch, jcfg, jparams, tcfg, tparams = model
    toks = _prompts(jcfg, 3, 8, seed=1)
    out, stats = tserve.generate(tparams, tcfg, {"tokens": toks}, 5)
    jout, jstats = jserve.generate(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)}, 5)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert (stats.prefill_tokens, stats.decode_tokens, stats.steps) == (
        jstats.prefill_tokens, jstats.decode_tokens, jstats.steps)
    eos = int(out[0, 1])
    e_out, _ = tserve.generate(tparams, tcfg, {"tokens": toks}, 5,
                               eos_id=eos)
    je_out, _ = jserve.generate(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                5, eos_id=eos)
    np.testing.assert_array_equal(e_out.numpy(), np.asarray(je_out))


def test_lm_adapter_wave_matches_generate_and_pads_invariantly(model):
    arch, jcfg, jparams, tcfg, tparams = model
    adapter = tserve.LMDecodeAdapter(tparams, tcfg, prompt_len=6,
                                     max_new_tokens=3)
    scfg = ServeConfig(microbatch=2, n_micro=2, pipeline=None)
    wave = adapter.make_wave_fn(scfg)
    prompts = adapter.validate(_prompts(tcfg, 4, 6, seed=2))
    full = adapter.unpack(wave(adapter.pack(list(prompts), scfg)), 4)
    want, _ = tserve.generate(tparams, tcfg, {"tokens": prompts}, 3)
    np.testing.assert_array_equal(np.stack(full), want.numpy())
    part = adapter.unpack(wave(adapter.pack(list(prompts[:3]), scfg)), 3)
    np.testing.assert_array_equal(np.stack(part), want.numpy()[:3])
    with pytest.raises(ValueError, match="prompt shape"):
        adapter.validate(_prompts(tcfg, 2, 5))
    with pytest.raises(ValueError, match="token ids must be in"):
        adapter.validate(np.full((1, 6), tcfg.vocab))
    server = WaveServer(adapter, cfg=scfg)
    server.submit(prompts)
    done = server.drain()
    assert sorted(c.rid for c in done) == [0, 1, 2, 3]
    assert server.metrics.summary()["failed"] == 0


def test_serve_cli_on_cpu(capsys):
    for arch in ARCHS:
        out = tserve_cli.main(["--arch", arch, "--smoke", "--device", CPU,
                               "--requests", "3", "--batch", "2",
                               "--prompt-len", "5", "--gen", "4"])
        assert out["tokens"] == 12 and len(out["results"]) == 3
    assert "served 3 requests (12 tokens)" in capsys.readouterr().out


def test_serve_caps_cli_model_lm_on_cpu(capsys):
    s = tcaps_cli.main(["--smoke", "--model", "lm", "--device", CPU,
                        "--requests", "10"])
    assert s["completed"] == 10 and s["failed"] == 0 and s["shed"] == 0
    assert "served 10 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# configs, conversion and the surface of later slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_and_param_counts_match_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for f in ("name", "family", "n_layers", "d_model", "vocab", "n_heads",
              "n_kv", "d_head", "d_ff", "norm_type", "rope_theta",
              "qk_norm", "vocab_padded", "block_kind", "sliding_window",
              "enc_dec", "vocab_pad_to", "remat"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    if jcfg.ssm is not None:
        for f in tcfg.ssm._fields:
            assert getattr(tcfg.ssm, f) == getattr(jcfg.ssm, f), f
    assert tlm.SSM_CHUNK == jcfg.ssm_chunk
    assert tcfg.dtype == torch.bfloat16
    assert tcfg.param_count() == jcfg.param_count()
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()


def test_registry_lists_every_arch_and_defers_eight():
    # slice 11 b–d brought all eight: none is deferred, every arch resolves
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert not hasattr(tbase, "LATER_ARCHS")
    for name in ("phi3-medium-14b", "mistral-large-123b", "stablelm-12b",
                 "zamba2-7b", "llava-next-mistral-7b",
                 "seamless-m4t-large-v2"):
        assert tconfigs.get_smoke_config(name).name == f"{name}-smoke"
        assert tconfigs.get_config(name).name == name
    for name in tconfigs.list_archs():
        assert tconfigs.get_config(name).name == name
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-7")


def test_lm_params_from_jax_checks_every_leaf(model):
    arch, jcfg, jparams, tcfg, _ = model
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jparams)}
    tp = convert.lm_params_from_jax(flat, tcfg, device=CPU)
    np.testing.assert_array_equal(tp["embed"]["tok"].numpy(),
                                  flat["embed/tok"])
    missing = dict(flat)
    missing.pop("final_norm/scale")
    with pytest.raises(KeyError, match="no leaf"):
        convert.lm_params_from_jax(missing, tcfg, device=CPU)
    with pytest.raises(KeyError, match="no counterpart"):
        convert.lm_params_from_jax({**flat, "extra": np.zeros(1)}, tcfg,
                                   device=CPU)
    bad = {**flat, "final_norm/scale": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="final_norm/scale"):
        convert.lm_params_from_jax(bad, tcfg, device=CPU)


def test_bf16_leaves_carry_across_exactly():
    jcfg = jconfigs.get_smoke_config("granite-3-2b")
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": jnp.bfloat16})
    tcfg = tconfigs.get_smoke_config("granite-3-2b")
    tcfg = type(tcfg)(**{**tcfg.__dict__, "dtype": torch.bfloat16})
    jparams = jax.tree.map(np.asarray,
                           jlm.init_params(jcfg, jax.random.PRNGKey(2)))
    tp = convert.lm_params_from_jax(jparams, tcfg, device=CPU)
    wq = tp["layers"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        jparams["layers"]["attn"]["wq"].astype(np.float32))


def test_later_slices_raise():
    dense = tconfigs.get_smoke_config("granite-3-2b")
    ssm = tconfigs.get_smoke_config("falcon-mamba-7b")
    # the vlm and audio (enc-dec) families run now
    # (tests/test_torch_vlm.py, tests/test_torch_encdec.py); enc_dec goes
    # with the audio family and only with it
    for arch in ("llava-next-mistral-7b", "seamless-m4t-large-v2"):
        cfg = tconfigs.get_smoke_config(arch)
        batch = {"tokens": np.zeros((1, 2), np.int32)}
        if cfg.enc_dec:
            batch["frames"] = np.zeros((1, 3, cfg.d_model), np.float32)
        logits, state = tlm.prefill(tlm.init_params(cfg, device=CPU), cfg,
                                    batch, 4)
        assert logits.shape == (1, cfg.vocab_padded)
        assert (state.cross is not None) == cfg.enc_dec
    for kw in ({"enc_dec": True}, {"family": "audio"}):
        with pytest.raises(ValueError, match="encoder-decoder"):
            tlm.init_params(type(dense)(**{**dense.__dict__, **kw}),
                            device=CPU)
    # a sliding window now runs: a 12-token prompt under a window of 8
    # leaves an 8-slot cache that rolls
    swa = type(dense)(**{**dense.__dict__, "sliding_window": 8})
    logits, state = tlm.prefill(tlm.init_params(swa, device=CPU), swa,
                                {"tokens": _prompts(swa, 1, 12)}, 16)
    assert logits.shape == (1, swa.vocab_padded)
    assert state.kv[0].shape[2] == 8 and int(state.pos[0]) == 12
    with pytest.raises(ValueError, match="needs attention"):
        tlm.init_params(type(ssm)(**{**ssm.__dict__, "sliding_window": 8}),
                        device=CPU)
    # Mamba-2 and the hybrid family run now (tests/test_torch_ssd.py,
    # tests/test_torch_hybrid.py)
    m2 = type(ssm)(**{**ssm.__dict__, "ssm": ssm.ssm._replace(
        version=2, headdim=32)})
    logits, state = tlm.prefill(tlm.init_params(m2, device=CPU), m2,
                                {"tokens": _prompts(m2, 1, 5)}, 8)
    assert logits.shape == (1, m2.vocab_padded) and state.kv is None
    assert "a_log_h" in tssm.init_mamba(torch.Generator().manual_seed(0),
                                        m2.ssm, device=CPU)
    hybrid = tconfigs.get_smoke_config("zamba2-7b")
    logits, state = tlm.prefill(tlm.init_params(hybrid, device=CPU), hybrid,
                                {"tokens": _prompts(hybrid, 1, 5)}, 8)
    assert state.kv[0].shape[0] == 2 and state.ssm.ssm.shape[0] == 5
    # MoE serves and trains (forward_train returns the summed load-balance
    # aux); the sharding tables, moe_forward and forward_train under
    # sharding rules, and the vocab-sharded loss run (slice 11 and 8: on
    # meshes of several ranks in tests/test_torch_sharding.py and
    # tests/test_torch_sharded_train.py), here on a 1-rank mesh
    moe = tconfigs.get_smoke_config("qwen3-moe-30b-a3b")
    moe_params = tlm.init_params(moe, device=CPU)
    toks2 = {"tokens": np.zeros((1, 2), np.int32)}
    logits, aux = tlm.forward_train(moe_params, moe, toks2)
    assert logits.shape == (1, 2, moe.vocab_padded) and float(aux) > 0
    jdense = jconfigs.get_smoke_config("granite-3-2b")
    want = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(
                jlm.param_logical_axes(jdense),
                is_leaf=lambda t: isinstance(t, tuple))}
    assert tck.flatten(tlm.param_logical_axes(dense)) == want
    mesh = mesh_utils.make_mesh((1, 1), ("data", "model"), device=CPU)
    specs = tck.flatten(tlm.param_shardings(
        dense, tsharding.make_rules(dense, mesh, "train")))
    assert tuple(specs["layers/attn/wq"]) == (None, "data", "model")
    rules = tsharding.make_rules(moe, mesh, "train")
    layer0 = {k: v[0] for k, v in moe_params["layers"]["moe"].items()}
    with torch.no_grad():
        x = torch.ones(1, 2, moe.d_model)
        y, a = tmoe.moe_forward(layer0, x, moe.moe, rules=rules)
        y0, a0 = tmoe.moe_forward(layer0, x, moe.moe)
        assert torch.equal(y, y0) and torch.equal(a, a0)
        lg, lb = torch.tensor(_np(60, 1, 2, 8)), torch.tensor([[3, 7]])
        torch.testing.assert_close(
            tL.sharded_softmax_xent(lg, lb, mesh, "model"),
            tL.sharded_softmax_xent(lg, lb), rtol=0, atol=1e-6)
        got, got_aux = tlm.forward_train(
            tlm.shard_params(moe_params, moe, rules), moe, toks2, rules)
        torch.testing.assert_close(got, logits, rtol=0, atol=1e-5)
        assert torch.equal(got_aux, aux)
    with pytest.raises(ValueError, match="needs an MoEConfig"):
        tlm.init_params(type(dense)(**{**dense.__dict__, "family": "moe"}),
                        device=CPU)
    tparams = tlm.init_params(dense, device=CPU)
    toks = _prompts(dense, 1, 4)
    logits, aux = tlm.forward_train(tparams, dense, {"tokens": toks})
    assert logits.shape == (1, 4, dense.vocab_padded) and float(aux) == 0.0
    loss, metrics = tlm.loss_fn(tparams, dense, {"tokens": toks,
                                                 "labels": toks})
    assert bool(torch.isfinite(loss)) and float(metrics["tokens"]) == 4
    jp, tp = _attn_params()
    x = torch.tensor(_np(50, 1, 4, 32))
    pos = torch.arange(4)[None]
    # bidirectional and cross attention run on every route (parity:
    # tests/test_torch_cross_attention.py); cross attention over a causal
    # mask is refused
    mem = torch.tensor(_np(51, 1, 6, 2, 8))
    for kw in ({"causal": False}, {"causal": False, "kv_override": (mem, mem),
                                   "use_rope": False}):
        outs = [tL.attention_forward(tp, x, pos, n_heads=4, n_kv=2, d_head=8,
                                     rope_theta=1e4, route=r, **kw)
                for r in tL.ROUTES]
        assert outs[0].shape == (1, 4, 32)
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
    with pytest.raises(ValueError, match="causal attention needs"):
        tL.attention_forward(tp, x, pos, n_heads=4, n_kv=2, d_head=8,
                             rope_theta=1e4, kv_override=(mem, mem))
    # a window of 2 runs on every route, and differs from causal attention
    outs = [tL.attention_forward(tp, x, pos, n_heads=4, n_kv=2, d_head=8,
                                 rope_theta=1e4, window=2, route=r)
            for r in tL.ROUTES]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    causal = tL.attention_forward(tp, x, pos, n_heads=4, n_kv=2, d_head=8,
                                  rope_theta=1e4)
    assert torch.equal(outs[0][:, :2], causal[:, :2])
    assert not torch.allclose(outs[0][:, 2:], causal[:, 2:])


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = tconfigs.get_smoke_config("granite-3-2b")
    for call in (lambda: tlm.init_params(cfg),
                 lambda: tlm.init_decode_state(cfg, 1, 4),
                 lambda: tserve_cli.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
