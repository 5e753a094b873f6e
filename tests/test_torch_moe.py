"""PyTorch port, MoE: ``models.moe`` and the ``moe`` LM family against the
JAX package on the same numpy inputs and weights:

* ``moe_forward`` where expert capacity drops tokens, y and the aux term
  within 1e-5 (``FWD_ATOL``) of the reference, the drop actually taking
  place; with sub-experts; the dense oracle where nothing drops;
* ties: zero-padded blocks give every expert the same router score, and
  the stable top-k sends them to the reference's experts, so the real
  tokens dropped behind them are the reference's (y within 1e-5);
* two calls bitwise equal (the combine has a fixed order);
* qwen3-moe-30b-a3b: the full config's parameter count equals the
  reference's; the smoke config's prefill and decode logits against the
  reference's ``prefill``/``decode_step`` on converted weights (1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

FWD_ATOL = 1e-5
CPU = "cpu"


def _setup(seed=0, **kw):
    cfg = dict(d_model=16, d_ff=32, n_experts=8, top_k=2)
    cfg.update(kw)
    jcfg = jmoe.MoEConfig(**cfg)
    jparams = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg,
                            dtype=jnp.float32)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    return jcfg, jparams, tmoe.MoEConfig(**cfg), tparams


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _kept(cfg, params, x):
    """Tokens routed to each expert beyond its capacity, by the
    reference's own routing (how many the dispatch drops)."""
    x2d = x.reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(x2d) @ params["router"], axis=-1)
    _, ids = jax.lax.top_k(probs, cfg.top_k)
    counts = np.bincount(np.asarray(ids).ravel(), minlength=cfg.n_experts)
    cap = jmoe._capacity(x2d.shape[0], cfg)
    return int(np.maximum(counts - cap, 0).sum()), cap


def _compare(jcfg, jparams, tcfg, tparams, x):
    want, want_aux = jmoe.moe_forward(jparams, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got, aux = tmoe.moe_forward(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=0)
    assert abs(float(aux) - float(want_aux)) <= FWD_ATOL
    return got


@pytest.mark.parametrize("sub_experts", [1, 2])
def test_moe_forward_with_capacity_drops_matches_reference(sub_experts):
    jcfg, jparams, tcfg, tparams = _setup(capacity_factor=1.0,
                                          sub_experts=sub_experts)
    x = _x((4, 16, 16), seed=sub_experts)
    dropped, cap = _kept(jcfg, jparams, x)
    assert cap == 16 and dropped > 0          # the capacity bites
    _compare(jcfg, jparams, tcfg, tparams, x)


def test_zero_blocks_tie_like_the_reference():
    """Zero tokens score every expert alike: ``lax.top_k`` sends them to
    experts 0..k-1.  Arriving first, they fill those experts' capacity, so
    the real tokens dropped behind them must be the reference's."""
    jcfg, jparams, tcfg, tparams = _setup(seed=3, capacity_factor=1.0)
    x = _x((4, 16, 16), seed=4)
    x[:2] = 0.0                               # two zero-padded blocks
    probs = jax.nn.softmax(jnp.asarray(x[0, :1]) @ jparams["router"], -1)
    assert len(set(np.asarray(probs).ravel().tolist())) == 1   # a tie
    _, ids = tmoe._top_k(torch.softmax(torch.zeros(1, 8), -1), 2)
    assert ids.tolist() == [[0, 1]]
    got = _compare(jcfg, jparams, tcfg, tparams, x)
    assert torch.count_nonzero(got[:2]) == 0


def test_moe_forward_matches_dense_oracle_without_drops():
    jcfg, jparams, tcfg, tparams = _setup(seed=5, capacity_factor=4.0)
    x = _x((2, 8, 16), seed=6)
    with torch.no_grad():
        got, _ = tmoe.moe_forward(tparams, torch.from_numpy(x), tcfg)
        oracle, _ = tmoe.moe_forward_dense_oracle(tparams,
                                                  torch.from_numpy(x), tcfg)
    want, _ = jmoe.moe_forward_dense_oracle(jparams, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want),
                               atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=FWD_ATOL,
                               rtol=0)


def test_moe_forward_is_bitwise_repeatable():
    _, _, tcfg, tparams = _setup(seed=7, capacity_factor=1.0)
    x = torch.from_numpy(_x((3, 16, 16), seed=8))
    with torch.no_grad():
        a, aux_a = tmoe.moe_forward(tparams, x, tcfg)
        b, aux_b = tmoe.moe_forward(tparams, x, tcfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_init_moe_shapes_and_dtypes_match_reference():
    jcfg = jmoe.MoEConfig(d_model=16, d_ff=32, n_experts=4, top_k=2,
                          sub_experts=2)
    want = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    got = tmoe.init_moe(torch.Generator().manual_seed(0),
                        tmoe.MoEConfig(*jcfg), device=CPU)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    assert got["router"].dtype == torch.float32
    assert got["w_gate"].dtype == torch.bfloat16
    jw = jmoe.logical_expert_weights(jax.tree.map(np.asarray, want), jcfg)
    tw = tmoe.logical_expert_weights(
        {k: torch.from_numpy(np.array(v, np.float32))
         for k, v in want.items()}, tmoe.MoEConfig(*jcfg))
    for j, t in zip(jw, tw):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j, np.float32))


def test_qwen3_full_config_matches_reference():
    jcfg, tcfg = jget_config("qwen3-moe-30b-a3b"), get_config(
        "qwen3-moe-30b-a3b")
    for f in ("name", "family", "n_layers", "d_model", "vocab", "n_heads",
              "n_kv", "d_head", "d_ff", "rope_theta", "qk_norm",
              "block_kind"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tuple(tcfg.moe) == tuple(jcfg.moe)
    assert tcfg.param_count() == jcfg.param_count() == 30_532_646_912


def test_qwen3_smoke_prefill_and_decode_match_reference():
    jcfg = jget_smoke_config("qwen3-moe-30b-a3b")
    tcfg = get_smoke_config("qwen3-moe-30b-a3b")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         tcfg, device=CPU)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (3, 9),
                                             dtype=np.int32)
    jl, jstate = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             12)
    with torch.inference_mode():
        tl, tstate = tlm.prefill(tparams, tcfg,
                                 {"tokens": torch.from_numpy(toks)}, 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_ATOL,
                               rtol=0)
    nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    for _ in range(2):
        jl, jstate = jlm.decode_step(jparams, jcfg, jstate,
                                     jnp.asarray(nxt))
        with torch.inference_mode():
            tl, tstate = tlm.decode_step(tparams, tcfg, tstate,
                                         torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=FWD_ATOL, rtol=0)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
