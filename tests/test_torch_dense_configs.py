"""PyTorch port, the dense configurations of slice 11 (phi3-medium-14b,
mistral-large-123b, stablelm-12b) and the hybrid zamba2-7b's
configuration against the JAX package's.

* each full configuration's fields, and ``param_count()`` from shapes
  alone, equal the reference's (14,659,507,200; 122,610,069,504;
  12,143,339,520; 6,820,171,344);
* on each dense smoke config, with the reference's weights carried across:
  ``prefill`` and ``decode_step`` logits within the reference's 2e-4
  (``tests/test_models.py:79-86``) and ``generate`` tokens equal to the
  reference's (stablelm's LayerNorm with bias, mistral-large's rope θ
  1e6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import lm as jlm
from repro.runtime import serve_loop as jserve
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import lm as tlm
from repro_torch.runtime import serve_loop as tserve

CPU = "cpu"
DENSE = ("phi3-medium-14b", "mistral-large-123b", "stablelm-12b")
PARAMS = {"phi3-medium-14b": 14_659_507_200,
          "mistral-large-123b": 122_610_069_504,
          "stablelm-12b": 12_143_339_520,
          "zamba2-7b": 6_820_171_344}
LOGIT_GATE = 2e-4          # tests/test_models.py:79-86
FIELDS = ("name", "family", "n_layers", "d_model", "vocab", "n_heads",
          "n_kv", "d_head", "d_ff", "norm_type", "rope_theta", "qk_norm",
          "vocab_padded", "block_kind", "sliding_window", "enc_dec",
          "vocab_pad_to", "remat", "attn_every")


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_full_config_fields_and_param_count_match_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for f in FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    if jcfg.ssm is not None:
        for f in tcfg.ssm._fields:
            assert getattr(tcfg.ssm, f) == getattr(jcfg.ssm, f), f
        assert tcfg.ssm.n_heads == jcfg.ssm.n_heads
    assert tcfg.dtype == torch.bfloat16
    assert tcfg.param_count() == jcfg.param_count() == PARAMS[arch]
    smoke_j, smoke_t = (jconfigs.get_smoke_config(arch),
                        tconfigs.get_smoke_config(arch))
    for f in FIELDS:
        assert getattr(smoke_t, f) == getattr(smoke_j, f), f
    assert smoke_t.dtype == torch.float32


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                         tcfg, device=CPU)
    return jcfg, jparams, tcfg, tparams


def test_prefill_and_decode_logits_vs_reference(model):
    jcfg, jparams, tcfg, tparams = model
    toks = _prompts(tcfg, 2, 16)
    lg, st = tlm.prefill(tparams, tcfg, {"tokens": toks[:, :14]}, max_len=16)
    jlg, jst = jlm.prefill(jparams, jcfg,
                           {"tokens": jnp.asarray(toks[:, :14])}, max_len=16)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=LOGIT_GATE,
                               atol=LOGIT_GATE)
    for t in (14, 15):
        lg, st = tlm.decode_step(tparams, tcfg, st, toks[:, t:t + 1])
        jlg, jst = jlm.decode_step(jparams, jcfg, jst,
                                   jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   rtol=LOGIT_GATE, atol=LOGIT_GATE)
    assert st.kv[0].shape[0] == tcfg.n_layers


def test_generate_matches_reference(model):
    jcfg, jparams, tcfg, tparams = model
    toks = _prompts(tcfg, 3, 8, seed=1)
    out, _ = tserve.generate(tparams, tcfg, {"tokens": toks}, 6)
    jout, _ = jserve.generate(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
