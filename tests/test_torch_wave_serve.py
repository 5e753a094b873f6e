"""PyTorch port, WaveServe adapters: the behaviours of
``tests/test_wave_serve.py`` re-run against the port, on weights carried
across from the reference:

* the LM adapter's wave against the reference's ``generate`` (tokens
  equal) and its padding bit-invariance;
* the MoE adapter's wave against the reference's ``moe_forward`` (≤ 1e-5)
  and its padding bit-invariance; the "moe" Router algorithm through
  ``build_router`` against ``moe_forward``, and its ``moe_cfg`` error;
* the CapsNet adapter's mask-mediated padding invariance;
* chaos through the LM adapter — a transient error, a NaN wave and a
  replica crash healed through a fleet — with zero lost requests.  The
  port's decode writes its caches in place; a retried wave re-runs
  ``generate`` from its prompts with a fresh state, and the retried
  requests' tokens equal the reference's;
* a mixed CapsNet + LM + MoE fleet whose per-workload books balance;
* one LM wave function shared by threads (the fleet's replicas share it:
  the port's counterpart of the reference's ``_LM_FNS`` lock test);
* the classifier deprecation shim against the direct forward.

Every thread a test starts is joined with a timeout.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jget_smoke_config
from repro.configs.caps_benchmarks import CapsConfig
from repro.models import capsnet as jcapsnet
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.runtime import serve_loop as jserve_loop
from repro_torch import convert
from repro_torch.configs import caps_benchmarks as tconfigs
from repro_torch.configs import get_smoke_config
from repro_torch.core.router import RouterSpec, build_router, get_algorithm
from repro_torch.models import capsnet
from repro_torch.models import moe as moe_lib
from repro_torch.runtime import serve_loop
from repro_torch.runtime.caps_fleet import CapsFleet, TenantPolicy
from repro_torch.runtime.caps_serve import CapsAdapter
from repro_torch.runtime.elastic import ElasticPolicy
from repro_torch.runtime.faults import (FaultEvent, FaultPlan, chaos_wave_fn,
                                        fleet_wrap)
from repro_torch.runtime.serve_loop import LMDecodeAdapter, MoEAdapter
from repro_torch.runtime.wave_serve import ServeConfig, WaveServer

CPU = "cpu"
JOIN_S = 60
PROMPT_LEN = 6
MAX_NEW = 3
SEQ_LEN = 4


@pytest.fixture(scope="module")
def lm_setup():
    jcfg = jget_smoke_config("granite-3-2b")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("granite-3-2b")
    params = convert.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        cfg, device=CPU)
    return cfg, params, jcfg, jparams


def moe_params_from_jax(jparams) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}


@pytest.fixture(scope="module")
def moe_setup():
    # capacity_factor >= n_experts/top_k: capacity == token count, so no
    # token is ever dropped and padding bit-invariance is exact
    jcfg = jmoe.MoEConfig(d_model=16, d_ff=32, n_experts=4, top_k=2,
                          capacity_factor=2.0)
    jparams = jmoe.init_moe(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    cfg = moe_lib.MoEConfig(*jcfg)
    return cfg, moe_params_from_jax(jparams), jcfg, jparams


@pytest.fixture(scope="module")
def caps_setup():
    cfg = CapsConfig("Caps-tiny", "synthetic", 8, 72, 10, 2,
                     caps_channels=2, conv_channels=16)
    params = jcapsnet.init_capsnet(jax.random.PRNGKey(2), cfg)
    # non-zero conv biases so pad lanes produce non-zero votes: padding
    # invariance genuinely depends on the adapter's lane mask
    params["primary"]["conv1"]["b"] = params["primary"]["conv1"]["b"] + 0.1
    tcfg = tconfigs.CapsConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__})
    net = convert.capsnet_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                   device=CPU)
    return net, cfg, params


def _prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (n, PROMPT_LEN), dtype=np.int32)


def _blocks(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, SEQ_LEN, cfg.d_model)).astype(np.float32)


def _reference_tokens(lm_setup, prompts):
    _, _, jcfg, jparams = lm_setup
    out, _ = jserve_loop.generate(jparams, jcfg,
                                  {"tokens": jnp.asarray(prompts)}, MAX_NEW)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# Adapter contracts: wave == direct call, padding bit-invariance
# ---------------------------------------------------------------------------

def test_lm_adapter_wave_matches_generate(lm_setup):
    cfg, params, *_ = lm_setup
    adapter = LMDecodeAdapter(params, cfg, prompt_len=PROMPT_LEN,
                              max_new_tokens=MAX_NEW)
    scfg = ServeConfig(microbatch=2, n_micro=2, pipeline=None)
    prompts = _prompts(cfg, scfg.wave_lanes)
    wave = adapter.make_wave_fn(scfg)
    results = adapter.unpack(wave(adapter.pack(list(prompts), scfg)),
                             len(prompts))
    assert all(r.dtype == np.int32 for r in results)
    np.testing.assert_array_equal(np.stack(results),
                                  _reference_tokens(lm_setup, prompts))


def test_lm_adapter_padding_bit_invariant(lm_setup):
    cfg, params, *_ = lm_setup
    adapter = LMDecodeAdapter(params, cfg, prompt_len=PROMPT_LEN,
                              max_new_tokens=MAX_NEW)
    scfg = ServeConfig(microbatch=2, n_micro=2, pipeline=None)
    wave = adapter.make_wave_fn(scfg)
    prompts = _prompts(cfg, 3)                 # 3 real lanes, 1 padded
    padded = adapter.unpack(wave(adapter.pack(list(prompts), scfg)), 3)
    full = _prompts(cfg, scfg.wave_lanes)
    full[:3] = prompts
    unpadded = adapter.unpack(wave(adapter.pack(list(full), scfg)), 3)
    for a, b in zip(padded, unpadded):
        np.testing.assert_array_equal(a, b)


def test_moe_adapter_wave_matches_moe_forward(moe_setup):
    cfg, params, jcfg, jparams = moe_setup
    adapter = MoEAdapter(params, cfg, seq_len=SEQ_LEN)
    scfg = ServeConfig(microbatch=2, n_micro=2, pipeline=None)
    blocks = _blocks(cfg, scfg.wave_lanes)
    wave = adapter.make_wave_fn(scfg)
    results = adapter.unpack(wave(adapter.pack(list(blocks), scfg)),
                             len(blocks))
    direct, _aux = jmoe.moe_forward(jparams, jnp.asarray(blocks), jcfg)
    np.testing.assert_allclose(np.stack(results), np.asarray(direct),
                               atol=1e-5)


def test_moe_adapter_padding_bit_invariant(moe_setup):
    cfg, params, *_ = moe_setup
    adapter = MoEAdapter(params, cfg, seq_len=SEQ_LEN)
    scfg = ServeConfig(microbatch=2, n_micro=2, pipeline=None)
    wave = adapter.make_wave_fn(scfg)
    blocks = _blocks(cfg, 3)
    padded = adapter.unpack(wave(adapter.pack(list(blocks), scfg)), 3)
    full = _blocks(cfg, scfg.wave_lanes, seed=9)
    full[:3] = blocks
    unpadded = adapter.unpack(wave(adapter.pack(list(full), scfg)), 3)
    np.testing.assert_array_equal(np.stack(padded), np.stack(unpadded))
    # and a wave is bitwise repeatable: the combine has a fixed order
    again = adapter.unpack(wave(adapter.pack(list(blocks), scfg)), 3)
    np.testing.assert_array_equal(np.stack(padded), np.stack(again))


def test_caps_adapter_padding_bit_invariant(caps_setup):
    # caps routing couples batch lanes through the shared b logits, so the
    # invariance is mask-mediated: a padded lane's *content* must be
    # bit-irrelevant, and the padded wave must match an unpadded reference
    net, cfg, _ = caps_setup
    adapter = CapsAdapter(net)
    scfg = ServeConfig(microbatch=4, n_micro=1, pipeline="software")
    wave = adapter.make_wave_fn(scfg)
    rng = np.random.default_rng(0)
    shape = (cfg.image_hw, cfg.image_hw, cfg.image_channels)
    images = rng.random((3,) + shape, np.float32)
    micro = adapter.pack(list(images), scfg)
    padded = wave(micro).numpy()
    garbage = micro["images"].clone()
    garbage.reshape(scfg.wave_lanes, *shape)[3] = torch.from_numpy(
        rng.random(shape, np.float32))
    poked = wave({"images": garbage, "mask": micro["mask"]}).numpy()
    np.testing.assert_array_equal(padded, poked)
    ref_cfg = ServeConfig(microbatch=3, n_micro=1, pipeline="software")
    ref = adapter.make_wave_fn(ref_cfg)(
        adapter.pack(list(images), ref_cfg)).numpy()
    np.testing.assert_array_equal(padded.reshape(-1, padded.shape[-1])[:3],
                                  ref.reshape(-1, ref.shape[-1]))


def test_moe_algorithm_registered_through_build_router(moe_setup):
    cfg, params, jcfg, jparams = moe_setup
    algo = get_algorithm("moe")
    assert algo.sharded_dims == ("E",) and algo.num_inputs == 5
    spec = RouterSpec(algorithm="moe", options=(("moe_cfg", cfg),))
    router = build_router(spec, device=CPU)
    x = _blocks(cfg, 2)
    x2d = torch.from_numpy(x.reshape(2 * SEQ_LEN, cfg.d_model))
    y, aux = router(x2d, *moe_lib.router_args(params))
    direct, direct_aux = jmoe.moe_forward(jparams, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(direct).reshape(2 * SEQ_LEN, cfg.d_model),
        atol=1e-6)
    assert float(aux) == pytest.approx(float(direct_aux), rel=1e-6)
    # the static MoEConfig is mandatory
    with pytest.raises(ValueError, match="moe_cfg"):
        build_router(RouterSpec(algorithm="moe"), device=CPU)(
            x2d, *moe_lib.router_args(params))


# ---------------------------------------------------------------------------
# Generic server + chaos through the LM adapter (zero lost requests)
# ---------------------------------------------------------------------------

def _drive(server, items_fn, total, chunk=3):
    submitted = 0
    while submitted < total:
        n = min(chunk, total - submitted)
        server.submit(items_fn(n, submitted))
        submitted += n
    return server.drain()


def test_lm_adapter_serves_through_wave_server(lm_setup):
    cfg, params, *_ = lm_setup
    adapter = LMDecodeAdapter(params, cfg, prompt_len=PROMPT_LEN,
                              max_new_tokens=MAX_NEW)
    server = WaveServer(adapter,
                        cfg=ServeConfig(microbatch=2, n_micro=2,
                                        pipeline=None))
    done = _drive(server, lambda n, s: _prompts(cfg, n, seed=s), 10)
    m = server.metrics
    assert m.submitted == m.completed == len(done) == 10
    assert server.pending() == 0
    by_rid = {c.rid: c.pred for c in done}
    np.testing.assert_array_equal(
        np.stack([by_rid[r] for r in (0, 1, 2)]),
        _reference_tokens(lm_setup, _prompts(cfg, 3, seed=0)))


def test_lm_chaos_error_and_corrupt_zero_loss(lm_setup):
    cfg, params, *_ = lm_setup
    adapter = LMDecodeAdapter(params, cfg, prompt_len=PROMPT_LEN,
                              max_new_tokens=MAX_NEW)
    scfg = ServeConfig(microbatch=2, n_micro=2, pipeline=None)
    wrapped = chaos_wave_fn(adapter.make_wave_fn(scfg),
                            FaultPlan((FaultEvent(0, "error"),
                                       FaultEvent(2, "corrupt"))))
    server = WaveServer(adapter, cfg=scfg, wave_fn=wrapped)
    done = _drive(server, lambda n, s: _prompts(cfg, n, seed=s), 8)
    m = server.metrics
    # transient error retried, NaN wave quarantined through the reference
    # re-run — every request completes, none lost or failed
    assert m.completed == len(done) == 8 and m.failed == 0
    assert m.wave_errors >= 1 and m.retried >= 1 and m.requeued >= 1
    assert m.guard_trips >= 1
    assert m.submitted == m.completed + m.shed + m.failed
    assert server.pending() == 0
    # the retried and the quarantined requests carry the reference's tokens
    by_rid = {c.rid: c.pred for c in done}
    np.testing.assert_array_equal(
        np.stack([by_rid[r] for r in (0, 1, 2)]),
        _reference_tokens(lm_setup, _prompts(cfg, 3, seed=0)))


def test_lm_chaos_crash_heals_through_fleet(lm_setup):
    cfg, params, *_ = lm_setup
    adapter = LMDecodeAdapter(params, cfg, prompt_len=PROMPT_LEN,
                              max_new_tokens=MAX_NEW)
    scfg = ServeConfig(microbatch=2, n_micro=1, pipeline=None,
                       queue_order="deadline")
    fleet = CapsFleet(models={"lm": (adapter, scfg)},
                      tenants=(TenantPolicy("t0", slo_s=60.0),),
                      policy=ElasticPolicy(min_replicas=2, max_replicas=2),
                      wave_wrap=fleet_wrap(
                          {"lm/r0": FaultPlan((FaultEvent(0, "crash"),))}))
    for s in range(4):
        fleet.submit(_prompts(cfg, 3, seed=s), tenant="t0", model="lm")
    done = fleet.drain()
    fleet.health_check()
    done += fleet.drain()
    s = fleet.summary()
    assert s["pending"] == 0 and s["failed"] == 0
    assert s["submitted"] == s["completed"] + s["shed"]
    assert s["completed"] == 12            # zero lost requests
    assert s["evacuated"] == s["adopted"] and s["evacuated"] > 0
    assert len(s["health_events"]) == 1    # the crash was buried once
    # every request, adopted ones too, carries the reference's tokens
    want = np.concatenate([_reference_tokens(lm_setup,
                                             _prompts(cfg, 3, seed=s))
                           for s in range(4)])
    got = sorted((c.pred.tolist() for _, c in done))
    assert got == sorted(want.tolist())


# ---------------------------------------------------------------------------
# Mixed fleet: CapsNet + LM + MoE groups behind one front-end
# ---------------------------------------------------------------------------

def test_mixed_fleet_serves_all_three_workloads(caps_setup, lm_setup,
                                                moe_setup):
    net, caps_cfg, _ = caps_setup
    arch, lm_params, *_ = lm_setup
    moe_cfg, moe_params, *_ = moe_setup
    scfg = ServeConfig(microbatch=2, n_micro=2, pipeline=None,
                       queue_order="deadline")
    caps_scfg = ServeConfig(microbatch=2, n_micro=2, pipeline="software",
                            queue_order="deadline")
    fleet = CapsFleet(
        net,
        models={
            "caps": (None, caps_scfg),
            "lm": (LMDecodeAdapter(lm_params, arch, prompt_len=PROMPT_LEN,
                                   max_new_tokens=MAX_NEW), scfg),
            "moe": (MoEAdapter(moe_params, moe_cfg, seq_len=SEQ_LEN), scfg),
        },
        tenants=(TenantPolicy("caps", slo_s=60.0),
                 TenantPolicy("lm", slo_s=60.0),
                 TenantPolicy("moe", slo_s=60.0)),
        policy=ElasticPolicy(min_replicas=1, max_replicas=1))
    rng = np.random.default_rng(0)
    shape = (caps_cfg.image_hw, caps_cfg.image_hw, caps_cfg.image_channels)
    for s in range(3):
        fleet.submit(rng.random((3,) + shape, np.float32),
                     tenant="caps", model="caps")
        fleet.submit(_prompts(arch, 3, seed=s), tenant="lm", model="lm")
        fleet.submit(_blocks(moe_cfg, 3, seed=s), tenant="moe", model="moe")
    fleet.drain()
    s = fleet.summary()
    assert s["pending"] == 0 and s["failed"] == 0 and s["shed"] == 0
    assert s["completed"] == 27
    for name, t in s["per_tenant"].items():
        assert t["completed"] == t["submitted"] == 9, (name, t)
        assert t["goodput"] == 9, (name, t)
    # each group validates its own payload type — a caps image arrival
    # cannot enter the LM group
    with pytest.raises(ValueError):
        fleet.submit(rng.random((2,) + shape, np.float32),
                     tenant="lm", model="lm")


# ---------------------------------------------------------------------------
# One wave function across threads; the classifier shim
# ---------------------------------------------------------------------------

def test_lm_wave_fn_concurrent_access(lm_setup):
    """The fleet hands one LM wave function to every replica thread: waves
    run from several threads at once give each thread the tokens a lone
    wave gives (each wave builds its own decode state)."""
    cfg, params, *_ = lm_setup
    adapter = LMDecodeAdapter(params, cfg, prompt_len=PROMPT_LEN,
                              max_new_tokens=MAX_NEW)
    scfg = ServeConfig(microbatch=2, n_micro=1, pipeline=None)
    wave = adapter.make_wave_fn(scfg)
    packs = [adapter.pack(list(_prompts(cfg, 2, seed=w)), scfg)
             for w in range(6)]
    want = [wave(p) for p in packs]
    got, errors = {}, []

    def worker(w):
        try:
            for _ in range(3):
                got.setdefault(w, []).append(wave(packs[w]))
        except Exception as e:    # noqa: BLE001 — the regression signal
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not errors, errors
    for w in range(6):
        assert len(got[w]) == 3
        for out in got[w]:
            np.testing.assert_array_equal(out, want[w])


def test_classifier_shim_parity(caps_setup):
    net, cfg, params = caps_setup
    classify, stats = serve_loop.make_capsnet_classifier(net, max_batch=4)
    rng = np.random.default_rng(3)
    images = rng.random((5, cfg.image_hw, cfg.image_hw,
                         cfg.image_channels), np.float32)
    preds = classify(images)
    assert preds.shape == (5,) and preds.dtype == torch.int32
    assert stats.requests == 5 and stats.batches == 2
    assert stats.padded_waste == 3
    # parity with the direct forward at the chunk grouping the shim uses,
    # and with the reference's shim on the same weights
    with torch.no_grad():
        direct = torch.cat([
            capsnet.forward(net, torch.from_numpy(images[:4]))[
                "class_probs"].argmax(-1),
            capsnet.forward(net, torch.from_numpy(images[4:]))[
                "class_probs"].argmax(-1)])
    np.testing.assert_array_equal(preds.numpy(), direct.numpy())
    jclassify, _ = jserve_loop.make_capsnet_classifier(params, cfg,
                                                       max_batch=4)
    np.testing.assert_array_equal(preds.numpy(),
                                  np.asarray(jclassify(images)))
    assert classify(images[:0]).shape == (0,)
    # a prebuilt Router keeps the legacy inline path, and carries its plan
    router = build_router(RouterSpec(iterations=cfg.routing_iters),
                          device=CPU)
    with pytest.raises(ValueError, match="prebuilt Router"):
        serve_loop.make_capsnet_classifier(net, spec=router, plan="auto")
    legacy, lstats = serve_loop.make_capsnet_classifier(net, spec=router,
                                                        max_batch=4)
    np.testing.assert_array_equal(legacy(images[:4]).numpy(),
                                  preds[:4].numpy())
    assert (lstats.requests, lstats.batches, lstats.padded_waste) == \
        (4, 1, 0)
