"""PyTorch port, CapsFleet and the CapsNet serving subsystem: the
behaviours of ``tests/test_fleet.py`` and of ``tests/test_serving.py``
re-run against the port's ``runtime.caps_fleet`` / ``runtime.caps_serve``
(a torch ``CapsAdapter`` on the CPU, over weights carried across from the
reference):

* fleet admission — quotas, token-bucket rates, atomic reject, strict
  tenants; deadline-ordered waves and the shed policy's preference for
  doomed requests; the per-tenant books under threaded submitters;
* elastic scale-up (the new replica reusing the one cached wave function)
  and drain-down, never below ``min_replicas``, nothing lost mid-serve;
  groups with one (spec, plan) share a wave function;
* the fleet's predictions and books equal the JAX fleet's on the same
  weights;
* the single server: padding invariance (the lane mask is load-bearing),
  pipelined == unpipelined, ragged arrivals drained FIFO, one wave shape,
  fresh frozen configs, atomic submit, JSON-safe summaries, concurrent
  submitters over ``serve_forever``, shed/reject back-pressure, EM waves;
* the serving CLI's fleet and chaos modes on the CPU, books balanced.

The reference's two-stage mesh compositions of ``test_serving.py`` run in
the port as ranks over a gloo mesh (``tests/test_torch_sharded.py``).
Every thread a test starts is joined with a timeout.
"""
import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.caps_benchmarks import CapsConfig
from repro.models import capsnet as jcapsnet
from repro.runtime import caps_fleet as jfleet
from repro.runtime import caps_serve as jserve
from repro_torch import convert
from repro_torch.configs import caps_benchmarks as tconfigs
from repro_torch.core.router import RouterSpec
from repro_torch.data.synthetic import SyntheticCapsDataset
from repro_torch.launch import serve_caps as tcli
from repro_torch.models import capsnet
from repro_torch.runtime.caps_fleet import (CapsFleet, FleetAdmissionError,
                                            TenantPolicy)
from repro_torch.runtime.caps_serve import (CapsServer, QueueFullError,
                                            ServeConfig, ServeMetrics,
                                            make_wave_fn)
from repro_torch.runtime.elastic import ElasticPolicy

CPU = "cpu"
JOIN_S = 60


def tiny_caps() -> CapsConfig:
    """Smaller than smoke_caps — serving tests run many waves."""
    return CapsConfig("Caps-tiny", "synthetic", 8, 72, 10, 2,
                      caps_channels=2, conv_channels=16)


def _port_net(cfg, params):
    tcfg = tconfigs.CapsConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__})
    return convert.capsnet_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device=CPU)


@pytest.fixture(scope="module")
def jparams():
    cfg = tiny_caps()
    return cfg, jcapsnet.init_capsnet(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def setup(jparams):
    cfg, params = jparams
    rng = np.random.default_rng(0)
    images = rng.random((16, cfg.image_hw, cfg.image_hw,
                         cfg.image_channels), np.float32)
    return cfg, _port_net(cfg, params), images


@pytest.fixture(scope="module")
def serving(jparams):
    """The reference serving tests' weights: non-zero conv biases, so a
    zero-image pad lane has non-zero votes and padding invariance depends
    on the lane mask."""
    cfg, params = jparams
    params = jax.tree.map(lambda x: x, params)
    params["primary"]["conv1"]["b"] = params["primary"]["conv1"]["b"] + 0.1
    params["primary"]["caps_conv"]["b"] = (
        params["primary"]["caps_conv"]["b"] + 0.05)
    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    return cfg, _port_net(cfg, params), ds


def serve_cfg(**kw) -> ServeConfig:
    base = dict(microbatch=2, n_micro=2, pipeline=None,
                queue_order="deadline")
    base.update(kw)
    return ServeConfig(**base)


class FakeClock:
    """Deterministic clock for deadline/shed ordering tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def check_tenant_invariant(summary):
    for name, t in summary["per_tenant"].items():
        assert t["submitted"] == (t["completed"] + t["shed"] + t["failed"]
                                  + t["pending"]), (name, t)


def _micro(cfg, images, mask, n_micro, microbatch):
    return {"images": torch.as_tensor(
                np.asarray(images, np.float32)).reshape(
                (n_micro, microbatch, cfg.image_hw, cfg.image_hw,
                 cfg.image_channels)),
            "mask": torch.as_tensor(np.asarray(mask, np.float32)).reshape(
                (n_micro, microbatch))}


# ---------------------------------------------------------------------------
# Admission (test_fleet.py)
# ---------------------------------------------------------------------------

def test_quota_throttles_and_invariant_holds(setup):
    cfg, net, images = setup
    fleet = CapsFleet(net, tenants=[TenantPolicy("q", quota=6)],
                      cfg=serve_cfg())
    fleet.submit(images[:4], tenant="q")
    fleet.submit(images[:4], tenant="q")   # pending 4, room 2 -> throttle 2
    ts = fleet.tenant_summary()["q"]
    assert ts["submitted"] == 8 and ts["forwarded"] == 6
    assert ts["shed"] == ts["shed_admission"] == 2
    fleet.drain()
    ts = fleet.tenant_summary()["q"]
    assert ts["completed"] == 6 and ts["pending"] == 0
    check_tenant_invariant(fleet.summary())


def test_rate_limit_token_bucket(setup):
    cfg, net, images = setup
    clock = FakeClock()
    fleet = CapsFleet(net,
                      tenants=[TenantPolicy("r", rate=2.0, burst=4)],
                      cfg=serve_cfg(), clock=clock)
    assert len(fleet.submit(images[:6], tenant="r")) == 4   # burst
    assert len(fleet.submit(images[:2], tenant="r")) == 0   # bucket empty
    clock.t += 1.0                                          # refill 2 tokens
    assert len(fleet.submit(images[:6], tenant="r")) == 2
    ts = fleet.tenant_summary()["r"]
    assert ts["forwarded"] == 6 and ts["shed_admission"] == 8
    fleet.drain()
    check_tenant_invariant(fleet.summary())


def test_reject_is_atomic(setup):
    cfg, net, images = setup
    fleet = CapsFleet(net, tenants=[TenantPolicy("q", quota=2)],
                      cfg=serve_cfg(), overflow="reject")
    with pytest.raises(FleetAdmissionError):
        fleet.submit(images[:4], tenant="q")
    ts = fleet.tenant_summary()["q"]
    assert ts["submitted"] == 0 and ts["rejected"] == 4
    assert fleet.pending() == 0
    # a fitting arrival still admits normally afterwards
    assert len(fleet.submit(images[:2], tenant="q")) == 2


def test_strict_tenants_and_bad_arrival_mutate_nothing(setup):
    cfg, net, images = setup
    fleet = CapsFleet(net, tenants=[TenantPolicy("a")],
                      cfg=serve_cfg(), strict_tenants=True)
    with pytest.raises(KeyError):
        fleet.submit(images[:2], tenant="nobody")
    with pytest.raises(ValueError):
        fleet.submit(np.zeros((2, 3, 3, 1), np.float32), tenant="a")
    assert fleet.pending() == 0
    assert fleet.summary()["submitted"] == 0


# ---------------------------------------------------------------------------
# SLO-aware wave formation + shed preference (replica level)
# ---------------------------------------------------------------------------

def test_deadline_order_across_waves(setup):
    """Within one tenant at equal priority, a later-deadline request never
    completes in an earlier wave than an earlier-deadline one."""
    cfg, net, images = setup
    clock = FakeClock()
    server = CapsServer(net, device=CPU, cfg=serve_cfg(), clock=clock)
    deadlines = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0, 4.0]
    rid_deadline = {}
    for i, d in enumerate(deadlines):
        (rid,) = server.submit(images[i:i + 1], deadline_s=d)
        rid_deadline[rid] = d
    wave_of = {}
    wave = 0
    while True:
        done = server.step()
        if not done:
            break
        for c in done:
            wave_of[c.rid] = wave
        wave += 1
    assert wave == 2 and len(wave_of) == 8
    for r1, d1 in rid_deadline.items():
        for r2, d2 in rid_deadline.items():
            if d1 < d2:
                assert wave_of[r1] <= wave_of[r2], (d1, d2, wave_of)


def test_shed_prefers_doomed_requests(setup):
    """Back-pressure eviction targets expired requests first, then the
    lowest priority — the freshest arrival is not the default victim."""
    cfg, net, images = setup
    clock = FakeClock()
    server = CapsServer(net, device=CPU, cfg=serve_cfg(max_queue=8),
                        clock=clock)
    server.submit(images[:2], tenant="doomed", deadline_s=1.0)
    clock.t = 2.0                                    # those two expire
    server.submit(images[:3], tenant="low", deadline_s=10.0, priority=0)
    server.submit(images[:3], tenant="high", deadline_s=10.0, priority=1)
    # queue is full (8); this arrival forces 3 evictions: the 2 expired
    # first, then 1 lowest-priority
    server.submit(images[:3], tenant="high", deadline_s=10.0, priority=1)
    m = server.metrics
    assert m.shed == 3 and m.shed_expired == 2
    assert m.tenants["doomed"].shed == 2
    assert m.tenants["low"].shed == 1
    assert m.tenants["high"].shed == 0
    server.drain()
    assert m.submitted == m.completed + m.shed


# ---------------------------------------------------------------------------
# Threaded multi-tenant invariant
# ---------------------------------------------------------------------------

def test_threaded_multitenant_invariant(setup):
    """Concurrent submitters across tenants (one quota'd, one rated, one
    free) against a started fleet: after stop(), every tenant's books
    balance and nothing is pending."""
    cfg, net, images = setup
    tenants = [TenantPolicy("gold", slo_s=30.0, priority=1),
               TenantPolicy("quota", quota=8),
               TenantPolicy("rated", rate=200.0, burst=8)]
    fleet = CapsFleet(net, tenants=tenants,
                      cfg=serve_cfg(max_queue=32),
                      policy=ElasticPolicy(min_replicas=2, max_replicas=2),
                      control_interval_s=0.05)
    fleet.start()
    per_thread, arrivals = 6, 3

    def client(tenant):
        for _ in range(per_thread):
            fleet.submit(images[:arrivals], tenant=tenant)
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(t.name,))
               for t in tenants for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    s = fleet.stop()
    assert s["pending"] == 0
    check_tenant_invariant(s)
    for t in tenants:
        assert s["per_tenant"][t.name]["submitted"] == \
            2 * per_thread * arrivals
    assert s["submitted"] == s["completed"] + s["shed"]
    # goodput: gold's 30s SLO is unmissable here — all completions count
    g = s["per_tenant"]["gold"]
    assert g["goodput"] == g["completed"]


# ---------------------------------------------------------------------------
# Elastic scale-up / scale-down
# ---------------------------------------------------------------------------

def test_elastic_scales_up_and_drains_down(setup):
    """Sustained backlog adds a replica (reusing the cached wave fn);
    sustained idleness drains one cleanly — its queued work completes and
    its metrics are retired into the fleet aggregate."""
    cfg, net, images = setup
    # slow_p90_factor is effectively off: a slow first wave would
    # otherwise read as a p90 straggler and keep voting "up" against the
    # idle-queue down-signal
    fleet = CapsFleet(net, cfg=serve_cfg(),
                      policy=ElasticPolicy(min_replicas=1, max_replicas=2,
                                           up_patience=2, down_patience=2,
                                           slow_p90_factor=1e9))
    assert fleet.n_replicas() == 1
    g = fleet._groups["default"]
    shared_fn = g["wave_fn"]

    # sustained depth: backlog = 12 / (1 * 4) = 3 > 1.5 for two ticks
    fleet.submit(images[:12])
    assert fleet.control_tick() == {"default": "hold"}   # patience 1/2
    assert fleet.control_tick() == {"default": "up"}
    assert fleet.n_replicas() == 2
    assert all(r.server._wave_fn is shared_fn
               for r in g["replicas"])                   # build-once

    done = fleet.drain()
    assert len(done) == 12

    # sustained idleness: backlog 0 < 0.25 for two ticks -> drain one
    assert fleet.control_tick() == {"default": "hold"}   # patience 1/2
    assert fleet.control_tick() == {"default": "down"}
    fleet.control_tick()                                 # reap the drained
    assert fleet.n_replicas() == 1
    s = fleet.summary()
    assert s["replicas_retired"] == 1
    assert s["completed"] == 12 and s["pending"] == 0
    assert [e["decision"] for e in s["scale_events"]["default"]] == \
        ["up", "down"]


def test_scale_down_never_below_min(setup):
    cfg, net, images = setup
    fleet = CapsFleet(net, cfg=serve_cfg(),
                      policy=ElasticPolicy(min_replicas=1, max_replicas=2,
                                           up_patience=1, down_patience=1,
                                           slow_p90_factor=1e9))
    for _ in range(4):
        fleet.control_tick()                             # idle ticks
    assert fleet.n_replicas() == 1


def test_threaded_scale_up_loses_nothing(setup):
    """Scale-up mid-serve: the new replica joins the same books — total
    completions + shed still equal submissions."""
    cfg, net, images = setup
    fleet = CapsFleet(net, cfg=serve_cfg(max_queue=64),
                      policy=ElasticPolicy(min_replicas=1, max_replicas=3,
                                           up_patience=1, down_patience=8),
                      control_interval_s=0.02)
    fleet.start()
    for _ in range(12):
        fleet.submit(images[:4])
        time.sleep(0.005)
    deadline = time.monotonic() + 20.0
    while fleet.pending() and time.monotonic() < deadline:
        time.sleep(0.01)
    s = fleet.stop()
    assert s["pending"] == 0
    assert s["submitted"] == 48 == s["completed"] + s["shed"]
    assert len(fleet.completions) == s["completed"]
    check_tenant_invariant(s)


# ---------------------------------------------------------------------------
# Mixed (spec, plan) groups + fleet-wide wave cache
# ---------------------------------------------------------------------------

def test_mixed_model_groups_share_wave_cache(setup):
    """Two groups with the same (spec, plan) share one wave fn;
    a distinct plan gets its own.  Both serve side by side."""
    cfg, net, images = setup
    scfg = serve_cfg()
    big = serve_cfg(microbatch=4)
    spec = RouterSpec(iterations=cfg.routing_iters)
    fleet = CapsFleet(net,
                      models={"a": (spec, scfg), "b": (spec, scfg),
                              "c": (spec, big)})
    g = fleet._groups
    assert g["a"]["wave_fn"] is g["b"]["wave_fn"]
    assert g["a"]["wave_fn"] is not g["c"]["wave_fn"]
    fleet.submit(images[:3], model="a")
    fleet.submit(images[:3], model="c")
    fleet.drain()
    s = fleet.summary()
    assert s["completed"] == 6 and s["pending"] == 0
    with pytest.raises(KeyError):
        fleet.submit(images[:1], model="nope")


# ---------------------------------------------------------------------------
# The CapsNet serving subsystem (test_serving.py)
# ---------------------------------------------------------------------------

def test_padding_invariance(serving):
    """Padded lanes never change real outputs — even though routing couples
    batch lanes through the shared b logits and the (biased) encoder maps
    zero images to non-zero votes."""
    cfg, net, ds = serving
    n_micro, microbatch = 1, 8
    real = ds.batch(0, 3)["images"]

    # the mask is load-bearing: an unmasked zero image has non-zero votes
    with torch.no_grad():
        zero_votes = capsnet.encode_votes(
            net, torch.zeros((1, cfg.image_hw, cfg.image_hw,
                              cfg.image_channels)))
    assert float(zero_votes.abs().max()) > 1e-3

    wave = make_wave_fn(net, None,
                        ServeConfig(microbatch=microbatch, n_micro=n_micro,
                                    pipeline="software"))
    padded = np.zeros((microbatch, cfg.image_hw, cfg.image_hw,
                       cfg.image_channels), np.float32)
    padded[:3] = real
    mask = np.zeros((microbatch,), np.float32)
    mask[:3] = 1.0
    got = wave(_micro(cfg, padded, mask, n_micro, microbatch))[0, :3]

    ref_wave = make_wave_fn(net, None,
                            ServeConfig(microbatch=3, n_micro=1,
                                        pipeline="software"))
    want = ref_wave(_micro(cfg, real, np.ones(3), 1, 3))[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_pipelined_matches_unpipelined(serving):
    """The §4 pipeline transform is exact (<= 1e-5) for the serving wave."""
    cfg, net, ds = serving
    n_micro, microbatch = 3, 4
    images = ds.batch(1, n_micro * microbatch)["images"]
    mask = np.ones((n_micro * microbatch,), np.float32)
    mask[-2:] = 0.0            # include padded lanes in the comparison
    micro = _micro(cfg, images, mask, n_micro, microbatch)
    probs = {}
    for arm, pipeline in (("piped", "software"), ("plain", None)):
        wave = make_wave_fn(net, None,
                            ServeConfig(microbatch=microbatch,
                                        n_micro=n_micro,
                                        pipeline=pipeline))
        probs[arm] = np.asarray(wave(micro))
    assert np.max(np.abs(probs["piped"] - probs["plain"])) <= 1e-5


def test_queue_drains_ragged_arrivals(serving):
    """Ragged arrival pattern fully drains; every request completes exactly
    once with sane latency/padding accounting (fake clock)."""
    cfg, net, ds = serving
    ticks = iter(range(1000))
    server = CapsServer(net, device=CPU,
                        cfg=ServeConfig(microbatch=4, n_micro=2,
                                        pipeline="software"),
                        clock=lambda: float(next(ticks)))
    arrivals = [3, 0, 9, 1, 0, 0, 5, 2]
    submitted = []
    done = []
    for tick, count in enumerate(arrivals):
        if count:
            submitted += server.submit(ds.batch(tick, count)["images"])
        done += server.step()
    done += server.drain()

    assert server.pending() == 0
    assert sorted(c.rid for c in done) == sorted(submitted)
    s = server.metrics.summary()
    assert s["completed"] == s["submitted"] == sum(arrivals)
    assert s["waves"] * server.cfg.wave_lanes \
        == s["completed"] + s["padded_lanes"]
    assert all(c.latency_s >= 0 for c in done)
    assert s["p90_latency_s"] >= s["p50_latency_s"] >= 0
    # FIFO: completion order == submission order under a single queue
    assert [c.rid for c in done] == submitted


def test_wave_fn_compiles_once(serving):
    """Continuous batching keeps a constant wave shape: ragged arrivals all
    reuse one wave function at one shape (built once per (spec, plan))."""
    cfg, net, ds = serving
    server = CapsServer(net, device=CPU,
                        cfg=ServeConfig(microbatch=4, n_micro=2,
                                        pipeline="software"))
    calls = []
    inner = server._wave_fn
    server._wave_fn = lambda m: (calls.append(
        {k: tuple(v.shape) for k, v in m.items()}), inner(m))[1]
    for tick, count in enumerate([1, 7, 3]):
        server.submit(ds.batch(tick, count)["images"])
        server.step()
    server.drain()
    assert len(set(map(str, calls))) == 1      # one shape -> one executable


def test_default_config_fresh_and_frozen(serving):
    """cfg=None builds a fresh ServeConfig per server (no shared default
    instance), and ServeConfig is frozen so plan-affecting fields cannot
    drift after make_wave_fn built the wave."""
    cfg, net, ds = serving
    s1 = CapsServer(net, device=CPU)
    s2 = CapsServer(net, device=CPU)
    with pytest.raises(dataclasses.FrozenInstanceError):
        s1.cfg.microbatch = 99
    s1.submit(ds.batch(0, 1)["images"])
    assert (s1.metrics.submitted, s2.metrics.submitted) == (1, 0)
    assert (s1.pending(), s2.pending()) == (1, 0)
    with pytest.raises(ValueError, match="overflow"):
        ServeConfig(overflow="panic")
    with pytest.raises(ValueError, match="max_queue"):
        ServeConfig(max_queue=0)


def test_submit_is_atomic(serving):
    """A mid-batch invalid image admits nothing: everything validates
    before anything enqueues, mis-shaped and ragged arrivals get the
    friendly error, and an empty-queue step() is a no-op."""
    cfg, net, ds = serving
    server = CapsServer(net, device=CPU,
                        cfg=ServeConfig(microbatch=2, n_micro=1))
    good = np.asarray(ds.batch(0, 2)["images"], np.float32)

    with pytest.raises(ValueError, match="image shape"):
        server.submit(np.zeros((2, 3, 3, 1), np.float32))
    with pytest.raises(ValueError, match="ragged arrival"):
        server.submit([good[0], np.zeros((5,), np.float32)])
    assert server.pending() == 0
    assert server.metrics.submitted == 0
    assert server.metrics.t_first_submit is None

    assert server.step() == []                 # empty-queue step: no-op
    assert server.metrics.waves == 0
    assert server.submit([]) == []

    rids = server.submit(good)                 # valid arrivals still admit
    assert rids == [0, 1] and server.pending() == 2


def test_summary_is_strict_json_safe():
    """summary() never emits NaN/Infinity (strict JSON round-trip) and
    uses nearest-rank percentiles."""
    def boom(name):
        raise AssertionError(f"non-finite constant {name} in summary")

    empty = ServeMetrics().summary()
    assert empty["p50_latency_s"] is None
    assert empty["p90_latency_s"] is None
    assert empty["throughput_rps"] is None     # span 0 != "completed rps"
    assert json.loads(json.dumps(empty), parse_constant=boom) == empty

    m = ServeMetrics(submitted=4, completed=4,
                     latencies_s=[3.0, 1.0, 2.0, 4.0],
                     t_first_submit=0.0, t_last_done=2.0)
    s = m.summary()
    # nearest-rank over [1,2,3,4]: p50 -> ceil(2)=2nd -> 2.0, p90 -> 4th
    assert s["p50_latency_s"] == 2.0
    assert s["p90_latency_s"] == 4.0
    assert s["throughput_rps"] == 2.0
    assert json.loads(json.dumps(s), parse_constant=boom) == s


def test_async_admission_concurrent_submitters(serving):
    """serve_forever on a background thread sustains concurrent submitter
    threads: no lost or double-counted requests, clean stop drains the
    queue, and submitted == completed + shed + pending holds."""
    cfg, net, ds = serving
    server = CapsServer(net, device=CPU,
                        cfg=ServeConfig(microbatch=4, n_micro=2,
                                        pipeline="software"))
    stop = threading.Event()
    done = []
    driver = threading.Thread(
        target=lambda: done.extend(server.serve_forever(stop, poll_s=0.005)))
    driver.start()

    rids, lock = [], threading.Lock()

    def client(worker):
        got = []
        for tick, count in enumerate([3, 1, 5, 2]):
            got += server.submit(ds.batch(worker * 10 + tick,
                                          count)["images"])
            time.sleep(0.002)
        with lock:
            rids.extend(got)

    clients = [threading.Thread(target=client, args=(w,)) for w in range(3)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=JOIN_S)
    stop.set()
    driver.join(timeout=JOIN_S)
    assert not driver.is_alive()

    m = server.metrics
    assert sorted(c.rid for c in done) == sorted(rids)
    assert len({c.rid for c in done}) == len(done)          # no duplicates
    assert server.pending() == 0 and m.shed == 0
    assert m.submitted == m.completed + m.shed + server.pending() == 33


def test_backpressure_shed_and_reject(serving):
    """Bounded queue: "shed" admits up to the bound and tail-drops the
    rest (counted); "reject" raises atomically, admitting nothing."""
    cfg, net, ds = serving
    server = CapsServer(net, device=CPU,
                        cfg=ServeConfig(microbatch=2, n_micro=2,
                                        max_queue=3, overflow="shed"))
    rids = server.submit(ds.batch(0, 5)["images"])
    assert len(rids) == 3
    m = server.metrics
    assert (m.submitted, m.shed, server.pending()) == (5, 2, 3)
    assert len(server.drain()) == 3
    assert m.submitted == m.completed + m.shed + server.pending()
    assert m.summary()["shed"] == 2

    server = CapsServer(net, device=CPU,
                        cfg=ServeConfig(microbatch=2, n_micro=2,
                                        max_queue=2, overflow="reject"))
    server.submit(ds.batch(1, 1)["images"])
    with pytest.raises(QueueFullError):
        server.submit(ds.batch(2, 4)["images"])
    assert server.pending() == 1                # atomic: nothing admitted
    assert server.metrics.submitted == 1
    assert server.metrics.rejected == 4
    assert server.metrics.shed == 0


def test_em_wave_pipelined_matches_unpipelined(serving):
    """EM serving waves (the multi-input (votes, a_in) stage hand-off):
    pipelined == unpipelined <= 1e-5, and the server completes over it."""
    cfg, net, ds = serving
    spec = RouterSpec(algorithm="em", iterations=2)
    n_micro, microbatch = 2, 4
    images = ds.batch(3, n_micro * microbatch)["images"]
    mask = np.ones((n_micro * microbatch,), np.float32)
    mask[-1] = 0.0
    micro = _micro(cfg, images, mask, n_micro, microbatch)
    scores = {}
    for arm, pipeline in (("piped", "software"), ("plain", None)):
        wave = make_wave_fn(net, spec,
                            ServeConfig(microbatch=microbatch,
                                        n_micro=n_micro,
                                        pipeline=pipeline))
        scores[arm] = np.asarray(wave(micro))
    assert scores["piped"].shape == (n_micro, microbatch, cfg.num_h_caps)
    assert np.max(np.abs(scores["piped"] - scores["plain"])) <= 1e-5

    server = CapsServer(net, spec=spec, device=CPU,
                        cfg=ServeConfig(microbatch=microbatch,
                                        n_micro=n_micro,
                                        pipeline="software"))
    server.submit(ds.batch(4, 6)["images"])
    assert len(server.drain()) == 6


def test_em_padding_invariance(serving):
    """Padded lanes never change real EM outputs: the lane mask zeroes a
    padded lane's a_in and votes, so its (biased-encoder, non-zero) votes
    never weight any Gaussian — checked against an unpadded reference
    wave, not just the other pipeline arm (which shares the masking)."""
    cfg, net, ds = serving
    spec = RouterSpec(algorithm="em", iterations=2)
    microbatch = 8
    real = ds.batch(5, 3)["images"]
    padded = np.zeros((microbatch, cfg.image_hw, cfg.image_hw,
                       cfg.image_channels), np.float32)
    padded[:3] = real
    mask = np.zeros((microbatch,), np.float32)
    mask[:3] = 1.0
    wave = make_wave_fn(net, spec,
                        ServeConfig(microbatch=microbatch, n_micro=1,
                                    pipeline="software"))
    got = wave(_micro(cfg, padded, mask, 1, microbatch))[0, :3]
    ref_wave = make_wave_fn(net, spec,
                            ServeConfig(microbatch=3, n_micro=1,
                                        pipeline="software"))
    want = ref_wave(_micro(cfg, real, np.ones(3), 1, 3))[0]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Against the reference fleet, and the CLI's fleet and chaos modes
# ---------------------------------------------------------------------------

def test_fleet_predictions_match_the_reference_fleet(jparams, setup):
    """Two tenants over two replicas, driven synchronously: the port's
    fleet completes the same requests with the same predictions and the
    same per-tenant books as the JAX fleet on the same weights."""
    cfg, params = jparams
    _, net, images = setup
    policy = dict(min_replicas=2, max_replicas=2)
    port = CapsFleet(net, tenants=[TenantPolicy("a", slo_s=60.0),
                                   TenantPolicy("b", quota=5)],
                     cfg=serve_cfg(), policy=ElasticPolicy(**policy),
                     clock=FakeClock())
    ref = jfleet.CapsFleet(
        params, cfg, tenants=[jfleet.TenantPolicy("a", slo_s=60.0),
                              jfleet.TenantPolicy("b", quota=5)],
        cfg=jserve.ServeConfig(microbatch=2, n_micro=2, pipeline=None,
                               queue_order="deadline"),
        policy=jfleet.ElasticPolicy(**policy), clock=FakeClock())
    rids = {}
    for name, fleet in (("port", port), ("ref", ref)):
        rids[name] = [fleet.submit(images[lo:lo + 4],
                                   tenant="a" if lo % 8 else "b")
                      for lo in range(0, 16, 4)]
    assert rids["port"] == rids["ref"]
    got = {f"{rep}:{c.rid}": c.pred for rep, c in port.drain()}
    want = {f"{rep}:{c.rid}": c.pred for rep, c in ref.drain()}
    assert got == want
    books = ("submitted", "completed", "shed", "failed", "pending")
    ps, rs = port.tenant_summary(), ref.tenant_summary()
    assert {t: [ps[t][k] for k in books] for t in ps} == \
        {t: [rs[t][k] for k in books] for t in rs}


@pytest.mark.parametrize("extra", [
    ["--replicas", "2", "--tenants", "2", "--chaos"],
    ["--replicas", "2", "--max-replicas", "3", "--tenants", "2",
     "--slo-ms", "2000", "--chaos", "--chaos-seed", "3"]],
    ids=["chaos", "elastic-chaos"])
def test_serve_cli_fleet_and_chaos_on_cpu(extra, capsys):
    s = tcli.main(["--smoke", "--device", CPU, "--requests", "24", *extra])
    assert s["pending"] == 0 and s["submitted"] == 24
    assert s["submitted"] == s["completed"] + s["shed"] + s["failed"]
    check_tenant_invariant(s)
    assert s["evacuated"] == s["adopted"]
    assert len(s["health_events"]) == 1           # the crash, buried once
    out = capsys.readouterr().out
    assert "chaos:" in out and "evacuated" in out
