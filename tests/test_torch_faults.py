"""PyTorch port, CapsChaos: the behaviours of ``tests/test_faults.py``
re-run against the port's ``runtime.faults`` and the fault boundaries of
its ``CapsServer`` / ``CapsFleet`` (a torch ``CapsAdapter`` on the CPU,
over weights carried across from the reference):

* a ``FaultPlan`` is pure data — same seed, same schedule, and the same
  schedule as the reference's ``FaultPlan.generate``; at a colliding call
  index severity wins: crash > error > corrupt > straggle;
* chaos is inert when no fault is scheduled: predictions bit-identical,
  and equal to the JAX server's on the same weights;
* a transient wave error costs a retry, never a request; a persistent
  fault fails requests with accounting and ``drain()`` terminates;
* a NaN-corrupted wave (a poisoned copy of the wave's tensor) trips the
  output guard and is quarantined through the eager torch re-run;
* a ``ReplicaCrash`` kills the server; ``evacuate()``/``adopt()`` hand the
  backlog to a survivor with nothing lost;
* ``serve_forever`` survives K transient faults under concurrent
  submitters — and raising completion callbacks — with zero request loss;
* requeued requests keep their original order keys (property test);
* the fleet health check buries a replica that crashes mid-backlog,
  re-dispatches everything to survivors and restarts capacity; with no
  survivor the backlog fails with accounting;
* ``StepWatchdog.stop()`` before ``start()`` is a no-op and the watchdog
  runs entirely on an injectable clock.

Every thread a test starts is joined with a timeout.
"""
import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # vendored fallback (tests/_hypothesis_compat.py)
    from _hypothesis_compat import given, settings, strategies as st

from repro.configs.caps_benchmarks import CapsConfig
from repro.models import capsnet as jcapsnet
from repro.runtime import caps_serve as jserve
from repro.runtime import faults as jfaults
from repro_torch import convert
from repro_torch.configs import caps_benchmarks as tconfigs
from repro_torch.runtime import caps_fleet
from repro_torch.runtime.caps_fleet import CapsFleet, HealthPolicy
from repro_torch.runtime.caps_serve import (CapsServer, ReplicaCrash,
                                            ServeConfig, make_wave_fn)
from repro_torch.runtime.elastic import ElasticPolicy
from repro_torch.runtime.faults import (ChaosWaveFn, FaultEvent, FaultPlan,
                                        InjectedFault, chaos_wave_fn,
                                        fleet_wrap)
from repro_torch.runtime.straggler import StepWatchdog

CPU = "cpu"
JOIN_S = 60


def tiny_caps() -> CapsConfig:
    return CapsConfig("Caps-tiny", "synthetic", 8, 72, 10, 2,
                      caps_channels=2, conv_channels=16)


def serve_cfg(**kw) -> ServeConfig:
    base = dict(microbatch=2, n_micro=2, pipeline=None)
    base.update(kw)
    return ServeConfig(**base)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(scope="module")
def setup():
    """The reference's weights carried into a CPU ``CapsNet``, and the
    clean wave function for the shared ServeConfig (chaos wraps it, never
    rebuilds it)."""
    cfg = tiny_caps()
    params = jax.tree.map(np.asarray,
                          jcapsnet.init_capsnet(jax.random.PRNGKey(0), cfg))
    tcfg = tconfigs.CapsConfig(**{f: getattr(cfg, f)
                                  for f in cfg.__dataclass_fields__})
    net = convert.capsnet_from_jax(params, tcfg, device=CPU)
    rng = np.random.default_rng(0)
    images = rng.random((24, cfg.image_hw, cfg.image_hw,
                         cfg.image_channels), np.float32)
    scfg = serve_cfg()
    clean = make_wave_fn(net, None, scfg)
    return (cfg, params), net, images, scfg, clean


def check_invariant(server: CapsServer):
    m = server.metrics
    assert m.submitted == (m.completed + m.shed + m.failed + m.evacuated
                           + server.pending()), m.summary()
    for name, t in m.tenants.items():
        assert t.submitted == (t.completed + t.shed + t.failed
                               + t.evacuated + t.pending), \
            (name, t.summary())


def baseline_preds(setup, n: int, **server_kw):
    """rid -> pred from a fault-free server over images[:n]."""
    _, net, images, scfg, clean = setup
    srv = CapsServer(net, device=CPU, cfg=server_kw.pop("cfg", scfg),
                     wave_fn=clean, **server_kw)
    srv.submit(images[:n])
    return {c.rid: c.pred for c in srv.drain()}


# ---------------------------------------------------------------------------
# Watchdog regressions (injectable clock; stop before start)
# ---------------------------------------------------------------------------

def test_watchdog_stop_before_start_is_noop():
    wd = StepWatchdog(window=4)
    assert wd.stop() is None            # regression: used to TypeError
    assert list(wd.durations) == []
    # and the crashed-wave shape: start/stop, then a bare stop again
    wd.start(0)
    assert wd.stop() is not None
    assert wd.stop() is None
    assert len(wd.durations) == 1


def test_watchdog_injectable_clock():
    clk = FakeClock()
    slow = []
    wd = StepWatchdog(window=8, slow_factor=2.0, clock=clk,
                      on_slow=lambda s, dt, med: slow.append((s, dt, med)))
    for i, dt in enumerate([0.1, 0.1, 0.1]):
        wd.start(i)
        clk.t += dt
        assert wd.stop() == pytest.approx(dt)
    wd.start(3)
    clk.t += 1.0                        # 10x the median: flagged
    assert wd.stop() == pytest.approx(1.0)
    assert wd.slow_steps == [3] and slow[0][0] == 3
    assert wd.percentile(0.5) == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# FaultPlan: pure, deterministic schedules
# ---------------------------------------------------------------------------

def test_fault_event_validation():
    with pytest.raises(ValueError):
        FaultEvent(0, "meteor")
    with pytest.raises(ValueError):
        FaultEvent(-1, "error")
    with pytest.raises(ValueError):
        FaultEvent(0, "error", span=0)
    with pytest.raises(ValueError):
        FaultEvent(0, "straggle", delay_s=-1.0)
    with pytest.raises(TypeError):
        FaultPlan(("error",))


def test_fault_plan_same_seed_same_schedule():
    kw = dict(p_error=0.3, p_corrupt=0.2, p_straggle=0.2,
              persistent=((5, 3),), crash_wave=9)
    a = FaultPlan.generate(7, 32, **kw)
    b = FaultPlan.generate(7, 32, **kw)
    assert a == b and a.lookup() == b.lookup()
    assert FaultPlan.generate(8, 32, **kw) != a


def test_fault_plan_span_and_severity_precedence():
    plan = FaultPlan((FaultEvent(2, "error", span=3),))
    table = plan.lookup()
    assert sorted(table) == [2, 3, 4]
    # a pinned crash at an index where lesser faults also sampled must win
    plan = FaultPlan.generate(0, 4, p_error=1.0, p_corrupt=1.0,
                              crash_wave=2)
    assert plan.lookup()[2].kind == "crash"
    assert plan.lookup()[1].kind == "error"     # error > corrupt


def test_chaos_inert_without_faults(setup):
    cfg, net, images, scfg, clean = setup
    want = baseline_preds(setup, 8)
    wrapped = chaos_wave_fn(clean, FaultPlan())
    srv = CapsServer(net, device=CPU, cfg=scfg, wave_fn=wrapped)
    srv.submit(images[:8])
    got = {c.rid: c.pred for c in srv.drain()}
    assert got == want                   # bit-identical when no fault fires
    assert wrapped.calls == 2 and wrapped.fired == {}
    m = srv.metrics
    assert (m.wave_errors, m.retried, m.guard_trips, m.failed) == (0,) * 4
    check_invariant(srv)


# ---------------------------------------------------------------------------
# Server fault boundary, one mode at a time
# ---------------------------------------------------------------------------

def test_transient_error_retries_zero_loss(setup):
    cfg, net, images, scfg, clean = setup
    want = baseline_preds(setup, 8)
    wrapped = chaos_wave_fn(clean, FaultPlan((FaultEvent(0, "error"),)))
    srv = CapsServer(net, device=CPU, cfg=scfg, wave_fn=wrapped)
    srv.submit(images[:8])
    got = {c.rid: c.pred for c in srv.drain()}
    assert got == want                   # retry is invisible in the output
    m = srv.metrics
    assert m.wave_errors == 1 and m.retried == 1
    assert m.requeued == scfg.wave_lanes and m.failed == 0
    assert "InjectedFault" in m.last_error
    check_invariant(srv)


def test_transient_error_backoff_uses_injected_sleep(setup):
    cfg, net, images, scfg, clean = setup
    slept = []
    wrapped = chaos_wave_fn(clean, FaultPlan((FaultEvent(0, "error"),
                                              FaultEvent(1, "error"))))
    srv = CapsServer(net, device=CPU,
                     cfg=dataclasses.replace(scfg, retry_backoff_s=0.01),
                     wave_fn=wrapped, sleep=slept.append)
    srv.submit(images[:4])
    assert len(srv.drain()) == 4
    # two consecutive failures: base backoff, then doubled
    assert slept == [pytest.approx(0.01), pytest.approx(0.02)]
    assert srv.consecutive_failures == 0     # reset by the clean wave
    check_invariant(srv)


def test_persistent_error_bounded_failure(setup):
    cfg, net, images, scfg, clean = setup
    retries = 2
    plan = FaultPlan((FaultEvent(0, "error", span=10),))
    wrapped = chaos_wave_fn(clean, plan)
    srv = CapsServer(net, device=CPU,
                     cfg=dataclasses.replace(scfg, max_wave_retries=retries),
                     wave_fn=wrapped)
    srv.submit(images[:4])
    assert srv.drain() == []             # terminates despite the fault
    m = srv.metrics
    assert m.failed == 4 and m.completed == 0
    assert m.wave_errors == retries + 1  # initial attempt + bounded retries
    assert srv.pending() == 0
    check_invariant(srv)


def test_corrupt_trips_guard_quarantine(setup):
    cfg, net, images, scfg, clean = setup
    want = baseline_preds(setup, 8)
    wrapped = chaos_wave_fn(clean, FaultPlan((FaultEvent(1, "corrupt"),)))
    srv = CapsServer(net, device=CPU, cfg=scfg, wave_fn=wrapped)
    srv.submit(images[:8])
    got = {c.rid: c.pred for c in srv.drain()}
    assert got == want                   # reference re-run, not the NaN
    m = srv.metrics
    assert m.guard_trips == 1 and m.wave_errors == 0 and m.failed == 0
    check_invariant(srv)


def test_straggle_uses_injected_sleep(setup):
    cfg, net, images, scfg, clean = setup
    slept = []
    plan = FaultPlan((FaultEvent(0, "straggle", delay_s=0.5),))
    wrapped = ChaosWaveFn(clean, plan, sleep=slept.append)
    srv = CapsServer(net, device=CPU, cfg=scfg, wave_fn=wrapped)
    srv.submit(images[:4])
    assert len(srv.drain()) == 4         # slow, not wrong
    assert slept == [0.5] and wrapped.fired == {0: "straggle"}
    assert srv.metrics.wave_errors == 0
    check_invariant(srv)


def test_crash_marks_dead_then_evacuate_adopt(setup):
    cfg, net, images, scfg, clean = setup
    want = baseline_preds(setup, 12)
    wrapped = chaos_wave_fn(clean, FaultPlan((FaultEvent(1, "crash"),)))
    srv = CapsServer(net, device=CPU, cfg=scfg, wave_fn=wrapped)
    srv.submit(images[:12])
    done = srv.step()                    # wave 0 completes
    assert len(done) == 4
    with pytest.raises(ReplicaCrash):
        srv.step()                       # wave 1 kills the replica
    assert srv.dead and srv.step() == [] and srv.drain() == []
    backlog = srv.evacuate()
    assert len(backlog) == 8 and srv.metrics.evacuated == 8
    check_invariant(srv)                 # 12 == 4 completed + 8 evacuated

    survivor = CapsServer(net, device=CPU, cfg=scfg, wave_fn=clean)
    with pytest.raises(ReplicaCrash):
        srv.adopt(backlog)               # never adopt onto a dead replica
    assert survivor.adopt(backlog) == 8
    got = {c.rid: c.pred for c in done + survivor.drain()}
    assert got == want                   # identity preserved across hand-off
    assert survivor.metrics.adopted == 8
    check_invariant(survivor)


# ---------------------------------------------------------------------------
# serve_forever under chaos (threaded, concurrent submitters)
# ---------------------------------------------------------------------------

def test_serve_forever_survives_transient_faults_zero_loss(setup):
    cfg, net, images, scfg, clean = setup
    plan = FaultPlan((FaultEvent(1, "error"), FaultEvent(3, "error"),
                      FaultEvent(5, "error")))
    wrapped = chaos_wave_fn(clean, plan)
    srv = CapsServer(net, device=CPU, cfg=scfg, wave_fn=wrapped)
    stop = threading.Event()
    out = []
    driver = threading.Thread(
        target=lambda: out.extend(srv.serve_forever(stop, poll_s=0.01)))
    driver.start()

    def client(lo, hi):
        for i in range(lo, hi, 4):
            srv.submit(images[i:i + 4])

    clients = [threading.Thread(target=client, args=(lo, lo + 8))
               for lo in (0, 8, 16)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=JOIN_S)
    deadline = 30.0
    while srv.pending() > 0 and deadline > 0:
        stop.wait(0.01)
        deadline -= 0.01
    stop.set()
    driver.join(timeout=JOIN_S)
    assert not driver.is_alive()

    m = srv.metrics
    assert len(out) == 24 and m.completed == 24     # K faults, zero loss
    assert sorted(c.rid for c in out) == list(range(24))
    assert m.wave_errors == 3 and m.failed == 0
    assert wrapped.calls >= 6 + 3        # 6 clean waves + 3 retried attempts
    check_invariant(srv)


def test_serve_forever_callback_raises_no_loss(setup):
    cfg, net, images, scfg, clean = setup
    srv = CapsServer(net, device=CPU, cfg=scfg, wave_fn=clean)
    srv.submit(images[:8])
    stop = threading.Event()
    stop.set()                           # drain-and-return immediately

    def bad_callback(c):
        raise RuntimeError("client bug")

    done = srv.serve_forever(stop, on_completion=bad_callback)
    assert len(done) == 8                # completions land before callbacks
    m = srv.metrics
    assert m.completed == 8 and m.callback_errors == 8
    assert "on_completion" in m.last_error
    check_invariant(srv)


def test_serve_forever_exits_cleanly_on_crash(setup):
    cfg, net, images, scfg, clean = setup
    wrapped = chaos_wave_fn(clean, FaultPlan((FaultEvent(1, "crash"),)))
    srv = CapsServer(net, device=CPU, cfg=scfg, wave_fn=wrapped)
    srv.submit(images[:12])
    stop = threading.Event()
    done = srv.serve_forever(stop)       # no stop needed: the crash exits
    assert len(done) == 4 and srv.dead
    assert len(srv.evacuate()) == 8      # backlog intact for the fleet
    check_invariant(srv)


# ---------------------------------------------------------------------------
# Property: requeue preserves deadline ordering
# ---------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), fault_wave=st.integers(0, 2))
def test_requeue_preserves_deadline_order(setup, seed, fault_wave):
    """A transient fault must not reorder SLO-aware wave formation:
    requeued requests keep their original (deadline, arrival) keys, so
    the faulted server completes rids in exactly the fault-free order."""
    cfg, net, images, scfg, clean = setup
    dcfg = dataclasses.replace(scfg, queue_order="deadline")
    rng = np.random.default_rng(seed)
    deadlines = rng.uniform(1.0, 100.0, size=10)

    def run(wave_fn):
        clk = FakeClock()
        srv = CapsServer(net, device=CPU, cfg=dcfg, wave_fn=wave_fn, clock=clk)
        for i, d in enumerate(deadlines):
            srv.submit(images[i:i + 1], deadline_s=float(d))
        order = [c.rid for c in srv.drain()]
        check_invariant(srv)
        assert srv.metrics.failed == 0
        return order

    want = run(clean)
    got = run(chaos_wave_fn(clean, FaultPlan((FaultEvent(fault_wave,
                                                         "error"),))))
    assert got == want


# ---------------------------------------------------------------------------
# Fleet self-healing
# ---------------------------------------------------------------------------

def test_fleet_crash_midbacklog_redispatches_to_survivors(setup):
    cfg, net, images, scfg, clean = setup
    registry = {}
    plans = {"default/r0": FaultPlan((FaultEvent(1, "crash"),))}
    fleet = CapsFleet(net, cfg=scfg,
                      policy=ElasticPolicy(min_replicas=2, max_replicas=3),
                      wave_cache={(None, scfg): clean},
                      wave_wrap=fleet_wrap(plans, registry=registry))
    for i in range(0, 24, 4):
        fleet.submit(images[i:i + 4], tenant="a" if i % 8 else "b")
    out = fleet.drain()                  # r0 dies on its second wave

    assert len(out) == 24                # everything completed elsewhere
    assert registry["default/r0"].fired[1] == "crash"
    s = fleet.summary()
    assert s["failed"] == 0 and s["completed"] == 24
    assert s["evacuated"] == s["adopted"] > 0
    (ev,) = s["health_events"]
    assert ev["state"] == caps_fleet.DEAD and ev["replica"] == "default/r0"
    assert ev["adopted_by"] is not None and ev["restarted"] is not None
    assert fleet.n_replicas() == 2       # capacity restored by the restart
    assert "default/r0" not in s["per_replica"]     # buried, retired
    for name, t in s["per_tenant"].items():
        assert t["submitted"] == (t["completed"] + t["shed"] + t["failed"]
                                  + t["pending"]), (name, t)
        assert t["pending"] == 0
    decisions = [e["decision"] for e in s["scale_events"]["default"]]
    assert "restart" in decisions        # burial went through the controller


def test_fleet_no_survivor_abandons_with_accounting(setup):
    cfg, net, images, scfg, clean = setup
    plans = {"default/r0": FaultPlan((FaultEvent(1, "crash"),))}
    fleet = CapsFleet(net, cfg=scfg,
                      policy=ElasticPolicy(min_replicas=1, max_replicas=1),
                      health=HealthPolicy(restart=False),
                      wave_cache={(None, scfg): clean},
                      wave_wrap=fleet_wrap(plans))
    fleet.submit(images[:12])
    out = fleet.drain()                  # crash, no survivor, no restart

    assert len(out) == 4                 # wave 0 only
    s = fleet.summary()
    assert s["completed"] == 4 and s["failed"] == 8
    assert s["evacuated"] == s["adopted"] == 0
    (ev,) = s["health_events"]
    assert ev["failed"] == 8 and ev["adopted_by"] is None
    assert ev["restarted"] is None
    assert fleet.n_replicas() == 0
    for name, t in s["per_tenant"].items():
        assert t["submitted"] == (t["completed"] + t["shed"] + t["failed"]
                                  + t["pending"]), (name, t)
        assert t["pending"] == 0


# ---------------------------------------------------------------------------
# Against the reference package
# ---------------------------------------------------------------------------

def test_fault_plans_match_the_reference():
    """Same seed and rates, same schedule as the reference's generator."""
    kw = dict(p_error=0.3, p_corrupt=0.2, p_straggle=0.2,
              persistent=((5, 3),), crash_wave=9)
    for seed in (0, 7, 123):
        got = FaultPlan.generate(seed, 40, **kw)
        want = jfaults.FaultPlan.generate(seed, 40, **kw)
        assert [dataclasses.astuple(e) for e in got.events] == \
            [dataclasses.astuple(e) for e in want.events]


def test_clean_predictions_match_the_reference_server(setup):
    """A chaos server with an empty plan predicts what the JAX server
    predicts on the same weights and images."""
    (cfg, params), net, images, scfg, clean = setup
    ref = jserve.CapsServer(params, cfg, cfg=jserve.ServeConfig(
        microbatch=2, n_micro=2, pipeline=None))
    ref.submit(images[:8])
    want = {c.rid: c.pred for c in ref.drain()}
    srv = CapsServer(net, device=CPU, cfg=scfg,
                     wave_fn=chaos_wave_fn(clean, FaultPlan()))
    srv.submit(images[:8])
    assert {c.rid: c.pred for c in srv.drain()} == want


def test_corrupt_poisons_a_copy_on_the_waves_device(setup):
    """The corrupt fault hands the guard a tensor of the wave's type and
    device with a NaN, and leaves the wave's own output untouched."""
    _, net, images, scfg, clean = setup
    from repro_torch.runtime.caps_serve import CapsAdapter
    adapter = CapsAdapter(net)
    micro = adapter.pack(list(images[:4]), scfg)
    out = clean(micro)
    wrapped = chaos_wave_fn(lambda m: out,
                            FaultPlan((FaultEvent(0, "corrupt"),)))
    bad = wrapped(micro)
    assert isinstance(bad, torch.Tensor) and bad.device == out.device
    assert torch.isnan(bad).sum() == 1 and torch.isfinite(out).all()
    assert not adapter.finite(bad) and adapter.finite(out)
