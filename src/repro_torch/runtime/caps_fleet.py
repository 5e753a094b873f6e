"""CapsFleet — multi-tenant replica fleet with SLO-aware admission and
elastic capacity.

Port of the JAX package's ``repro/runtime/caps_fleet.py``.  One
``CapsFleet`` fronts N replica wave servers (runtime.wave_serve, each over
a workload adapter — runtime.caps_serve's ``CapsAdapter`` by default) with
the admission, scheduling and capacity policies a shared serving
deployment needs:

* **Tenancy** — every ``submit()`` carries a tenant tag; a ``TenantPolicy``
  gives each tenant an in-system quota, a token-bucket rate limit
  (``rate`` req/s refill, ``burst`` capacity), a default SLO and a shed
  priority.  Enforcement is atomic at ``submit()`` — the same
  validate-then-mutate discipline as ``WaveServer.submit``: the arrival is
  validated, the quota/rate room computed, and the request forwarded to a
  replica *before* any fleet counter moves, so a rejected arrival leaves
  the fleet exactly as it was.
* **SLO-aware waves** — replicas run ``ServeConfig(queue_order=
  "deadline")``: wave formation pops a priority queue ordered by
  (deadline, arrival) instead of FIFO, and back-pressure sheds the
  most-doomed requests (expired first, then lowest priority) rather than
  tail-dropping.  Goodput (deadline-met completions) is first-class in the
  metrics.
* **Build-once, fleet-wide** — the wave function is cached per
  (adapter ``cache_key()``, plan) across the whole fleet: every replica of
  a model group — and every replica the controller adds later — reuses the
  same wave function, and with it one router and one set of weights on the
  device, so scale-up never rebuilds a router or copies weights.  Replicas
  of one group share the device; their driver threads launch on it in
  turn.
* **Elastic capacity** — a controller thread ticks
  ``elastic.ElasticController`` with queue depth and p90/median wave
  latency (per-replica ``straggler.StepWatchdog``); "up" starts a replica
  (to ``max_replicas``), "down" marks the least-loaded replica draining
  and sets its ``serve_forever`` stop event — it finishes its queue, its
  metrics are retired into the fleet aggregate, and nothing is lost.

* **Replica health + self-healing** — every replica is
  continuously classified HEALTHY / DEGRADED / DEAD from its consecutive
  wave failures, its watchdog p90-vs-median, its ``dead`` flag (set by a
  ``ReplicaCrash``) and its driver thread's liveness.  ``health_check()``
  — run by the controller thread each tick, and by the synchronous
  ``step()``/``drain()`` drivers — buries a DEAD replica: its driver
  stops, its queued backlog is **evacuated and re-dispatched** to the
  least-loaded survivor (``WaveServer.evacuate``/``adopt``; failed with
  accounting when no survivor exists), its metrics retire into the fleet
  aggregate, and capacity recovers by restarting a replacement through
  the ``ElasticController`` event log (``HealthPolicy.restart``).

The per-tenant accounting invariant (the fleet-level extension of the
single server's, held through every injected fault):

    submitted == completed + shed + failed + pending   (per tenant, any time)

where ``shed`` counts both admission throttling (quota/rate) and
replica-level back-pressure eviction, ``failed`` counts requests dropped
after ``ServeConfig.max_wave_retries`` exhausted wave retries (plus a
dead replica's backlog when no survivor could adopt it), and ``pending``
is what's queued or in flight across all replicas — evacuation/adoption
cancel out fleet-wide because a re-dispatched request leaves the dead
replica's books via ``evacuated`` exactly as it enters the survivor's via
``adopted``.

    net = CapsNet(CAPS_BENCHMARKS["Caps-MN1"])           # on the card
    fleet = CapsFleet(net, models={"default": RouterSpec(backend="cuda")},
                      tenants=[TenantPolicy("gold", slo_s=0.5, priority=1),
                               TenantPolicy("free", rate=50.0)])
    fleet.start()
    fleet.submit(images, tenant="gold")
    ...
    summary = fleet.stop()

``repro_torch.launch.serve_caps --replicas N --tenants T`` is the CLI.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from repro_torch.runtime import caps_serve, wave_serve
from repro_torch.runtime.elastic import ElasticController, ElasticPolicy
from repro_torch.runtime.straggler import StepWatchdog


class FleetAdmissionError(RuntimeError):
    """``submit()`` under ``overflow="reject"``: the arrival exceeds the
    tenant's quota or rate allowance.  Admission is atomic — no fleet or
    replica counter moved except ``rejected``."""


# Replica health states
HEALTHY = "healthy"
DEGRADED = "degraded"
DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """When a replica counts as DEGRADED or DEAD, and what to do about it.

    degraded_failures: consecutive failed wave attempts before a replica
                       is DEGRADED (still serving — retries are working).
    dead_failures:     consecutive failures before it is declared DEAD and
                       buried even without a ``ReplicaCrash`` (a replica
                       that can't complete a wave isn't coming back).
    slow_p90_factor:   watchdog p90 above ``factor × median`` also counts
                       as DEGRADED (straggling, not failing).
    restart:           bury a DEAD replica *and* start a replacement
                       through the elastic controller so capacity
                       recovers; False = capacity shrinks (backlog still
                       re-dispatched to survivors, or failed with
                       accounting when none remain).
    """
    degraded_failures: int = 1
    dead_failures: int = 3
    slow_p90_factor: float = 3.0
    restart: bool = True

    def __post_init__(self):
        if not (1 <= self.degraded_failures <= self.dead_failures):
            raise ValueError(
                f"need 1 <= degraded_failures <= dead_failures; got "
                f"{self.degraded_failures}..{self.dead_failures}")
        if self.slow_p90_factor <= 1:
            raise ValueError(f"slow_p90_factor must be > 1; got "
                             f"{self.slow_p90_factor}")


# ---------------------------------------------------------------------------
# Tenant policy + token bucket
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Admission contract for one tenant.

    quota:    max requests in-system (queued or in flight, fleet-wide);
              None = unlimited.
    rate:     token-bucket refill in requests/second; None = unlimited.
    burst:    bucket capacity — the largest instantaneous arrival a rated
              tenant can land (ignored when rate is None).
    slo_s:    default deadline applied to submits that don't carry one;
              None = no default SLO.
    priority: shed priority for this tenant's requests (higher = kept
              longer under back-pressure); per-submit override wins.
    """
    name: str
    quota: Optional[int] = None
    rate: Optional[float] = None
    burst: int = 32
    slo_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        if self.quota is not None and self.quota < 1:
            raise ValueError(f"quota must be >= 1 or None; got {self.quota}")
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"rate must be > 0 or None; got {self.rate}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1; got {self.burst}")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ValueError(f"slo_s must be > 0 or None; got {self.slo_s}")


class _TokenBucket:
    """Token bucket in whole requests: ``rate`` tokens/s refill capped at
    ``burst``.  Split into refill/available/take so the fleet can compute
    the grant under its lock *before* committing (validate-then-mutate)."""

    def __init__(self, rate: float, burst: int):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t_last: Optional[float] = None

    def refill(self, now: float) -> None:
        if self._t_last is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t_last) * self.rate)
        self._t_last = now

    def available(self) -> int:
        return int(self.tokens)

    def take(self, n: int) -> None:
        self.tokens -= n


@dataclasses.dataclass
class TenantAdmission:
    """Fleet-level admission counters for one tenant (replica-level
    completion/shed counters live in each replica's ``ServeMetrics``)."""
    offered: int = 0      # presented to submit() and not rejected-by-raise
    forwarded: int = 0    # handed to a replica queue
    throttled: int = 0    # shed at admission by quota/rate (offered - fwd)
    rejected: int = 0     # refused atomically (never counted in offered)


# ---------------------------------------------------------------------------
# Replica record + fleet config
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Replica:
    name: str
    model: str
    server: wave_serve.WaveServer
    watchdog: StepWatchdog
    stop: threading.Event
    thread: Optional[threading.Thread] = None
    draining: bool = False


def _merged_pct(durations: List[float], p: float) -> Optional[float]:
    """Nearest-rank percentile over replicas' merged watchdog windows."""
    if not durations:
        return None
    s = sorted(durations)
    return s[min(len(s), max(1, math.ceil(p * len(s)))) - 1]


class CapsFleet:
    """Quota/rate-limited, SLO-aware, elastically-sized front-end over N
    replica wave servers.

    ``net`` is the ``CapsNet`` (on its device) that CapsNet groups serve;
    None for a fleet of other workloads.  ``models`` maps a model-group
    name to what its replicas run: the CapsNet form ``(RouterSpec,
    ServeConfig)`` (spec None = default dynamic routing) over ``net``, or
    any ``wave_serve.WorkloadAdapter`` (bare, or ``(adapter,
    ServeConfig)``), so CapsNet, LM-decode and MoE groups serve side by
    side behind one admission front-end, all sharing the fleet-wide
    build-once wave cache (keyed per adapter ``cache_key()``).  Each group
    scales independently between ``policy.min_replicas`` and
    ``max_replicas``.

    Two driving modes: ``start()``/``stop()`` runs every replica's
    ``serve_forever`` plus the elastic controller on threads (completions
    collected via callback into ``self.completions``); without ``start()``
    the fleet is synchronous — ``step()`` runs one wave per replica and
    ``drain()`` runs to quiescence (deterministic tests/benches drive
    waves and controller ticks themselves via ``control_tick()``).
    """

    def __init__(self, net=None, *,
                 models: Optional[Mapping[str, Any]] = None,
                 tenants: Sequence[TenantPolicy] = (),
                 cfg: Optional[caps_serve.ServeConfig] = None,
                 policy: Optional[ElasticPolicy] = None,
                 overflow: str = "shed",
                 strict_tenants: bool = False,
                 control_interval_s: float = 0.2,
                 clock: Callable[[], float] = time.perf_counter,
                 wave_cache: Optional[Dict[Any, Callable]] = None,
                 health: Optional[HealthPolicy] = None,
                 wave_wrap: Optional[Callable[[str, Callable],
                                              Callable]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if overflow not in caps_serve.OVERFLOW_POLICIES:
            raise ValueError(f"unknown overflow policy {overflow!r}; "
                             f"expected one of {caps_serve.OVERFLOW_POLICIES}")
        self.net = net
        self.policy = policy if policy is not None else ElasticPolicy()
        self.overflow = overflow
        self.strict_tenants = strict_tenants
        self.control_interval_s = control_interval_s
        self.clock = clock
        # health: DEAD/DEGRADED classification + bury/restart policy;
        # wave_wrap(name, fn) -> fn' decorates each replica's wave
        # executable at creation — the fault-injection seam (faults.
        # fleet_wrap); production fleets leave it None and never touch the
        # chaos module.  sleep: retry-backoff sleeper for every replica
        # server, injectable for deterministic tests.
        self.health = health if health is not None else HealthPolicy()
        self._wave_wrap = wave_wrap
        self._sleep = sleep
        self._health_events: List[dict] = []
        self.completions: List[tuple] = []   # (replica_name, Completion)

        default_cfg = cfg if cfg is not None else caps_serve.ServeConfig(
            queue_order="deadline")
        if models is None:
            models = {"default": (None, None)}
        self._lock = threading.Lock()        # groups/replicas/admission
        self._done_lock = threading.Lock()   # completions list
        self._tenants: Dict[str, TenantPolicy] = {t.name: t for t in tenants}
        self._buckets: Dict[str, _TokenBucket] = {
            t.name: _TokenBucket(t.rate, t.burst)
            for t in tenants if t.rate is not None}
        self._admission: Dict[str, TenantAdmission] = {}
        self._retired: List[caps_serve.ServeMetrics] = []
        # wave_cache injection lets several fleets (e.g. one per bench
        # cell) share the build-once cache, not just replicas of one
        self._wave_cache: Dict[Any, Callable] = (
            wave_cache if wave_cache is not None else {})
        self._rep_ids = itertools.count()
        self._started = False
        self._stopping = False
        self._stop = threading.Event()
        self._controller_thread: Optional[threading.Thread] = None
        self._groups: Dict[str, dict] = {}
        for name, entry in models.items():
            adapter, spec, gcfg = self._as_adapter(entry, default_cfg)
            self._groups[name] = {
                "adapter": adapter, "spec": spec, "cfg": gcfg,
                "wave_fn": self._cached_wave_fn(adapter, gcfg),
                "controller": ElasticController(self.policy),
                "replicas": [],
            }
            for _ in range(self.policy.min_replicas):
                self._add_replica(name)

    def _as_adapter(self, entry, default_cfg):
        """Normalize a model-group entry to (adapter, spec, cfg).

        Entries may be a ``WorkloadAdapter`` (bare or ``(adapter, cfg)``)
        or the CapsNet form — a spec (None / RouterSpec), bare or ``(spec,
        cfg)`` — which binds a ``CapsAdapter`` over the fleet's net.  The
        spec slot of the group dict keeps the spec for CapsNet groups
        (adapter-backed groups carry their spec, if any, on the
        adapter)."""
        first, gcfg = (entry if isinstance(entry, tuple)
                       else (entry, None))
        gcfg = gcfg if gcfg is not None else default_cfg
        if isinstance(first, wave_serve.WorkloadAdapter):
            return first, getattr(first, "spec", None), gcfg
        if self.net is None:
            raise ValueError(
                "a (spec, cfg) model-group entry needs the fleet's CapsNet "
                "(net); pass a WorkloadAdapter instead for non-CapsNet "
                "groups")
        return caps_serve.CapsAdapter(self.net, first), first, gcfg

    # -- build-once wave cache ----------------------------------------------

    def _cached_wave_fn(self, adapter: wave_serve.WorkloadAdapter,
                        cfg) -> Callable:
        """Fleet-wide build-once: one wave function per (adapter
        ``cache_key()``, plan), shared by every replica — including those
        the elastic controller adds later (scale-up never rebuilds).
        CapsNet adapters key on their spec, so ``(spec, cfg)`` entries of
        an injected ``wave_cache`` hit; NO_CACHE adapters and unhashable
        plans (e.g. a list routing_plan) skip the cache."""
        key = (adapter.cache_key(), cfg)
        if adapter.cache_key() is wave_serve.NO_CACHE:
            key = None
        else:
            try:
                hash(key)
            except TypeError:
                key = None
        if key is not None and key in self._wave_cache:
            return self._wave_cache[key]
        fn = adapter.make_wave_fn(cfg)
        if key is not None:
            self._wave_cache[key] = fn
        return fn

    # -- replica lifecycle ---------------------------------------------------

    def _add_replica(self, model: str) -> _Replica:
        """Create (and, if the fleet is started, launch) one replica of a
        model group, reusing the group's cached wave executable (decorated
        per replica by ``wave_wrap`` when set — the chaos seam)."""
        g = self._groups[model]
        name = f"{model}/r{next(self._rep_ids)}"
        wave_fn = g["wave_fn"]
        if self._wave_wrap is not None:
            wave_fn = self._wave_wrap(name, wave_fn)
        rep = _Replica(
            name=name,
            model=model,
            server=wave_serve.WaveServer(
                g["adapter"], cfg=g["cfg"],
                clock=self.clock, wave_fn=wave_fn,
                watchdog=StepWatchdog(window=32, clock=self.clock),
                sleep=self._sleep),
            watchdog=None,  # alias filled below — one watchdog, two views
            stop=threading.Event(),
        )
        rep.watchdog = rep.server.watchdog
        g["replicas"].append(rep)
        if self._started:
            self._launch(rep)
        return rep

    def _launch(self, rep: _Replica) -> None:
        def run():
            rep.server.serve_forever(rep.stop, on_completion=self._emit(rep))
        rep.thread = threading.Thread(target=run, daemon=True,
                                      name=f"caps-fleet-{rep.name}")
        rep.thread.start()

    def _emit(self, rep: _Replica):
        def cb(c: caps_serve.Completion):
            with self._done_lock:
                self.completions.append((rep.name, c))
        return cb

    def _active(self, model: str) -> List[_Replica]:
        return [r for r in self._groups[model]["replicas"] if not r.draining]

    def n_replicas(self, model: Optional[str] = None) -> int:
        with self._lock:
            if model is not None:
                return len(self._active(model))
            return sum(len(self._active(m)) for m in self._groups)

    # -- replica health ------------------------------------------------------

    def _health_of(self, rep: _Replica) -> str:
        """Classify one replica.  DEAD: its server declared itself dead
        (``ReplicaCrash``), its driver thread died, or it has failed
        ``dead_failures`` consecutive waves.  DEGRADED: failing but still
        retrying, or watchdog p90 > factor × median (straggling)."""
        srv = rep.server
        hp = self.health
        thread_died = (self._started and rep.thread is not None
                       and not rep.thread.is_alive() and not rep.draining)
        if (srv.dead or thread_died
                or srv.consecutive_failures >= hp.dead_failures):
            return DEAD
        p90, med = rep.watchdog.percentile(0.9), rep.watchdog.median()
        slow = (p90 is not None and med is not None and med > 0
                and p90 > hp.slow_p90_factor * med)
        if srv.consecutive_failures >= hp.degraded_failures or slow:
            return DEGRADED
        return HEALTHY

    def health_check(self) -> Dict[str, str]:
        """Classify every non-draining replica; bury the DEAD ones
        (evacuate + re-dispatch + restart per ``HealthPolicy``).  Run by
        the controller thread every tick and by the synchronous drivers;
        callable directly for deterministic tests.  Returns
        {replica_name: state} as observed before any burial."""
        with self._lock:
            dead = []
            states = {}
            for model, g in self._groups.items():
                for rep in g["replicas"]:
                    if rep.draining:
                        continue
                    st = self._health_of(rep)
                    states[rep.name] = st
                    if st == DEAD:
                        dead.append((model, rep))
        for model, rep in dead:
            self._bury(model, rep)
        return states

    def _bury(self, model: str, rep: _Replica) -> None:
        """Retire a DEAD replica: stop its driver, restart a replacement
        through the elastic controller (``HealthPolicy.restart``),
        re-dispatch its backlog to the least-loaded survivor — or fail it
        with accounting when no survivor exists — and retire its metrics
        into the fleet aggregate.  Nothing is lost and the per-tenant
        invariant holds through the hand-off."""
        g = self._groups[model]
        rep.server.dead = True          # stop further waves (sync mode too)
        rep.stop.set()
        if rep.thread is not None:
            rep.thread.join()
            rep.thread = None
        with self._lock:
            if rep not in g["replicas"]:
                return                  # lost the race with another burial
            g["replicas"].remove(rep)
            self._retired.append(rep.server.metrics)
            # no replacements while the fleet is shutting down — the
            # backlog still re-dispatches to (stopped) survivors, which
            # stop() drains inline
            replacement = (self._add_replica(model)
                           if self.health.restart and not self._stopping
                           else None)
            survivors = self._active(model)
        backlog = rep.server.evacuate() if survivors else []
        failed = 0 if survivors else rep.server.abandon()
        adopted_by = None
        if backlog:
            target = min(survivors, key=lambda r: r.server.pending())
            target.server.adopt(backlog)
            adopted_by = target.name
        event = {"replica": rep.name, "model": model,
                 "evacuated": len(backlog), "failed": failed,
                 "adopted_by": adopted_by,
                 "restarted": replacement.name if replacement else None,
                 "last_error": rep.server.metrics.last_error}
        g["controller"].note("restart" if replacement else "dead", **event)
        with self._lock:
            self._health_events.append(dict(state=DEAD, **event))

    # -- admission -----------------------------------------------------------

    def submit(self, items, *, tenant: str = "default",
               model: str = "default",
               deadline_s: Optional[float] = None,
               priority: Optional[int] = None) -> List[str]:
        """Admit an arrival for ``tenant``; returns fleet-wide request ids
        ("<replica>:<rid>") for whatever was admitted.

        ``items`` is whatever the model group's adapter accepts (images
        for CapsNet groups, prompt rows for LM, activation blocks for
        MoE).  Validate-then-mutate, atomically under the fleet lock: the
        arrival is validated by the group's adapter, the tenant's quota
        room and rate-bucket grant computed, and only then do counters
        move.  Excess beyond the grant is throttled (``overflow="shed"``,
        counted per tenant) or the whole arrival is refused
        (``overflow="reject"`` raises ``FleetAdmissionError``, nothing
        admitted).  The admitted slice goes to the least-loaded
        non-draining replica of ``model``; ``deadline_s``/``priority``
        default to the tenant's policy (``slo_s``/``priority``).
        """
        # group resolution needs no lock: _groups keys are fixed at
        # construction (only the replica lists mutate)
        g = self._groups.get(model)
        if g is None:
            raise KeyError(f"unknown model group {model!r}; have "
                           f"{sorted(self._groups)}")
        arr = g["adapter"].validate(items)
        n = len(arr)
        if n == 0:
            return []
        with self._lock:
            pol = self._tenants.get(tenant)
            if pol is None:
                if self.strict_tenants:
                    raise KeyError(f"unknown tenant {tenant!r} (fleet is "
                                   f"strict_tenants); have "
                                   f"{sorted(self._tenants)}")
                pol = TenantPolicy(tenant)
            adm = self._admission.setdefault(tenant, TenantAdmission())
            now = self.clock()
            # -- validate: compute the grant, mutate nothing ----------------
            room = n
            if pol.quota is not None:
                room = min(room, max(0, pol.quota
                                     - self._tenant_pending(tenant)))
            bucket = self._buckets.get(tenant)
            if bucket is not None:
                bucket.refill(now)       # time accounting, not a grant
                room = min(room, bucket.available())
            if room < n and self.overflow == "reject":
                adm.rejected += n
                raise FleetAdmissionError(
                    f"tenant {tenant!r}: arrival of {n} > admission room "
                    f"{room} (quota={pol.quota}, rate={pol.rate}); "
                    "nothing admitted")
            # -- mutate: forward to the least-loaded replica, then count ----
            rids: List[str] = []
            if room > 0:
                rep = min(self._active(model),
                          key=lambda r: r.server.pending())
                got = rep.server.submit(
                    arr[:room], tenant=tenant,
                    deadline_s=(deadline_s if deadline_s is not None
                                else pol.slo_s),
                    priority=(priority if priority is not None
                              else pol.priority))
                rids = [f"{rep.name}:{rid}" for rid in got]
            if bucket is not None:
                bucket.take(room)
            adm.offered += n
            adm.forwarded += room
            adm.throttled += n - room
        return rids

    def _tenant_pending(self, tenant: str) -> int:
        """In-system requests for a tenant across all replicas (queued or
        in flight).  Caller holds the fleet lock; replica counters are read
        without the replica lock — plain int reads, and staleness only
        makes the quota check momentarily conservative."""
        total = 0
        for g in self._groups.values():
            for rep in g["replicas"]:
                t = rep.server.metrics.tenants.get(tenant)
                if t is not None:
                    total += t.pending
        return total

    def pending(self) -> int:
        with self._lock:
            return sum(rep.server.pending()
                       for g in self._groups.values()
                       for rep in g["replicas"])

    # -- synchronous driving (deterministic tests/benches) -------------------

    def step(self) -> List[tuple]:
        """One wave on every active replica (synchronous mode); returns
        [(replica_name, Completion), ...] and appends to ``completions``.
        A ``ReplicaCrash`` is absorbed — the crashed replica's accounting
        is already restored by its ``step()``, and an immediate
        ``health_check()`` buries it and re-dispatches its backlog."""
        with self._lock:
            reps = [r for g in self._groups.values() for r in g["replicas"]]
        out = []
        crashed = False
        for rep in reps:
            try:
                for c in rep.server.step():
                    out.append((rep.name, c))
            except caps_serve.ReplicaCrash:
                crashed = True
        with self._done_lock:
            self.completions.extend(out)
        if crashed:
            self.health_check()
        return out

    def drain(self) -> List[tuple]:
        """Step until every replica is quiescent (synchronous mode).
        Fault-aware like ``WaveServer.drain``: an empty step no longer
        means done (a failed wave returns nothing but requeues), so the
        termination test is fleet-wide ``pending() == 0`` — bounded
        retries plus burial of dead replicas guarantee progress."""
        out: List[tuple] = []
        while True:
            got = self.step()
            out.extend(got)
            if not got:
                self.health_check()     # a quiet tick may hide a dead rep
                if self.pending() == 0:
                    return out

    # -- elastic control -----------------------------------------------------

    def control_tick(self) -> Dict[str, str]:
        """One controller observation+decision per model group; applies
        the decision (start or drain a replica).  Called by the controller
        thread every ``control_interval_s``; callable directly for
        deterministic tests.  Returns {model: decision}.  Health runs
        first: a DEAD replica is buried (backlog re-dispatched, capacity
        restarted) before the capacity controller observes the fleet."""
        self.health_check()
        decisions = {}
        for model in list(self._groups):
            g = self._groups[model]
            with self._lock:
                active = self._active(model)
                self._reap(model)
            queued = sum(r.server.pending() for r in active)
            durations = [d for r in active for d in r.watchdog.durations]
            decision = g["controller"].observe(
                len(active), queued, g["cfg"].wave_lanes,
                p90_s=_merged_pct(durations, 0.9),
                median_s=_merged_pct(durations, 0.5))
            if decision == "up":
                with self._lock:
                    self._add_replica(model)
            elif decision == "down":
                self._drain_one(model)
            decisions[model] = decision
        return decisions

    def _drain_one(self, model: str) -> Optional[_Replica]:
        """Scale-down: mark the least-loaded active replica draining and
        set its stop event — ``serve_forever`` finishes everything queued,
        then the reaper retires its metrics.  New submits never route to a
        draining replica, so nothing is lost mid-drain."""
        with self._lock:
            active = self._active(model)
            if len(active) <= self.policy.min_replicas:
                return None
            rep = min(active, key=lambda r: r.server.pending())
            rep.draining = True
        rep.stop.set()
        if rep.thread is None:          # synchronous mode: drain inline
            for c in rep.server.drain():
                with self._done_lock:
                    self.completions.append((rep.name, c))
        return rep

    def _reap(self, model: str) -> None:
        """Retire drained replicas: once a draining replica's thread has
        exited (or, synchronously, its queue is empty), fold its metrics
        into the retired aggregate and drop it.  Caller holds the lock."""
        g = self._groups[model]
        keep = []
        for rep in g["replicas"]:
            done = rep.draining and (
                rep.thread is None or not rep.thread.is_alive())
            if done and rep.server.pending() == 0:
                if rep.thread is not None:
                    rep.thread.join()
                self._retired.append(rep.server.metrics)
            else:
                keep.append(rep)
        g["replicas"] = keep

    def _control_loop(self):
        while not self._stop.wait(self.control_interval_s):
            self.control_tick()

    # -- threaded lifecycle --------------------------------------------------

    def start(self) -> "CapsFleet":
        """Launch every replica's ``serve_forever`` plus the elastic
        controller on daemon threads.  Idempotent."""
        with self._lock:
            if self._started:
                return self
            self._started = True
            reps = [r for g in self._groups.values() for r in g["replicas"]]
        for rep in reps:
            self._launch(rep)
        self._controller_thread = threading.Thread(
            target=self._control_loop, daemon=True, name="caps-fleet-ctl")
        self._controller_thread.start()
        return self

    def stop(self) -> Dict[str, Any]:
        """Stop the controller, drain and join every replica, and return
        the final ``summary()``.  Every admitted request completes, was
        shed, or failed with accounting — never silently dropped: a
        replica that died after the controller's last tick is buried here
        (its backlog re-dispatched and drained inline on the stopped
        survivors), so shutdown self-heals exactly like steady state."""
        self._stop.set()
        if self._controller_thread is not None:
            self._controller_thread.join()
            self._controller_thread = None
        # bury already-dead replicas while the survivors' drivers still
        # run — the adopted backlog drains on their threads
        self.health_check()
        self._stopping = True       # _bury: no replacements from here on
        with self._lock:
            reps = [r for g in self._groups.values() for r in g["replicas"]]
        for rep in reps:
            rep.stop.set()
        for rep in reps:
            if rep.thread is not None:
                rep.thread.join()
                rep.thread = None
            elif rep.server.pending():
                try:                               # synchronous-mode stop
                    for c in rep.server.drain():
                        with self._done_lock:
                            self.completions.append((rep.name, c))
                except caps_serve.ReplicaCrash:
                    pass                           # buried below
        # late deaths (a crash during the final drain): bounded self-heal
        # rounds — each round buries the dead, re-dispatches, and drains
        # the stopped survivors inline; burials are finite, so this
        # converges to pending() == 0 (or everything failed-with-books)
        for _ in range(len(reps) + 2):
            self.health_check()
            if self.pending() == 0:
                break
            with self._lock:
                live = [r for g in self._groups.values()
                        for r in g["replicas"]]
            for rep in live:
                if rep.thread is None and rep.server.pending():
                    try:
                        for c in rep.server.drain():
                            with self._done_lock:
                                self.completions.append((rep.name, c))
                    except caps_serve.ReplicaCrash:
                        pass
        with self._lock:
            for model in self._groups:
                self._reap(model)
            self._started = False
            self._stopping = False
        return self.summary()

    # -- metrics -------------------------------------------------------------

    def _replica_metrics(self) -> List[caps_serve.ServeMetrics]:
        return ([rep.server.metrics
                 for g in self._groups.values() for rep in g["replicas"]]
                + list(self._retired))

    def tenant_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant fleet accounting, merging admission counters with
        every replica's (live and retired) per-tenant metrics.  Per
        tenant: ``submitted == completed + shed + failed + pending``,
        where shed = admission throttling + replica back-pressure
        eviction and failed = retry exhaustion + abandoned dead-replica
        backlog.  Evacuation/adoption cancel out here: a re-dispatched
        request leaves the dead replica's books (``evacuated``) exactly
        as it enters the survivor's (``submitted``), so ``pending`` is
        simply forwarded minus everything terminal."""
        with self._lock:
            metrics = self._replica_metrics()
            admission = {t: dataclasses.replace(a)
                         for t, a in self._admission.items()}
        # dict.copy() is one C call (atomic under the GIL) — safe against a
        # replica thread registering a new tenant mid-summary
        tenant_maps = [m.tenants.copy() for m in metrics]
        names = set(admission)
        for tm in tenant_maps:
            names.update(tm)
        out: Dict[str, Dict[str, Any]] = {}
        for name in sorted(names):
            adm = admission.get(name, TenantAdmission())
            completed = shed_rep = goodput = rejected_rep = 0
            failed = evacuated = 0
            for tm in tenant_maps:
                t = tm.get(name)
                if t is None:
                    continue
                completed += t.completed
                shed_rep += t.shed
                goodput += t.deadline_met
                rejected_rep += t.rejected
                failed += t.failed
                evacuated += t.evacuated
            out[name] = {
                "submitted": adm.offered,
                "forwarded": adm.forwarded,
                "completed": completed,
                "shed": adm.throttled + shed_rep,
                "shed_admission": adm.throttled,
                "rejected": adm.rejected + rejected_rep,
                "goodput": goodput,
                "failed": failed,
                "evacuated": evacuated,
                "pending": adm.forwarded - completed - shed_rep - failed,
            }
        return out

    def summary(self) -> Dict[str, Any]:
        """JSON-safe fleet roll-up: totals, per-tenant breakdown,
        per-replica wave stats, scale events, merged latency percentiles.
        Strictly finite numbers or None (never NaN/Infinity)."""
        per_tenant = self.tenant_summary()
        with self._lock:
            metrics = self._replica_metrics()
            live = {rep.name: dict(rep.server.metrics.summary(),
                                   health=self._health_of(rep))
                    for g in self._groups.values()
                    for rep in g["replicas"]}
            scale_events = {m: list(g["controller"].events)
                            for m, g in self._groups.items()}
            health_events = list(self._health_events)
            n_active = sum(len(self._active(m)) for m in self._groups)
        lat = sorted(x for m in metrics for x in m.latencies_s)
        totals = {k: sum(t[k] for t in per_tenant.values())
                  for k in ("submitted", "completed", "shed", "rejected",
                            "goodput", "failed", "pending")}
        return {
            **totals,
            "replicas": n_active,
            "replicas_retired": len(self._retired),
            "waves": sum(m.waves for m in metrics),
            "padded_lanes": sum(m.padded_lanes for m in metrics),
            "shed_expired": sum(m.shed_expired for m in metrics),
            "retried": sum(m.retried for m in metrics),
            "requeued": sum(m.requeued for m in metrics),
            "guard_trips": sum(m.guard_trips for m in metrics),
            "wave_errors": sum(m.wave_errors for m in metrics),
            "evacuated": sum(m.evacuated for m in metrics),
            "adopted": sum(m.adopted for m in metrics),
            "health_events": health_events,
            "per_tenant": per_tenant,
            "per_replica": live,
            "scale_events": scale_events,
            "p50_latency_s": _merged_pct(lat, 0.5),
            "p90_latency_s": _merged_pct(lat, 0.9),
        }
