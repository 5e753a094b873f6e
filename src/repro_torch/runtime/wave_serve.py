"""WaveServe — the model-agnostic wave-serving core (DESIGN.md §WaveServe).

A copy of the JAX package's ``repro/runtime/wave_serve.py`` (numpy only;
the port imports nothing of ``repro``).  The one change: the default
``WorkloadAdapter.finite`` also takes a torch tensor that lies on the card.

The paper's §4 host‖PIM pipeline argument is not CapsNet-specific: MoE
expert dispatch and LM decode have the same "massive unshareable
intermediates + intensive synchronization" shape §2.2 characterizes, and
CapsAcc makes the same case that one pipelined engine should serve every
layer type.  This module is the serving half of that claim: bounded-queue
atomic admission, deadline waves, compile-once executables, shed/reject
back-pressure, bounded retries, the NaN/Inf output guard,
evacuation/adoption — parameterized by a thin ``WorkloadAdapter`` that is
the only place model code appears.  ``runtime.caps_serve`` (CapsNet) and
``runtime.serve_loop`` (LM decode, MoE) supply adapters;
``runtime.caps_fleet`` multiplexes replica ``WaveServer``s of any adapter
mix behind one admission front-end, and ``runtime.faults`` wraps their
wave functions with scheduled faults.

The adapter contract (every method is model code; nothing else is):

  validate(items)        -> sequence of per-request payloads, or raise
                            ``ValueError`` with NO side effects (the
                            validate half of validate-then-mutate).
  make_wave_fn(cfg)      -> the compile-once wave executable; called once
                            per server (fleets cache it per
                            ``cache_key()`` and share across replicas).
  pack(payloads, cfg)    -> pad up to ``cfg.wave_lanes`` payloads into the
                            executable's fixed-shape wave input.  Padding
                            must be *bit-invariant* for the real lanes
                            (CapsNet masks votes per lane; batch-local
                            workloads are invariant by construction).
  unpack(out, n)         -> the first ``n`` per-request results from a
                            wave output (the ``Completion.pred`` values).
  finite(out)            -> output-guard predicate (default: np.isfinite
                            over the wave output).
  make_reference_wave_fn(cfg) -> quarantine executable for a guard trip
                            (None = no reference: a non-finite wave fails
                            like any wave error and retries).
  cache_key()            -> hashable fleet wave-cache key component, or
                            the NO_CACHE sentinel to skip caching.

Admission, accounting, fault semantics, and the accounting invariant

    metrics.submitted == metrics.completed + metrics.shed
                         + metrics.failed + metrics.evacuated + pending()

are exactly those documented in ``runtime.caps_serve`` (DESIGN.md
§Serving/§Faults) — that module's ``CapsServer`` is now a two-line
subclass binding ``CapsAdapter``, bit-identical to its pre-refactor
behavior.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np


class QueueFullError(RuntimeError):
    """``submit()`` under ``overflow="reject"``: the arrival does not fit
    the bounded queue.  Admission is atomic — the queue and the admission
    counters are exactly as before the call (``metrics.rejected`` records
    the refusal)."""


class ReplicaCrash(RuntimeError):
    """The wave executable declared this replica dead — a lost device, a
    wedged kernel, or the chaos crash fault (DESIGN.md §Faults).  Unlike a
    transient wave exception this is not retried: ``step()`` restores the
    accounting (the wave's requests go back to the queue at their original
    order keys), marks the server ``dead`` and re-raises;
    ``serve_forever`` records it in the metrics and exits cleanly so a
    fleet health check can ``evacuate()`` the backlog and re-dispatch it
    to surviving replicas (``runtime.caps_fleet``)."""


OVERFLOW_POLICIES = ("shed", "reject")
QUEUE_ORDERS = ("fifo", "deadline")

# cache_key() sentinel for "never cache this adapter's executable" — a
# distinct object because None is a legitimate key component (a CapsNet
# adapter with the default spec keys its cache entry on spec=None)
NO_CACHE = object()


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Shape and execution policy of one serving wave.

    Frozen on purpose: adapters compile the wave executable once per
    (adapter, plan), so plan-affecting fields must not drift afterwards.

    microbatch:   lanes per microbatch (the pipeline's transfer unit).
    n_micro:      microbatches per wave; one ``step()`` runs one wave, so
                  wave capacity = microbatch * n_micro requests.
    pipeline:     "software" (skewed-scan overlap, any device count),
                  "two_stage" (disjoint device groups over ``pipeline_axis``,
                  needs |axis| == 2 — the paper's GPU‖HMC split), or None
                  (unpipelined reference arm).  Interpreted by the
                  workload adapter's ``make_wave_fn`` (the CapsNet adapter
                  pipelines encode‖route; single-stage adapters ignore it).
    routing_plan: distribution of the routing stage — None (unsharded),
                  "auto" (§5.1.2 planner picks the dimension), or explicit
                  ((dim, mesh_axis), ...) pairs — adapter-interpreted.
    mesh:         mesh hosting pipeline_axis and/or the routing axes.
    max_queue:    bounded-queue depth for back-pressure; None = unbounded.
    overflow:     what ``submit()`` does when an arrival exceeds the bound:
                  "shed" admits up to the bound and drops the excess
                  (counted in ``metrics.shed`` — FIFO tail-drops the
                  arrival; the deadline queue evicts the most-doomed
                  requests: expired first, then lowest priority, then
                  earliest deadline); "reject" raises ``QueueFullError``
                  admitting nothing.
    queue_order:  "fifo" (arrival order) or "deadline" — SLO-aware wave
                  formation: the queue is a priority queue ordered by
                  (deadline, arrival), so waves form from the requests
                  closest to violating their SLO (DESIGN.md §Fleet);
                  deadline-less requests sort last, FIFO among themselves.
    max_wave_retries: fault tolerance (DESIGN.md §Faults) — how many
                  failed waves a request survives before it is *failed*
                  with accounting.  A wave exception requeues its requests
                  at their original order keys (``metrics.requeued``) and
                  each carries a retry count; a request whose count
                  exceeds this bound is counted in ``metrics.failed`` (and
                  per tenant) instead of being requeued, so a persistent
                  fault converges instead of retrying forever.
    retry_backoff_s: base backoff slept after a failed wave, doubled per
                  consecutive failure (0 = no backoff; the sleep callable
                  is injectable on the server for deterministic tests).
    output_guard: NaN/Inf quarantine of wave outputs — a non-finite wave
                  is counted in ``metrics.guard_trips`` and re-run through
                  the adapter's reference executable (for CapsNet the
                  eager torch router, ``core.router.reference_spec``); a
                  wave whose *reference*
                  re-run is still non-finite — or whose adapter has no
                  reference — fails like any other wave error.  The guard
                  only reads finished outputs, so a finite (fault-free)
                  wave is bit-identical with the guard on or off.
    """
    microbatch: int = 8
    n_micro: int = 4
    pipeline: Optional[str] = "software"
    pipeline_axis: str = "pipe"
    routing_plan: Any = None
    mesh: Any = None
    max_queue: Optional[int] = None
    overflow: str = "shed"
    queue_order: str = "fifo"
    max_wave_retries: int = 2
    retry_backoff_s: float = 0.0
    output_guard: bool = True

    def __post_init__(self):
        if self.microbatch < 1 or self.n_micro < 1:
            raise ValueError("ServeConfig needs microbatch >= 1 and "
                             f"n_micro >= 1; got {self.microbatch} x "
                             f"{self.n_micro}")
        if self.overflow not in OVERFLOW_POLICIES:
            raise ValueError(f"unknown overflow policy {self.overflow!r}; "
                             f"expected one of {OVERFLOW_POLICIES}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None; got "
                             f"{self.max_queue}")
        if self.queue_order not in QUEUE_ORDERS:
            raise ValueError(f"unknown queue_order {self.queue_order!r}; "
                             f"expected one of {QUEUE_ORDERS}")
        if self.max_wave_retries < 0:
            raise ValueError(f"max_wave_retries must be >= 0; got "
                             f"{self.max_wave_retries}")
        if self.retry_backoff_s < 0:
            raise ValueError(f"retry_backoff_s must be >= 0; got "
                             f"{self.retry_backoff_s}")

    @property
    def wave_lanes(self) -> int:
        return self.microbatch * self.n_micro


@dataclasses.dataclass
class Request:
    rid: int
    payload: Any                        # one workload unit (adapter-defined)
    t_submit: float
    tenant: str = "default"
    deadline: Optional[float] = None    # absolute clock time; None = no SLO
    priority: int = 0                   # higher = more important to keep
    retries: int = 0                    # failed waves survived so far

    @property
    def image(self):
        """Pre-WaveServe alias: CapsNet payloads are images."""
        return self.payload

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def order_key(self) -> tuple:
        """(deadline, arrival) — the SLO-aware wave-formation order.
        Deadline-less requests sort last, FIFO among themselves."""
        return (self.deadline if self.deadline is not None else math.inf,
                self.rid)

    def shed_key(self, now: float) -> tuple:
        """Victim preference under back-pressure (smaller = shed first):
        expired first, then lowest priority, then earliest deadline (the
        most-doomed request; deadline-less requests shed last)."""
        return (0 if self.expired(now) else 1, self.priority,
                self.deadline if self.deadline is not None else math.inf,
                self.rid)


@dataclasses.dataclass
class Completion:
    rid: int
    pred: Any                           # per-request result (adapter-defined)
    latency_s: float
    tenant: str = "default"
    deadline_met: bool = True           # True when the request had no SLO


@dataclasses.dataclass
class TenantMetrics:
    """Per-tenant slice of the admission/completion accounting — the same
    invariant holds per tenant (DESIGN.md §Faults):
    submitted == completed + shed + failed + evacuated + pending."""
    submitted: int = 0
    completed: int = 0
    shed: int = 0
    rejected: int = 0
    deadline_met: int = 0   # completions inside their SLO (goodput)
    failed: int = 0         # dropped after exhausting max_wave_retries
    evacuated: int = 0      # handed off to another replica (fleet rescue)

    @property
    def pending(self) -> int:
        return (self.submitted - self.completed - self.shed - self.failed
                - self.evacuated)

    def summary(self) -> Dict[str, int]:
        return {"submitted": self.submitted, "completed": self.completed,
                "shed": self.shed, "rejected": self.rejected,
                "deadline_met": self.deadline_met, "failed": self.failed,
                "evacuated": self.evacuated, "pending": self.pending}


@dataclasses.dataclass
class ServeMetrics:
    submitted: int = 0
    completed: int = 0
    shed: int = 0          # admitted into `submitted`, dropped by back-pressure
    rejected: int = 0      # refused atomically — never counted in `submitted`
    waves: int = 0
    padded_lanes: int = 0
    deadline_met: int = 0  # completions inside their SLO (goodput)
    shed_expired: int = 0  # shed victims already past deadline at eviction
    # -- fault accounting (DESIGN.md §Faults) --------------------------------
    failed: int = 0        # requests dropped after exhausting wave retries
    retried: int = 0       # failed wave attempts whose requests got requeued
    requeued: int = 0      # requests pushed back (original order keys)
    guard_trips: int = 0   # non-finite waves quarantined to the reference
    evacuated: int = 0     # queued requests pulled off this (dead) replica
    adopted: int = 0       # requests adopted from a dead replica (in submitted)
    wave_errors: int = 0   # wave attempts that raised (incl. the crash)
    callback_errors: int = 0   # on_completion callbacks that raised
    last_error: Optional[str] = None
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    tenants: Dict[str, TenantMetrics] = dataclasses.field(
        default_factory=dict)
    t_first_submit: Optional[float] = None
    t_last_done: Optional[float] = None

    def tenant(self, name: str) -> TenantMetrics:
        t = self.tenants.get(name)
        if t is None:
            t = self.tenants[name] = TenantMetrics()
        return t

    def summary(self) -> Dict[str, Any]:
        """JSON-safe summary: strictly finite numbers or ``None`` (never
        NaN/Infinity — strict JSON parsers reject those), with nearest-rank
        percentiles (the ceil(p*n)-th smallest, 1-indexed)."""
        lat = sorted(self.latencies_s)
        n = len(lat)

        def pct(p: float) -> Optional[float]:
            if n == 0:
                return None
            return lat[min(n, max(1, math.ceil(p * n))) - 1]

        span = ((self.t_last_done - self.t_first_submit)
                if self.t_first_submit is not None
                and self.t_last_done is not None else 0.0)
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "rejected": self.rejected,
            "waves": self.waves,
            "padded_lanes": self.padded_lanes,
            "goodput": self.deadline_met,
            "shed_expired": self.shed_expired,
            "failed": self.failed,
            "retried": self.retried,
            "requeued": self.requeued,
            "guard_trips": self.guard_trips,
            "evacuated": self.evacuated,
            "adopted": self.adopted,
            "wave_errors": self.wave_errors,
            "callback_errors": self.callback_errors,
            "last_error": self.last_error,
            "per_tenant": {name: t.summary()
                           for name, t in sorted(self.tenants.items())},
            "p50_latency_s": pct(0.5),
            "p90_latency_s": pct(0.9),
            "throughput_rps": (self.completed / span) if span > 0 else None,
        }


# ---------------------------------------------------------------------------
# WorkloadAdapter — the only place model code appears
# ---------------------------------------------------------------------------

class WorkloadAdapter:
    """Model-side half of the serving contract (see module docstring).

    Subclass per workload; instances must be safe to share across replica
    servers (they hold params and static config, never per-request state).
    ``runtime.caps_serve.CapsAdapter`` (CapsNet waves over the §4
    pipeline), ``runtime.serve_loop.LMDecodeAdapter`` (greedy LM
    generation) and ``runtime.serve_loop.MoEAdapter`` (fixed-shape MoE
    microbatches through the 'moe' Router algorithm) implement it.
    """

    def validate(self, items) -> Sequence:
        """Assemble an arrival into a sequence of per-request payloads, or
        raise ``ValueError`` with NO side effects (validate-then-mutate:
        both the server and the fleet front-end call this before any
        counter moves)."""
        raise NotImplementedError

    def make_wave_fn(self, cfg: ServeConfig) -> Callable:
        """Build the compile-once wave executable:
        ``wave(pack(payloads, cfg)) -> wave output``."""
        raise NotImplementedError

    def make_reference_wave_fn(self, cfg: ServeConfig) -> Optional[Callable]:
        """Quarantine executable for the output guard's NaN/Inf re-run
        (None = no reference: a non-finite wave fails like a wave error
        and takes the bounded-retry path instead)."""
        return None

    def pack(self, payloads: Sequence, cfg: ServeConfig):
        """Pad up to ``cfg.wave_lanes`` payloads into the executable's
        constant wave shape.  Padding must never perturb real lanes."""
        raise NotImplementedError

    def unpack(self, out, n: int) -> List:
        """First ``n`` per-request results from a wave output."""
        raise NotImplementedError

    def finite(self, out) -> bool:
        """Output-guard predicate; default checks every element of the
        (float-array-like) wave output — a torch tensor on the card is
        copied to the host first."""
        if hasattr(out, "detach"):
            out = out.detach().cpu()
        return bool(np.isfinite(np.asarray(out)).all())

    def cache_key(self) -> Hashable:
        """Fleet wave-cache key component: replicas (and groups) whose
        ``(cache_key(), cfg)`` match share one compiled executable.
        Return the ``NO_CACHE`` sentinel (the default) to never cache."""
        return NO_CACHE


# ---------------------------------------------------------------------------
# WaveServer — queue -> pad -> wave, for any adapter
# ---------------------------------------------------------------------------

class WaveServer:
    """Continuous-batching wave server over a ``WorkloadAdapter``
    (DESIGN.md §Serving/§WaveServe).

    ``submit()`` admits any number of requests at any time from any thread;
    ``step()`` drains up to one wave (``cfg.wave_lanes`` requests) from the
    queue, packs them into the adapter's fixed wave shape, runs the wave
    executable, and returns per-request completions with queue+compute
    latency.  ``drain()`` steps until the queue is empty;
    ``serve_forever(stop_event)`` is the async driver — run it on its own
    thread while clients submit concurrently.
    """

    def __init__(self, adapter: WorkloadAdapter, *,
                 cfg: Optional[ServeConfig] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 wave_fn: Optional[Callable] = None,
                 watchdog=None,
                 sleep: Callable[[float], None] = time.sleep):
        self.adapter = adapter
        # cfg=None -> a fresh instance per server (a shared default-arg
        # instance would alias every server built without an explicit cfg)
        self.cfg = cfg if cfg is not None else ServeConfig()
        self.clock = clock
        self.metrics = ServeMetrics()
        # FIFO waves pop arrival order from a deque; deadline waves pop the
        # (deadline, arrival) min from a heap — both are `self._queue`
        # (len()/truthiness shared), only push/pop differ.
        self._queue = (collections.deque()
                       if self.cfg.queue_order == "fifo" else [])
        self._inflight = 0          # popped for a wave, not yet completed
        self._next_rid = 0
        # heap tiebreaker: adopt() admits requests minted by *another*
        # replica, so (order_key) alone — which ends in that replica's rid
        # — can collide; the monotone sequence keeps heap entries totally
        # ordered without ever comparing Request objects
        self._seq = itertools.count()
        # one lock guards queue + metrics + rid counter; the condition lets
        # serve_forever sleep until an admission arrives
        self._cv = threading.Condition()
        # wave_fn injection: replica fleets build once per (adapter, plan)
        # fleet-wide and hand every replica the same executable
        # (runtime.caps_fleet); watchdog: a straggler.StepWatchdog timing
        # every wave (the fleet's p90/straggler signal); sleep: the retry
        # backoff's sleeper, injectable for deterministic fault tests.
        self._wave_fn = (wave_fn if wave_fn is not None
                         else adapter.make_wave_fn(self.cfg))
        self.watchdog = watchdog
        self._sleep = sleep
        # lazy reference executable for the output guard (built only on
        # the first guard trip — the fault-free path never pays the
        # second compile); _ref_built distinguishes "not built yet" from
        # "adapter has no reference".
        self._ref_wave_fn: Optional[Callable] = None
        self._ref_built = False
        self.dead = False           # set by a ReplicaCrash; no more waves
        self._consecutive_failures = 0

    @property
    def consecutive_failures(self) -> int:
        """Consecutive failed wave attempts (reset on success) — the fleet
        health check's DEGRADED/DEAD signal (DESIGN.md §Faults)."""
        return self._consecutive_failures

    # -- admission -----------------------------------------------------------

    def _push(self, req: Request) -> None:
        if self.cfg.queue_order == "fifo":
            self._queue.append(req)
        else:
            heapq.heappush(self._queue,
                           (req.order_key(), next(self._seq), req))

    def _pop_next(self) -> Request:
        if self.cfg.queue_order == "fifo":
            return self._queue.popleft()
        return heapq.heappop(self._queue)[-1]

    def _evict_excess(self, now: float) -> None:
        """Deadline-queue shed: drop queue entries beyond ``max_queue``,
        preferring the most-doomed (expired first, then lowest priority,
        then earliest deadline) — never random, never the freshest arrival
        just because it arrived last.  Caller holds the lock."""
        excess = len(self._queue) - self.cfg.max_queue
        if excess <= 0:
            return
        reqs = [e[-1] for e in self._queue]
        reqs.sort(key=lambda r: r.shed_key(now))
        victims, keep = reqs[:excess], reqs[excess:]
        self._queue[:] = [(r.order_key(), next(self._seq), r) for r in keep]
        heapq.heapify(self._queue)
        for r in victims:
            self.metrics.shed += 1
            self.metrics.tenant(r.tenant).shed += 1
            if r.expired(now):
                self.metrics.shed_expired += 1

    def submit(self, items, *,
               tenant: str = "default",
               deadline_s: Optional[float] = None,
               priority: int = 0) -> List[int]:
        """Enqueue an arrival; returns the admitted request ids.

        ``items`` is whatever the adapter's ``validate`` accepts (a batch
        of images, prompt-token rows, activation blocks, ...); ``tenant``
        tags the per-tenant metrics slice; ``deadline_s`` is the arrival's
        SLO in seconds from now (absolute deadline = now + deadline_s;
        None = no SLO); ``priority`` only affects which requests the
        deadline-queue shed policy evicts (higher = kept).

        Admission is atomic: everything is validated *before* any request
        enters the queue or any counter moves, so a bad arrival (ragged
        list, mis-shaped payloads, full queue under ``overflow="reject"``)
        leaves the server exactly as it was.  Thread-safe.  Under
        ``queue_order="deadline"`` + ``overflow="shed"`` an admitted rid
        may still be evicted by a *later* arrival's back-pressure (counted
        in ``metrics.shed``; its completion then never arrives).
        """
        if len(items) == 0:
            return []
        # -- validate everything first, mutate nothing ----------------------
        payloads = self.adapter.validate(items)
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0 or None; got "
                             f"{deadline_s}")
        n = len(payloads)
        now = self.clock()
        deadline = None if deadline_s is None else now + deadline_s
        cfg = self.cfg
        # -- admit under the lock (back-pressure + enqueue + accounting) ----
        with self._cv:
            room = (n if cfg.max_queue is None
                    else max(0, cfg.max_queue - len(self._queue)))
            if n > room and cfg.overflow == "reject":
                self.metrics.rejected += n
                self.metrics.tenant(tenant).rejected += n
                raise QueueFullError(
                    f"queue full: arrival of {n} > room {room} "
                    f"(max_queue={cfg.max_queue}); nothing admitted")
            # FIFO tail-drops the arrival's excess; the deadline queue
            # admits everything then evicts the most-doomed entries
            # (_evict_excess), which may or may not be from this arrival.
            admit = n if cfg.queue_order == "deadline" else min(n, room)
            if self.metrics.t_first_submit is None:
                self.metrics.t_first_submit = now
            rids = []
            for payload in payloads[:admit]:
                self._push(Request(self._next_rid, payload, now,
                                   tenant=tenant, deadline=deadline,
                                   priority=priority))
                rids.append(self._next_rid)
                self._next_rid += 1
            self.metrics.submitted += n
            self.metrics.tenant(tenant).submitted += n
            if cfg.queue_order == "deadline":
                if cfg.max_queue is not None and cfg.overflow == "shed":
                    self._evict_excess(now)
            else:
                self.metrics.shed += n - admit
                self.metrics.tenant(tenant).shed += n - admit
            self._cv.notify_all()
        return rids

    def pending(self) -> int:
        """Requests admitted but not yet completed: queued + the wave in
        flight — so ``submitted == completed + shed + failed + evacuated +
        pending()`` holds at every instant, not just at quiescence (the
        last three terms are zero on a fault-free, non-fleet server)."""
        with self._cv:
            return len(self._queue) + self._inflight

    # -- fleet hand-off (DESIGN.md §Faults) ----------------------------------

    def evacuate(self) -> List[Request]:
        """Pull every queued request off this replica for re-dispatch —
        the fleet health check's rescue path for a dead replica.  The
        requests keep their identity (rid, deadline, priority, retry
        count); this replica's books close through ``metrics.evacuated``:
        submitted == completed + shed + failed + evacuated + pending."""
        with self._cv:
            reqs = []
            while self._queue:
                reqs.append(self._pop_next())
            for r in reqs:
                self.metrics.evacuated += 1
                self.metrics.tenant(r.tenant).evacuated += 1
            return reqs

    def abandon(self) -> int:
        """Fail everything still queued, with accounting — the last-resort
        close-out when a dead replica's backlog has no survivor to adopt
        it (``runtime.caps_fleet``): the requests are counted in
        ``metrics.failed`` (per tenant too), never silently lost."""
        with self._cv:
            n = 0
            while self._queue:
                r = self._pop_next()
                self.metrics.failed += 1
                self.metrics.tenant(r.tenant).failed += 1
                n += 1
            return n

    def adopt(self, reqs: Sequence[Request]) -> int:
        """Admit evacuated ``Request`` objects directly (the receiving end
        of a fleet re-dispatch): original deadlines/priorities/order keys
        are preserved, and the requests enter this replica's ``submitted``
        books (also counted in ``metrics.adopted``) so its invariant keeps
        holding."""
        if not reqs:
            return 0
        with self._cv:
            if self.dead:
                raise ReplicaCrash("cannot adopt onto a dead replica")
            for r in reqs:
                self._push(r)
                self.metrics.submitted += 1
                self.metrics.adopted += 1
                self.metrics.tenant(r.tenant).submitted += 1
            if self.metrics.t_first_submit is None:
                self.metrics.t_first_submit = self.clock()
            self._cv.notify_all()
        return len(reqs)

    # -- one wave ------------------------------------------------------------

    def _requeue_front(self, reqs: List[Request]) -> None:
        """Put a failed wave's requests back at their original queue
        positions: FIFO restores the front slice in order; the deadline
        heap re-inserts by the unchanged ``order_key``.  Caller holds the
        lock."""
        if self.cfg.queue_order == "fifo":
            self._queue.extendleft(reversed(reqs))
        else:
            for r in reqs:
                self._push(r)

    def _abort_wave(self, reqs: List[Request], crash: bool,
                    error: BaseException) -> float:
        """Restore accounting after a failed wave attempt: ``_inflight``
        drops, survivors requeue at their original order keys, requests
        beyond ``max_wave_retries`` fail with accounting, and a crash
        marks the server dead.  Returns the backoff to sleep (0 on
        crash)."""
        with self._cv:
            m = self.metrics
            self._inflight -= len(reqs)
            m.wave_errors += 1
            m.last_error = f"{type(error).__name__}: {error}"
            self._consecutive_failures += 1
            requeue = []
            for r in reqs:
                if crash:
                    requeue.append(r)       # not the request's fault
                    continue
                r.retries += 1
                if r.retries > self.cfg.max_wave_retries:
                    m.failed += 1
                    m.tenant(r.tenant).failed += 1
                else:
                    requeue.append(r)
            self._requeue_front(requeue)
            m.requeued += len(requeue)
            if crash:
                self.dead = True
            elif requeue:
                m.retried += 1
            backoff = (0.0 if crash else
                       self.cfg.retry_backoff_s
                       * (2 ** (self._consecutive_failures - 1)))
            self._cv.notify_all()
        return backoff

    def _reference_wave_fn(self) -> Optional[Callable]:
        """Lazy reference executable for the output guard — built on the
        first guard trip only; a healthy server never compiles it.  None
        when the adapter declares no reference (the guard then fails the
        wave into the bounded-retry path)."""
        if not self._ref_built:
            self._ref_wave_fn = self.adapter.make_reference_wave_fn(self.cfg)
            self._ref_built = True
        return self._ref_wave_fn

    def step(self) -> List[Completion]:
        """Run one wave over whatever is queued (up to ``wave_lanes``).

        Returns [] when the queue is empty — otherwise packs the admitted
        requests into the constant wave shape (padding never perturbs real
        outputs — the adapter contract) and completes them.  The wave
        compute runs outside the lock; only queue pops and metric updates
        hold it.

        Fault boundary (DESIGN.md §Faults): a raising wave restores the
        accounting — the watchdog stops, ``_inflight`` drops, and the
        requests are requeued at their original order keys (or failed with
        accounting once past ``max_wave_retries``) — then ``step`` returns
        [] after the configured backoff; the invariant holds through every
        failure.  A non-finite wave output is quarantined and re-run
        through the adapter's reference executable
        (``metrics.guard_trips``).  A ``ReplicaCrash`` additionally marks
        the server ``dead`` and re-raises for the caller (fleet health
        check / serve_forever)."""
        cfg = self.cfg
        with self._cv:
            if self.dead or not self._queue:
                return []
            take = min(len(self._queue), cfg.wave_lanes)
            reqs = [self._pop_next() for _ in range(take)]
            self._inflight += take
            wave_index = self.metrics.waves

        wave = self.adapter.pack([r.payload for r in reqs], cfg)
        try:
            if self.watchdog is not None:
                self.watchdog.start(wave_index)
            out = self._wave_fn(wave)
            if cfg.output_guard and not self.adapter.finite(out):
                # quarantine: the wave executable produced NaN/Inf — rerun
                # the SAME packed wave through the reference executable
                with self._cv:
                    self.metrics.guard_trips += 1
                ref = self._reference_wave_fn()
                if ref is None:
                    raise FloatingPointError(
                        "non-finite wave output and the adapter has no "
                        "reference executable; failing the wave (its "
                        "requests requeue within max_wave_retries)")
                out = ref(wave)
                if not self.adapter.finite(out):
                    raise FloatingPointError(
                        "non-finite wave output survived the reference "
                        "re-run (bad input, not a kernel fault)")
        except ReplicaCrash as e:
            self._abort_wave(reqs, crash=True, error=e)
            raise
        except Exception as e:        # noqa: BLE001 — any wave fault
            backoff = self._abort_wave(reqs, crash=False, error=e)
            if backoff > 0:
                self._sleep(backoff)
            return []
        finally:
            if self.watchdog is not None:
                self.watchdog.stop()  # no-op when start() never ran

        results = self.adapter.unpack(out, take)
        t_done = self.clock()
        out_completions = []
        with self._cv:
            for r, result in zip(reqs, results):
                lat = t_done - r.t_submit
                met = r.deadline is None or t_done <= r.deadline
                out_completions.append(Completion(r.rid, result, lat,
                                                  tenant=r.tenant,
                                                  deadline_met=met))
                self.metrics.latencies_s.append(lat)
                t = self.metrics.tenant(r.tenant)
                t.completed += 1
                if met:
                    self.metrics.deadline_met += 1
                    t.deadline_met += 1
            self._inflight -= take
            self._consecutive_failures = 0
            self.metrics.completed += take
            self.metrics.padded_lanes += cfg.wave_lanes - take
            self.metrics.waves += 1
            self.metrics.t_last_done = t_done
        return out_completions

    def drain(self) -> List[Completion]:
        """Step until the queue is empty; returns all completions.

        Fault-aware: a failed wave returns [] with its requests requeued,
        so emptiness of the *queue* — not of one step's output — is the
        termination test.  Bounded retries guarantee progress (every
        failed attempt moves each request toward ``max_wave_retries``), so
        this terminates even under a persistent fault; a dead server
        stops immediately (its backlog awaits ``evacuate()``)."""
        out: List[Completion] = []
        while True:
            out.extend(self.step())
            with self._cv:
                if self.dead or not self._queue:
                    return out

    # -- async driver --------------------------------------------------------

    def serve_forever(self, stop_event: threading.Event,
                      poll_s: float = 0.05,
                      on_completion: Optional[Callable[[Completion], None]]
                      = None) -> List[Completion]:
        """Drive waves until ``stop_event`` is set, then drain and return.

        Run this on a dedicated thread; clients call ``submit()``
        concurrently.  Wave formation is decoupled from caller cadence — a
        wave forms whenever the queue is non-empty, batching whatever has
        arrived (up to ``wave_lanes``), and the driver sleeps on the
        admission condition otherwise (``poll_s`` bounds how long a stop
        request can go unnoticed).  On stop, everything still queued is
        drained, so a clean shutdown ends with ``pending() == 0`` and the
        invariant ``submitted == completed + shed + failed`` (no lost or
        double-counted requests).

        Crash-proof (DESIGN.md §Faults): ``step()`` already absorbs
        transient wave faults (requeue/fail with accounting), and this
        driver additionally survives (a) a raising ``on_completion``
        callback — the completion lands in the returned list and the
        metrics *before* the callback runs, the error is counted in
        ``metrics.callback_errors`` — and (b) a ``ReplicaCrash``, on
        which it returns cleanly with the completions so far (the dead
        server's backlog awaits ``evacuate()``).
        """
        done: List[Completion] = []

        def emit(batch: List[Completion]):
            # `done` and the server metrics are final before any client
            # callback runs — a raising callback can't lose accounted
            # requests, it is merely counted.
            done.extend(batch)
            if on_completion is not None:
                for c in batch:
                    try:
                        on_completion(c)
                    except Exception as e:   # noqa: BLE001 — client code
                        with self._cv:
                            self.metrics.callback_errors += 1
                            self.metrics.last_error = (
                                f"on_completion {type(e).__name__}: {e}")

        try:
            while not stop_event.is_set():
                with self._cv:
                    if self.dead:
                        return done
                    if not self._queue:
                        self._cv.wait(timeout=poll_s)
                        continue
                emit(self.step())
            emit(self.drain())
        except ReplicaCrash:
            pass    # accounting already restored by step(); exit cleanly
        return done
