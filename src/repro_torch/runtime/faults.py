"""CapsChaos — deterministic fault injection for the serving stack.

A copy of the JAX package's ``repro/runtime/faults.py`` (numpy only; the
port imports nothing of ``repro``).  One change: a ``"corrupt"`` fault
poisons a clone of the wave's output on the output's own device, so a wave
that returns a tensor on the card hands the output guard a tensor on the
card, as in production, and a clean plan hands back the wave's own output.

Chaos is a *wrapper*, never a dependency: production code
(runtime.caps_serve / runtime.caps_fleet) never imports this module.  The
injection point is the ``wave_fn`` seam those modules already expose —
``CapsServer(wave_fn=...)`` for one server, ``CapsFleet(wave_wrap=...)``
for a fleet — so the chaos arm exercises exactly the executable the
production arm runs, with faults spliced in at wave granularity.

Determinism: a ``FaultPlan`` is a pure schedule — a tuple of
``FaultEvent``s keyed by the wave-fn *call index* (0-based count of
invocations of the wrapped executable, which on a fault-free server equals
the wave number; retries advance it too, which is what makes a
``span=1`` fault transient: the retry lands on the next, clean index).
Decision logic never consults ``random`` or ``time`` — randomness exists
only inside ``FaultPlan.generate`` (a seeded ``np.random.default_rng``
sampled once, at schedule-build time), and the straggler delay sleeps
through an injectable ``sleep`` so tests can fake it.

Fault taxonomy (``FAULT_KINDS``):

* ``"error"``    — the wave raises ``InjectedFault`` (transient when
                   ``span=1``; persistent when ``span`` covers more
                   consecutive calls than ``max_wave_retries`` allows).
* ``"corrupt"``  — the wave *returns*, but its scores are poisoned with
                   NaN — exercises the output guard's quarantine re-run on
                   the adapter's reference executable.
* ``"straggle"`` — the wave completes after an extra ``delay_s`` sleep —
                   exercises the watchdog/p90 straggler signal.
* ``"crash"``    — the wave raises ``wave_serve.ReplicaCrash`` — the
                   replica is dead; exercises fleet evacuation/re-dispatch.

    plan = FaultPlan.generate(seed=0, n_waves=40, p_error=0.1,
                              p_corrupt=0.05, crash_wave=12)
    server = CapsServer(net, wave_fn=chaos_wave_fn(clean, plan))
    # or, per replica:
    fleet = CapsFleet(net, wave_wrap=fleet_wrap({"default/r0": plan}))
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.runtime.wave_serve import ReplicaCrash

FAULT_KINDS = ("error", "corrupt", "straggle", "crash")


class InjectedFault(RuntimeError):
    """A scheduled wave exception — the chaos stand-in for a transient
    device error / failed collective.  Retryable (unlike ``ReplicaCrash``):
    the server requeues the wave's requests and tries again."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fires on wave-fn call indices
    ``[wave, wave + span)``.  ``span > 1`` makes an ``"error"`` persistent
    (consecutive retries keep hitting it until requests exhaust
    ``max_wave_retries``); span is meaningless for ``"crash"`` (the server
    is dead after the first hit)."""
    wave: int
    kind: str
    span: int = 1
    delay_s: float = 0.0      # "straggle" only

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if self.wave < 0 or self.span < 1:
            raise ValueError(f"need wave >= 0 and span >= 1; got "
                             f"wave={self.wave} span={self.span}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0; got {self.delay_s}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A pure, replayable fault schedule: events keyed by wave-fn call
    index.  The earliest event listed for an index wins when events
    overlap.  Hashable and frozen — two servers handed the same plan see
    the same faults at the same call indices, every run."""
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        for e in self.events:
            if not isinstance(e, FaultEvent):
                raise TypeError(f"events must be FaultEvent, got {type(e)}")

    def lookup(self) -> Dict[int, FaultEvent]:
        """call index -> event table (first event listed wins)."""
        table: Dict[int, FaultEvent] = {}
        for e in self.events:
            for w in range(e.wave, e.wave + e.span):
                table.setdefault(w, e)
        return table

    @classmethod
    def generate(cls, seed: int, n_waves: int, *,
                 p_error: float = 0.0,
                 p_corrupt: float = 0.0,
                 p_straggle: float = 0.0,
                 straggle_s: float = 0.02,
                 persistent: Tuple[Tuple[int, int], ...] = (),
                 crash_wave: Optional[int] = None) -> "FaultPlan":
        """Sample a schedule ONCE from a seeded rng — the only place chaos
        touches randomness.  ``p_*`` are per-wave Bernoulli rates over
        ``n_waves`` call indices; ``persistent`` pins (wave, span) error
        runs; ``crash_wave`` pins the replica death.  The returned plan is
        pure data: same seed, same schedule, forever."""
        rng = np.random.default_rng(seed)
        events = []
        for w in range(n_waves):
            if p_error > 0 and rng.random() < p_error:
                events.append(FaultEvent(w, "error"))
            if p_corrupt > 0 and rng.random() < p_corrupt:
                events.append(FaultEvent(w, "corrupt"))
            if p_straggle > 0 and rng.random() < p_straggle:
                events.append(FaultEvent(w, "straggle", delay_s=straggle_s))
        for wave, span in persistent:
            events.append(FaultEvent(wave, "error", span=span))
        if crash_wave is not None:
            events.append(FaultEvent(crash_wave, "crash"))
        # collision precedence at one index (lookup: first listed wins):
        # crash > error > corrupt > straggle — a pinned crash must never
        # be shadowed by a sampled lesser fault
        severity = ("crash", "error", "corrupt", "straggle")
        events.sort(key=lambda e: (e.wave, severity.index(e.kind)))
        return cls(tuple(events))


class ChaosWaveFn:
    """The wrapped wave executable: counts calls, fires the plan.

    ``calls`` and ``fired`` (call index -> kind actually injected) are the
    test oracle — a fault-free plan leaves ``fired`` empty and delegates
    every call untouched, which is what keeps the chaos arm bit-identical
    to production when no fault is scheduled.
    """

    def __init__(self, inner: Callable, plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.plan = plan
        self.sleep = sleep
        self.calls = 0
        self.fired: Dict[int, str] = {}
        self._table = plan.lookup()

    def __call__(self, micro):
        idx = self.calls
        self.calls += 1
        ev = self._table.get(idx)
        if ev is None:
            return self.inner(micro)
        self.fired[idx] = ev.kind
        if ev.kind == "error":
            raise InjectedFault(f"injected wave error at call {idx}")
        if ev.kind == "crash":
            raise ReplicaCrash(f"injected replica crash at call {idx}")
        if ev.kind == "straggle":
            self.sleep(ev.delay_s)
            return self.inner(micro)
        # "corrupt": run the real wave, poison one score of a copy with
        # NaN — the output guard must catch this and quarantine to the
        # reference.  A tensor stays a tensor on its own device.
        out = self.inner(micro)
        if hasattr(out, "detach"):
            out = out.detach().contiguous().clone()
            out.view(-1)[0] = float("nan")
            return out
        out = np.array(out, np.float32, copy=True)
        out.flat[0] = np.nan
        return out


def chaos_wave_fn(inner: Callable, plan: FaultPlan,
                  sleep: Callable[[float], None] = time.sleep) -> ChaosWaveFn:
    """Wrap a wave executable with a fault schedule (see ``ChaosWaveFn``)."""
    return ChaosWaveFn(inner, plan, sleep=sleep)


def fleet_wrap(plans: Mapping[str, FaultPlan],
               sleep: Callable[[float], None] = time.sleep,
               registry: Optional[Dict[str, ChaosWaveFn]] = None) -> Callable:
    """Build a ``CapsFleet(wave_wrap=...)`` hook from per-replica plans.

    ``plans`` maps replica names ("<model>/r<i>", as the fleet mints them)
    to schedules; replicas without a plan get the clean executable,
    untouched.  Pass a dict as ``registry`` to receive each replica's
    ``ChaosWaveFn`` (call/fire counters) for assertions."""
    def wrap(name: str, fn: Callable) -> Callable:
        plan = plans.get(name)
        if plan is None:
            return fn
        wrapped = ChaosWaveFn(fn, plan, sleep=sleep)
        if registry is not None:
            registry[name] = wrapped
        return wrapped
    return wrap
