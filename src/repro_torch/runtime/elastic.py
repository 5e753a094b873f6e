"""Elastic capacity: scale decisions for serving fleets.

The serving half of the JAX package's ``repro/runtime/elastic.py`` (pure
Python; the port imports nothing of ``repro``): ``ElasticController`` is
the hysteresis state machine behind ``runtime.caps_fleet``'s replica
scale-up/down — pure decision logic (no threads) fed per-tick observations
of queue depth and wave-latency percentiles (``straggler.StepWatchdog``).

The training half — ``resume_or_init`` and ``rebatch_for_mesh``, a
checkpoint resumed on a different mesh — belongs to sharded training
(``slices.SHARDED_TRAINING``) and is not here yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """When to grow/shrink a replica fleet.

    Backlog is measured in *waves per replica* (queued requests /
    (replicas · wave_lanes)) so thresholds are capacity-relative:

    scale_up_backlog:   grow when backlog exceeds this many waves per
                        replica for ``up_patience`` consecutive ticks.
    scale_down_backlog: shrink when backlog stays below this for
                        ``down_patience`` consecutive ticks.
    slow_p90_factor:    a p90 wave latency above ``factor × median`` also
                        counts as an up-signal (straggler pressure — the
                        queue looks fine but waves are stalling; the
                        paper's "intensive synchronization" failure mode
                        surfacing as latency, not depth).
    """
    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_backlog: float = 1.5
    scale_down_backlog: float = 0.25
    up_patience: int = 2
    down_patience: int = 3
    slow_p90_factor: float = 3.0

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas; got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.scale_down_backlog >= self.scale_up_backlog:
            raise ValueError("scale_down_backlog must be < scale_up_backlog "
                             f"(hysteresis); got {self.scale_down_backlog} "
                             f">= {self.scale_up_backlog}")


class ElasticController:
    """Hysteresis state machine: consecutive-tick patience on both edges so
    one bursty arrival never flaps the fleet.

        HOLD --(backlog > up for up_patience ticks, n < max)--> UP
        HOLD --(backlog < down for down_patience ticks, n > min)--> DOWN

    ``observe()`` returns "up" | "down" | "hold"; the caller (the fleet's
    controller thread) starts or drains a replica and keeps ticking.  Every
    decision is recorded in ``events`` with its observation snapshot —
    the bench's elasticity provenance.
    """

    def __init__(self, policy: Optional[ElasticPolicy] = None):
        self.policy = policy if policy is not None else ElasticPolicy()
        self._up_ticks = 0
        self._down_ticks = 0
        self.events: List[dict] = []

    def observe(self, n_replicas: int, queued: int, wave_lanes: int,
                p90_s: Optional[float] = None,
                median_s: Optional[float] = None) -> str:
        """One controller tick: backlog + latency in, decision out."""
        pol = self.policy
        backlog = queued / max(1, n_replicas * wave_lanes)
        slow = (p90_s is not None and median_s is not None and median_s > 0
                and p90_s > pol.slow_p90_factor * median_s)
        if backlog > pol.scale_up_backlog or slow:
            self._up_ticks += 1
            self._down_ticks = 0
        elif backlog < pol.scale_down_backlog:
            self._down_ticks += 1
            self._up_ticks = 0
        else:
            self._up_ticks = self._down_ticks = 0
        decision = "hold"
        if (self._up_ticks >= pol.up_patience
                and n_replicas < pol.max_replicas):
            decision = "up"
        elif (self._down_ticks >= pol.down_patience
                and n_replicas > pol.min_replicas):
            decision = "down"
        if decision != "hold":
            self._up_ticks = self._down_ticks = 0
            self.events.append({"decision": decision,
                                "n_replicas": n_replicas,
                                "queued": queued,
                                "backlog_waves": backlog,
                                "p90_s": p90_s, "median_s": median_s})
        return decision

    def note(self, decision: str, **snapshot) -> None:
        """Record an externally-applied capacity event in ``events`` —
        e.g. the fleet health check restarting a dead replica
        ("restart", DESIGN.md §Faults) — so the scale-event log stays the
        single provenance stream for every capacity change, and resets the
        hysteresis counters (the fleet just changed size out from under
        them)."""
        self._up_ticks = self._down_ticks = 0
        self.events.append({"decision": decision, **snapshot})
