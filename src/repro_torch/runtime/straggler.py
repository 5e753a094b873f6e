"""Straggler mitigation at the step-loop level.

A copy of the JAX package's ``repro/runtime/straggler.py`` (pure Python;
the port imports nothing of ``repro``).  On a real pod, intra-step
stragglers are absorbed by the synchronous collectives; what the framework
can and must do at this layer is (a) detect persistently slow steps
(preemption signals, failing hosts), (b) keep the job alive by
checkpoint+restart with the elastic path, and (c) keep the input pipeline
ahead of the device (prefetch) so host hiccups don't stall the step.  This
module provides the watchdog + prefetcher (``launch/train_capsnet.py``
drives both).
"""
from __future__ import annotations

import collections
import math
import queue
import threading
import time
from typing import Callable, Iterator, Optional


class StepWatchdog:
    """Tracks step durations; flags steps slower than k× the rolling median.

    ``clock`` is injectable (like ``CapsServer.clock``) so fault/straggler
    tests are deterministic; the default is the real monotonic clock.
    ``stop()`` without a preceding ``start()`` is a no-op returning
    ``None`` — a crashed wave's try/finally may reach ``stop()`` before
    the watchdog ever started.
    """

    def __init__(self, window: int = 50, slow_factor: float = 3.0,
                 on_slow: Optional[Callable[[int, float, float], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.durations: collections.deque = collections.deque(maxlen=window)
        self.slow_factor = slow_factor
        self.on_slow = on_slow
        self.clock = clock
        self.slow_steps: list[int] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start(self, step: int) -> None:
        self._step = step
        self._t0 = self.clock()

    def stop(self) -> Optional[float]:
        if self._t0 is None:                 # stop before any start: no-op
            return None
        dt = self.clock() - self._t0
        self._t0 = None
        med = self.median()
        if med is not None and dt > self.slow_factor * med:
            self.slow_steps.append(self._step)
            if self.on_slow:
                self.on_slow(self._step, dt, med)
        self.durations.append(dt)
        return dt

    def median(self) -> Optional[float]:
        return self.percentile(0.5)

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile of the rolling window (None when
        empty)."""
        if not self.durations:
            return None
        s = sorted(self.durations)
        rank = min(len(s), max(1, math.ceil(p * len(s))))
        return s[rank - 1]


class Prefetcher:
    """Background-thread batch prefetch (keeps the host pipeline ahead)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
