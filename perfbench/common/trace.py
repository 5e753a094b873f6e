"""The device trace of a traced run, and the arithmetic on it.

``Tracer`` runs ``torch.profiler`` over a sub-window of the measured window
that the cell's traffic module chooses, inside a ``bench.window`` annotation, and
turns what it saw into a ``Trace``: every device operation (kernel, copy,
fill) with its interval and the outermost host operation that launched it,
and the host's own events for telling what it did while the card was idle.

The arithmetic follows ``chip_smoke.device_ms`` of the repository: the
card's busy time is the union of the intervals of its operations, so that
operations that overlap (a programmatic dependent launch beside its
primary) count once.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ANNOTATION = "bench."
WINDOW = ANNOTATION + "window"
# host-side CUDA API events (cudaLaunchKernel, cuLaunchKernelEx, ...): their
# correlation id is the one of the device operation they started
_RUNTIME = re.compile(r"^cu[A-Z]|^cuda[A-Z]")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float        # seconds, in the trace's time base
    end: float
    op: str             # outermost host op that launched it ("" if none)


@dataclasses.dataclass
class Trace:
    t0: float
    t1: float
    device: List[DeviceOp]
    # disjoint host segments (start, end, label) on the window's thread,
    # each labelled by the innermost host event covering it
    host: List[Tuple[float, float, str]] = dataclasses.field(
        default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def ops(self) -> List[DeviceOp]:
        """The device operations inside the window, clipped to it."""
        out = []
        for d in self.device:
            s, e = max(d.start, self.t0), min(d.end, self.t1)
            if e > s:
                out.append(DeviceOp(d.name, s, e, d.op))
        return out


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some device operation ran."""
    return union_s((d.start, d.end) for d in trace.ops())


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The intervals of the window in which no device operation ran."""
    gaps, cursor = [], trace.t0
    for s, e in sorted((d.start, d.end) for d in trace.ops()):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if trace.t1 > cursor:
        gaps.append((cursor, trace.t1))
    return gaps


class Claims:
    """Which layer a device operation belongs to: each per-layer reader
    may name its layer with regular expressions on kernel names
    (``KERNELS``) and on the host op that launched them (``OPS``).  The
    first layer whose patterns match claims the operation; the rest are
    "other"."""

    def __init__(self):
        self.rules = []                 # (layer, kernel regex, op regex)

    def add(self, layer: str, kernels: str = "", ops: str = "") -> None:
        self.rules.append((layer, re.compile(kernels) if kernels else None,
                           re.compile(ops) if ops else None))

    def layer_of(self, d: DeviceOp) -> str:
        for layer, kernels, ops in self.rules:
            if matches(d, kernels, ops):
                return layer
        return "other"


def matches(d: DeviceOp, kernels=None, ops=None) -> bool:
    """Whether a kernel-name or a launching-op pattern (strings or
    compiled) matches the device operation."""
    return bool((kernels and re.search(kernels, d.name))
                or (ops and d.op and re.search(ops, d.op)))


def breakdown(trace: Trace, claims: Claims, top: int = 10) -> dict:
    """The device operations that took most time, as "layer:name", and
    the idle gaps summed by what the host was doing, each as [name,
    seconds], at most ``top`` of each."""
    per: Dict[str, float] = {}
    for d in trace.ops():
        key = f"{claims.layer_of(d)}:{d.name[:160]}"
        per[key] = per.get(key, 0.0) + (d.end - d.start)
    gaps: Dict[str, float] = {}
    starts = [h[0] for h in trace.host]
    for s, e in idle_gaps(trace):
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        label = "host:none"
        if i >= 0 and trace.host[i][1] >= mid:
            label = trace.host[i][2]
        gaps[label] = gaps.get(label, 0.0) + (e - s)

    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": best(per), "idle_gaps": best(gaps)}


def host_segments(events: Sequence[Tuple[float, float, str]]
                  ) -> List[Tuple[float, float, str]]:
    """Disjoint segments of nested host events (start, end, name), each
    labelled "<innermost annotation>/<innermost event>"."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []     # (end, name)

    def label():
        span = next((n for _, n in reversed(stack)
                     if n.startswith(ANNOTATION)), "")
        return f"{span}/{stack[-1][1]}"

    cursor = None
    for s, e, name in sorted(events, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end = stack[-1][0]
            if end > cursor:
                out.append((cursor, end, label()))
            cursor = max(cursor, end)
            stack.pop()
        if stack and s > cursor:
            out.append((cursor, s, label()))
        cursor = s if cursor is None else max(cursor, s)
        stack.append((min(e, stack[-1][0]) if stack else e, name))
    while stack:
        end = stack[-1][0]
        if end > cursor:
            out.append((cursor, end, label()))
        cursor = max(cursor, end)
        stack.pop()
    return out


def from_profiler(prof) -> Optional[Trace]:
    """The ``Trace`` of a finished ``torch.profiler.profile``: the window is
    its ``bench.window`` annotation, on the host."""
    from torch.autograd import DeviceType
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    windows = [e for e in cpu if e.name == WINDOW]
    if not windows:
        return None
    win = windows[0]
    runtime = {e.id: e for e in cpu if _RUNTIME.match(e.name)}

    def outer_op(e) -> str:
        p, name = e.cpu_parent, ""
        while p is not None and not p.name.startswith(ANNOTATION):
            name = p.name
            p = p.cpu_parent
        return name

    device = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith(ANNOTATION):
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        rt = runtime.get(e.id)
        device.append(DeviceOp(e.name, e.time_range.start / 1e6,
                               e.time_range.end / 1e6,
                               outer_op(rt) if rt is not None else ""))
    host = host_segments([(e.time_range.start / 1e6, e.time_range.end / 1e6,
                           e.name) for e in cpu if e.thread == win.thread])
    return Trace(win.time_range.start / 1e6, win.time_range.end / 1e6,
                 device, host)


class Tracer:
    """``torch.profiler`` over one sub-window of a run.  ``start()`` and
    ``stop()`` synchronise the card first, so the window holds whole units
    of work; ``span(name)`` marks the traffic module's own phases for the idle
    gaps' attribution.  Disabled, every call does nothing."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.active = False
        self.trace: Optional[Trace] = None
        # seconds taken by the start, the stop, and the stop with the
        # reading of the trace
        self.costs_s: List[float] = []
        self._prof = None
        self._window = None

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def start(self) -> None:
        if not self.enabled or self.active or self.trace is not None:
            return
        import time

        import torch
        self._sync()
        t = time.perf_counter()
        self._prof = self._profile()
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        self.active = True
        self.costs_s.append(time.perf_counter() - t)

    def stop(self) -> None:
        if not self.active:
            return
        import time
        self._sync()
        t = time.perf_counter()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        self.costs_s.append(time.perf_counter() - t)
        self.trace = from_profiler(self._prof)
        self._prof = None
        self.costs_s.append(time.perf_counter() - t)

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(ANNOTATION + name)
