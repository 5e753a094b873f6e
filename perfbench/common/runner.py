"""One run of one cell: the traffic module's set-up and window, the per-layer
readers on a traced run, and the result line."""
from __future__ import annotations

import math
import sys
from typing import List

from perfbench.common import harness, peaks, trace as tr


def execute(cell: harness.Cell, seed: int, seconds: float, traced: bool,
            device, t_start: float, clock, control: bool = False,
            base=harness.BASE):
    """Run the cell once.  Returns (context, outcome, readers)."""
    readers = ([(m, harness.load_reader(m, base)) for m in cell.per_layer]
               if traced else [])
    tracer = tr.Tracer(traced, device)
    ctx = harness.RunContext(cell=cell, seed=seed, seconds=seconds,
                             device=device, tracer=tracer, clock=clock,
                             t_start=t_start, control=control)
    outcome = cell.traffic.run(ctx)
    return ctx, outcome, readers


def claims_of(readers) -> tr.Claims:
    """The layers that the patterns of the cell's per-layer readers name,
    for its breakdown."""
    claims = tr.Claims()
    for _, mod in readers:
        layer = getattr(mod, "LAYER", None)
        if layer:
            claims.add(layer, getattr(mod, "KERNELS", ""),
                       getattr(mod, "OPS", ""))
    return claims


def result(ctx, outcome, readers, kind: str, count: int) -> dict:
    """The run's last line, as a dict, in the order the keys print:
    correct, attempted, failed, metrics, device, breakdown (traced runs)
    and checks, each number compared beside its limit."""
    cell = ctx.cell
    metrics = {}
    trace = ctx.tracer.trace
    if not ctx.tracer.enabled:
        for m in cell.end_to_end:
            value = (ctx.setup_s if m["name"] == "setup_s"
                     else outcome.e2e.get(m["name"]))
            if value is None or not math.isfinite(value):
                raise harness.BenchError(
                    f"the {cell.workload['kind']} traffic module gave no "
                    f"{m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        if trace is None:
            raise harness.BenchError("the traced run saw no device trace")
        view = harness.RunView(cell.workload, cell.config, outcome.counters,
                               trace, peaks.peaks_of(kind))
        for m, mod in readers:
            value = mod.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": kind, "count": count,
              "memory_peak_bytes": ctx.memory_peak_bytes}
    out = {"correct": (all(c.ok for c in outcome.checks)
                       and outcome.failed == 0),
           "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": device}
    if trace is not None and ctx.tracer.enabled:
        device["busy_s"] = tr.busy_s(trace)
        device["window_s"] = trace.window_s
        out["breakdown"] = tr.breakdown(trace, claims_of(readers))
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return out


def print_checks(checks: List[harness.Check], stream=sys.stderr,
                 prefix: str = "check") -> None:
    for c in checks:
        print(f"{prefix} {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=stream)
