"""The program's own spans in a traced run.

The port marks its CapsNet layers with flat spans
(``repro_torch.runtime.spans``: ``capsnet.encode``, ``capsnet.route``,
``train.backward``, ``train.optimizer``), each a ``record_function`` range
while the profiler records.  ``trace.from_profiler`` labels a device
operation by the outermost host op under the benchmark's annotations, which
is the program's span wherever one is open; the host segments name only the
innermost event, so a span's host time and its instances are rebuilt here
from their order.  A program without spans gives nothing here, and the
readers built on it return None.
"""
from __future__ import annotations

import re
from typing import Iterator, List, Optional, Tuple

from perfbench.common import trace as tr

# the program's span names, as opposed to aten ops, CUDA runtime calls and
# the benchmark's own annotations
PROGRAM = re.compile(r"^(capsnet|train)\.")


def launched(trace: tr.Trace, name: str) -> List[tr.DeviceOp]:
    """The window's device operations launched inside span ``name``."""
    return [d for d in trace.ops() if d.op == name]


def _owned(trace: tr.Trace) -> Iterator[Tuple[float, float, Optional[str]]]:
    """Each host segment with the span it lies in, or None.

    A segment whose innermost event is a span is that span's own time.  A
    segment whose innermost event is an op or a runtime call belongs to the
    span of the last own-time segment before it, and to none after a bare
    segment of the benchmark's annotations (the host back in the
    benchmark's code between spans)."""
    owner = None
    for s, e, label in trace.host:
        event = label.split("/", 1)[1]
        if event.startswith(tr.ANNOTATION):
            owner = None
        elif PROGRAM.match(event):
            owner = event
        yield s, e, owner


def host_intervals(trace: tr.Trace, name: str) -> List[Tuple[float, float]]:
    """The host time inside instances of span ``name``."""
    return [(s, e) for s, e, owner in _owned(trace) if owner == name]


def instances(trace: tr.Trace, name: str) -> int:
    """How many times span ``name`` was opened in the window: the program's
    count of its work (routing calls, optimizer steps).  Two instances with
    nothing but ops between them (no benchmark code, no other span) count
    as one."""
    count, last = 0, None
    for _, _, owner in _owned(trace):
        if owner == name and last != name:
            count += 1
        last = owner
    return count


def overlap_s(a, b) -> float:
    """Length of the intersection of the unions of two interval lists."""
    a, b = list(a), list(b)
    return tr.union_s(a) + tr.union_s(b) - tr.union_s(a + b)
