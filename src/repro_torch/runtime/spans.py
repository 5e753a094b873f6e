"""Named spans at the CapsNet path's layer boundaries, on the profiler's clock.

``span(name)`` marks a stretch of host code as one layer's work.  While a
``torch.profiler`` records, it opens ``torch.profiler.record_function(name)``,
whose events the profiler times on the clock it puts the device's records
on, so a trace attributes every device operation launched inside the span to
it.  With no profiler it returns one shared no-op context after a single
check: no ``record_function``, no allocation.  The profiler being on is the
only switch.

The spans, each opened by the code that owns its layer:

    capsnet.encode    conv stack, PrimaryCaps, the Eq.1 votes (and the
                      serving wave's lane mask)
    capsnet.route     one call of a capsule routing algorithm
    train.backward    the CapsNet step's ``torch.autograd.grad``
    train.optimizer   the CapsNet step's clipping, schedule and AdamW

Spans are flat: none is opened inside another, so the outermost host op
above a device operation names its layer, and a trace's instances of a span
count the work done (routing calls, optimizer steps).
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking ``name``'s work while a profiler records;
    the shared no-op context otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
