"""route_span_roofline.serve: the routing stage's share of its roofline, by
the program's own span.

The routing stage's bound for one microbatch (``common.flops.
routing_bound_s``: û read once and v written once at the card's memory
bandwidth, or its operations at the fp32 peak, whichever is longer) times
the ``capsnet.route`` spans opened in the traced window (one a call of
the routing algorithm, ``core/router.py``; ``common.spans.instances``),
over the device time of every operation launched inside them: the stream
cast, the copy of û and the kernels.  Layer: router and kernels (``core/router.py``,
``kernels/routing/``, ``csrc/routing*.cu``).  Moves ``images_per_s``."""
from perfbench.common import flops, spans

UNIT = "%"
LAYER = "routing"
KERNELS = ""
OPS = r"^capsnet\.route$"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    calls = spans.instances(run.trace, "capsnet.route")
    spent = sum(d.end - d.start
                for d in spans.launched(run.trace, "capsnet.route"))
    if calls <= 0 or spent <= 0:
        return None
    bound = flops.routing_bound_s(run.config, run.counters["microbatch"],
                                  run.peaks["fp32_flops"],
                                  run.peaks["hbm_bytes_s"])
    return 100.0 * bound * calls / spent
