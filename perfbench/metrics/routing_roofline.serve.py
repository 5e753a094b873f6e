"""routing_roofline.serve: the routing kernels' share of their roofline.

The routing stage's bound for one microbatch (``common.flops.
routing_bound_s``: û read once and v written once at the card's memory
bandwidth, or its operations at the fp32 peak, whichever is longer) times
the router calls inside the traced window, over the device time of the
routing kernels there.  It counts the work of the function, whatever
kernel runs it.  Layer: router and kernels (``core/router.py``,
``kernels/routing/``, ``csrc/routing*.cu``).  Moves ``images_per_s``."""
from perfbench.common import flops
from perfbench.common import trace as tr

UNIT = "%"
LAYER = "routing"
KERNELS = (r"\b(routing_tile_kernel|routing_reduce_kernel|stage_votes_kernel"
           r"|stage_votes_reduce_kernel|stage_squash_kernel"
           r"|stage_update_kernel)\b")
# the copy the routing wrapper makes of a non-contiguous û
OPS = r"^aten::contiguous$"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    calls = run.counters.get("trace_routing_calls", 0)
    spent = sum(d.end - d.start for d in run.trace.ops()
                if tr.matches(d, KERNELS, OPS))
    if calls <= 0 or spent <= 0:
        return None
    bound = flops.routing_bound_s(run.config, run.counters["microbatch"],
                                  run.peaks["fp32_flops"],
                                  run.peaks["hbm_bytes_s"])
    return 100.0 * bound * calls / spent
