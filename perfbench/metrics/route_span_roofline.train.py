"""route_span_roofline.train: the routing's share of its roofline in a
training step, forward and backward, by the program's own span.

The forward bound (û read once, v written once) plus the backward bound
(û and dL/dv read once, dL/dû written once), each the longer of its bytes
at the memory bandwidth and its operations at the fp32 peak
(``common.flops.routing_bound_s``), times the ``capsnet.route`` spans
opened in the traced window (one a step; ``common.spans.instances``), over
the device time of every operation launched inside them (the stream cast,
the copy of û, the procedure kernel) and of the backward's routing kernels
by name (the recompute-b backward's replay, reverse sweep and dL/dû, which
autograd's thread launches outside any span).  Layer: router and kernels
(``core/router.py``, ``csrc/routing.cu``, ``csrc/routing_bwd.cu``).  Moves
``train_images_per_s``."""
from perfbench.common import flops, spans
from perfbench.common import trace as tr

UNIT = "%"
LAYER = "routing"
KERNELS = (r"\b(routing_tile_kernel|routing_reduce_kernel|reverse_tile_kernel"
           r"|reverse_reduce_kernel|du_kernel)\b")
OPS = r"^capsnet\.route$"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    steps = spans.instances(run.trace, "capsnet.route")
    spent = sum(d.end - d.start for d in run.trace.ops()
                if tr.matches(d, KERNELS, OPS))
    if steps <= 0 or spent <= 0:
        return None
    args = (run.config, run.counters["batch"], run.peaks["fp32_flops"],
            run.peaks["hbm_bytes_s"])
    bound = (flops.routing_bound_s(*args)
             + flops.routing_bound_s(*args, backward=True))
    return 100.0 * bound * steps / spent
