"""mfu.serve: the whole serving wave's share of the card's fp32 peak.

The closed-form operations of a served image (``common.flops``: encoder,
votes, routing) times the images served in the part of the window before
the trace starts, over that time by the host's clock, over the fp32 peak:
the profiler's own cost stays out of it.  Layer: the whole wave
(``runtime/caps_serve.make_wave_fn``).  Moves ``images_per_s``."""
from perfbench.common import flops

UNIT = "%"


def read(run):
    if run.peaks is None:
        return None
    images = run.counters.get("pre_trace_images", 0)
    seconds = run.counters.get("pre_trace_s", 0.0)
    if images <= 0 or seconds <= 0:
        return None
    done = flops.serve_flops_per_image(run.config) * images
    return 100.0 * done / seconds / run.peaks["fp32_flops"]
