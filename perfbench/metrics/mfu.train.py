"""mfu.train: the whole training step's share of the card's fp32 peak.

The closed-form operations of a trained image, forward and backward as
autograd runs them on the reference (``common.flops``), times the images
of the steps taken in the part of the window before the trace starts,
over that time by the host's clock, over the fp32 peak: the profiler's
own cost, which slows this host-bound step, stays out of it.  Layer: the
train step (``runtime/train_loop.make_capsnet_train_step``,
``optim/``).  Moves ``train_images_per_s``."""
from perfbench.common import flops

UNIT = "%"


def read(run):
    if run.peaks is None:
        return None
    images = run.counters.get("pre_trace_images", 0)
    seconds = run.counters.get("pre_trace_s", 0.0)
    if images <= 0 or seconds <= 0:
        return None
    done = flops.train_flops_per_image(run.config) * images
    return 100.0 * done / seconds / run.peaks["fp32_flops"]
