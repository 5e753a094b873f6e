"""optimizer_idle_share.train: the share of the traced window in which the
card idled while the host was inside the optimizer.

The idle intervals of the window (no device operation running) intersected
with the host time inside ``train.optimizer`` spans (clipping, schedule and
AdamW, ``runtime/train_loop.make_capsnet_train_step``), rebuilt from the
host segments (``common.spans.host_intervals``), over the window.  Traced,
the profiler's own host cost inflates it: an upper end, as
``idle_share.train`` is.  Layer: the optimizer.  Moves
``train_images_per_s``."""
from perfbench.common import spans
from perfbench.common import trace as tr

UNIT = "%"


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.ops():
        return None
    inside = spans.host_intervals(run.trace, "train.optimizer")
    if not inside:
        return None
    idle = spans.overlap_s(tr.idle_gaps(run.trace), inside)
    return 100.0 * idle / run.trace.window_s
