"""idle_share.train: the share of the traced window in which no operation
ran on the card (1 - the union of the device operations' intervals over
the window).  Layer: the device.  Moves ``train_images_per_s``."""
from perfbench.common import trace as tr

UNIT = "%"


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.ops():
        return None
    return 100.0 * (1.0 - tr.busy_s(run.trace) / run.trace.window_s)
