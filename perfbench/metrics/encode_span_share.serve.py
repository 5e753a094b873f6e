"""encode_span_share.serve: the encoder's share of the card's busy time, by
the program's own span.

The device operations launched inside ``capsnet.encode`` (the serving
wave's stage A in ``runtime/caps_serve.make_wave_fn``: the two
convolutions with their bias and ReLU, the PrimaryCaps squash, the Eq.1
votes and the lane mask), their summed time over the union of every device
operation's intervals in the traced window.  Layer: the encoder
(``models/capsnet.encode_votes``, ``core/capsule_layers``).  Moves
``images_per_s``."""
from perfbench.common import spans
from perfbench.common import trace as tr

UNIT = "%"
LAYER = "encoder"
KERNELS = ""
OPS = r"^capsnet\.encode$"


def read(run):
    if run.trace is None:
        return None
    ops = spans.launched(run.trace, "capsnet.encode")
    busy = tr.busy_s(run.trace)
    if not ops or busy <= 0:
        return None
    return 100.0 * sum(d.end - d.start for d in ops) / busy
