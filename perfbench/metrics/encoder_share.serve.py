"""encoder_share.serve: the CapsNet encoder's share of the card's busy time.

The encoder is ``models/capsnet.encode_votes`` and ``core/capsule_layers``:
the two convolutions with their bias and ReLU, the PrimaryCaps squash, the
Eq.1 votes, and the serving wave's lane mask on them.  Its device
operations are those launched under these host ops; the share is their
summed time over the union of every device operation's intervals in the
traced window.  Moves ``images_per_s``."""
from perfbench.common import trace as tr

UNIT = "%"
LAYER = "encoder"
KERNELS = ""
OPS = (r"^aten::(conv2d|convolution|_convolution|cudnn_convolution|relu_?"
       r"|einsum|bmm|mul|sum|add|div|sqrt|reshape|clone)$")


def read(run):
    if run.trace is None:
        return None
    ops = [d for d in run.trace.ops() if tr.matches(d, KERNELS, OPS)]
    busy = tr.busy_s(run.trace)
    if not ops or busy <= 0:
        return None
    return 100.0 * sum(d.end - d.start for d in ops) / busy
