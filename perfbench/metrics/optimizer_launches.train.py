"""optimizer_launches.train: device operations a step of the optimizer.

The device operations launched inside ``train.optimizer`` (the CapsNet
step's global-norm clipping, schedule and AdamW,
``runtime/train_loop.make_capsnet_train_step``) in the traced window, over
the instances of that span there (``common.spans.instances``), one a
step.  Layer: the optimizer.  Moves ``train_images_per_s``: the step is host-bound, and each
launch costs the host its share."""
from perfbench.common import spans

UNIT = "launches"
LAYER = "optimizer"
KERNELS = ""
OPS = r"^train\.optimizer$"


def read(run):
    if run.trace is None:
        return None
    steps = spans.instances(run.trace, "train.optimizer")
    ops = spans.launched(run.trace, "train.optimizer")
    if steps <= 0 or not ops:
        return None
    return len(ops) / steps
