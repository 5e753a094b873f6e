"""The traffic and inputs are fixed by the seed."""
import torch

from perfbench.common import capsnet as caps
from perfbench.common import harness
from perfbench.tests import smoke


def test_weights_images_and_samples_are_fixed_by_the_seed():
    cfg = smoke.SMOKE_CONFIG
    cpu = torch.device("cpu")
    w1 = caps.make_weights(cfg, 3 ** 25, cpu)
    w2 = caps.make_weights(cfg, 3 ** 25, cpu)
    w3 = caps.make_weights(cfg, 3 ** 25 + 1, cpu)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["digit.W"], w3["digit.W"])
    i1 = caps.make_images(cfg, 4, 9, "images", cpu)
    assert torch.equal(i1, caps.make_images(cfg, 4, 9, "images", cpu))
    assert not torch.equal(i1, caps.make_images(cfg, 4, 9, "other", cpu))
    assert float(i1.min()) >= 0.0 and float(i1.max()) < 1.0

    def sample(seed):
        r = caps.Reservoir(3, seed)
        for i in range(50):
            s = r.slot()
            if s >= 0:
                r.put(s, i)
        return r.items
    assert sample(4) == sample(4)
    assert len(sample(4)) == 3 and sample(4) != sample(5)


def test_sub_seeds_are_distinct_and_large_seeds_work():
    s = {harness.sub_seed(2 ** 31 + 5, t) for t in ("a", "b", "c")}
    assert len(s) == 3 and all(0 <= x < 2 ** 63 for x in s)
