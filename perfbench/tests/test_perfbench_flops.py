"""The closed-form operation counts equal torch's FlopCounterMode on the
plain reference, at the configurations' own widths and a small batch."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.common import capsnet as caps
from perfbench.common import flops, harness
from perfbench.reference import capsnet as ref

CONFIGS = ["caps-mn1", "caps-en3"]


def config(name):
    return harness.load_json(harness.BASE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_serve_flops_match_the_counter(name):
    cfg = config(name)
    cpu = torch.device("cpu")
    w = caps.make_weights(cfg, 1, cpu)
    images = caps.make_images(cfg, 4, 1, "images", cpu).reshape(
        1, 4, cfg["image_hw"], cfg["image_hw"], cfg["image_channels"])
    with FlopCounterMode(display=False) as fc:
        ref.wave_scores(w, images, torch.ones(1, 4), cfg)
    assert fc.get_total_flops() == 4 * flops.serve_flops_per_image(cfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_flops_match_the_counter(name):
    cfg = config(name)
    cpu = torch.device("cpu")
    w = {k: t.requires_grad_(True)
         for k, t in caps.make_weights(cfg, 1, cpu).items()}
    images = caps.make_images(cfg, 3, 1, "images", cpu)
    labels = caps.make_labels(cfg, 3, 1, "labels", cpu)
    with FlopCounterMode(display=False) as fc:
        value = ref.loss(w, images, labels, cfg, ref.Precision(False, cpu))
        torch.autograd.grad(value, list(w.values()))
    assert fc.get_total_flops() == 3 * flops.train_flops_per_image(cfg)


def test_the_issue_s_numbers():
    mn1, en3 = config("caps-mn1"), config("caps-en3")
    p = flops.forward_parts(mn1)
    assert round(p["conv1"] / 1e6, 1) == 16.6
    assert round(p["primary_caps"] / 1e6, 1) == 382.2
    assert round(p["votes"] / 1e6, 2) == 2.95
    assert round(flops.serve_flops_per_image(mn1) / 1e6) == 404
    assert round(flops.serve_flops_per_image(en3) / 1e6) == 431
    assert flops.votes_bytes(mn1, 1) == 737280
    assert flops.votes_bytes(en3, 1) == 4571136


def test_routing_bound_is_the_bytes_at_caps_mn1():
    mn1 = config("caps-mn1")
    fwd = flops.routing_bound_s(mn1, 100, 67e12, 3.35e12)
    bwd = flops.routing_bound_s(mn1, 100, 67e12, 3.35e12, backward=True)
    assert abs(fwd * 1e3 - 0.0220) < 1e-4
    assert abs(bwd * 1e3 - 0.0440) < 1e-4
