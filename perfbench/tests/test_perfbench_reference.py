"""The plain reference agrees with the program on its torch routing
backend at a CPU size: serving wave scores with empty lanes, the loss,
and three training steps."""
import pytest
import torch

from perfbench.common import capsnet as caps
from perfbench.reference import capsnet as ref
from perfbench.tests import smoke

CFG = smoke.SMOKE_CONFIG
CPU = torch.device("cpu")
OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "max_grad_norm": 1.0, "warmup": 100, "total_steps": 10000}


@pytest.fixture(scope="module")
def weights():
    return caps.make_weights(CFG, 2 ** 32 + 3, CPU)


def test_wave_scores_match_the_program(weights):
    from repro_torch.core.router import RouterSpec
    from repro_torch.runtime.caps_serve import ServeConfig, make_wave_fn
    net = caps.build_net(CFG, weights, CPU)
    wave = make_wave_fn(net, RouterSpec(iterations=3),
                        ServeConfig(microbatch=16, n_micro=2))
    images = caps.make_images(CFG, 32, 1, "images", CPU).reshape(
        2, 16, 28, 28, 1)
    mask = torch.ones(2, 16)
    mask[1, 9:] = 0.0
    images[1, 9:] = 0.0
    got = wave({"images": images, "mask": mask})
    want = ref.wave_scores(weights, images, mask, CFG)
    assert torch.allclose(got, want, rtol=0, atol=2e-6)
    assert float(want[1, 9:].abs().max()) == 0.0


def test_loss_matches_the_program(weights):
    from repro_torch.models import capsnet
    net = caps.build_net(CFG, weights, CPU)
    images = caps.make_images(CFG, 16, 2, "images", CPU)
    labels = caps.make_labels(CFG, 16, 2, "labels", CPU)
    got, _ = capsnet.loss_fn(net, images, labels)
    got = got.detach()
    want = ref.loss(weights, images, labels, CFG, ref.Precision(False, CPU))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_three_training_steps_match_the_program(weights):
    from repro_torch.core.router import RouterSpec
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train_loop import make_capsnet_train_step
    net = caps.build_net(CFG, weights, CPU)
    step = make_capsnet_train_step(
        caps.caps_config(CFG), spec=RouterSpec(iterations=3),
        opt_cfg=AdamWConfig(), max_grad_norm=1.0, total_steps=10000,
        warmup=100, device=CPU)
    opt = adamw_init(dict(net.named_parameters()))
    images = caps.make_images(CFG, 48, 3, "images", CPU)
    labels = caps.make_labels(CFG, 48, 3, "labels", CPU)
    batches = [(images[i * 16:(i + 1) * 16], labels[i * 16:(i + 1) * 16])
               for i in range(3)]
    losses = []
    for k, b in enumerate(batches):
        net, opt, m = step(net, opt, *b)
        losses.append(float(m["loss"]))
        if k == 0:
            mu1 = {n: t.clone() for n, t in opt.mu.items()}
    want = ref.train(weights, batches, CFG, OPT)
    assert losses == pytest.approx(want["losses"], rel=1e-6)
    for name, p in net.named_parameters():
        g = mu1[name] / 0.1
        assert torch.allclose(g, want["first_grads"][name], rtol=1e-3,
                              atol=1e-6 * float(g.abs().max()) + 1e-12)
        assert torch.allclose(p.detach(), want["params"][name], rtol=0,
                              atol=1e-6)
