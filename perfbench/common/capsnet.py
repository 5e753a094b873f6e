"""The CapsNet cells' shared set-up: weights and images from the seed on
the device, the program's CapsNet built from the configuration file with
those weights, the comparison of class scores with the reference, and the
sampling of what the window produced."""
from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

import torch

from perfbench.common.harness import sub_seed

BIAS_SCALE = 0.01


def param_specs(cfg: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, scale) of every parameter, under the program's names:
    conv weights OIHW, normal / sqrt(fan-in); ``digit.W`` normal x the
    configuration's ``digit_w_std``; dense weights (din, dout), normal /
    sqrt(din); biases normal x BIAS_SCALE."""
    k, kc = cfg["conv_kernel"], cfg["caps_kernel"]
    c1 = cfg["conv_channels"]
    caps = cfg["caps_channels"] * cfg["l_caps_dim"]
    cin = cfg["image_channels"]
    L, H = cfg["num_l_caps"], cfg["num_h_caps"]
    CL, CH = cfg["l_caps_dim"], cfg["h_caps_dim"]
    specs = [
        ("primary.conv1.w", (c1, cin, k, k), 1 / math.sqrt(k * k * cin)),
        ("primary.conv1.b", (c1,), BIAS_SCALE),
        ("primary.caps_conv.w", (caps, c1, kc, kc), 1 / math.sqrt(kc * kc * c1)),
        ("primary.caps_conv.b", (caps,), BIAS_SCALE),
        ("digit.W", (L, H, CL, CH), cfg["digit_w_std"]),
    ]
    dims = [H * CH, *cfg["decoder_hidden"],
            cfg["image_hw"] ** 2 * cfg["image_channels"]]
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        specs.append((f"decoder.fc{i}.w", (a, b), 1 / math.sqrt(a)))
        specs.append((f"decoder.fc{i}.b", (b,), BIAS_SCALE))
    return specs


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def make_weights(cfg: dict, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Every parameter from one normal draw on the device, split and
    scaled."""
    specs = param_specs(cfg)
    sizes = [math.prod(s) for _, s, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights",
                                                       device),
                       device=device)
    out = {}
    for (name, shape, scale), piece in zip(specs, flat.split(sizes)):
        out[name] = (piece * scale).reshape(shape)
    return out


def make_images(cfg: dict, n: int, seed: int, tag: str,
                device: torch.device) -> torch.Tensor:
    """``n`` images (n, H, W, C) of uniform pixels in [0, 1)."""
    hw, c = cfg["image_hw"], cfg["image_channels"]
    return torch.rand((n, hw, hw, c), generator=generator(seed, tag, device),
                      device=device)


def make_labels(cfg: dict, n: int, seed: int, tag: str,
                device: torch.device) -> torch.Tensor:
    return torch.randint(0, cfg["num_h_caps"], (n,),
                         generator=generator(seed, tag, device),
                         device=device)


def caps_config(cfg: dict):
    """The program's ``CapsConfig`` of the configuration file."""
    from repro_torch.configs.caps_benchmarks import CapsConfig
    return CapsConfig(
        name=cfg["network"], dataset=cfg["dataset"],
        batch_size=cfg["batch_size"], num_l_caps=cfg["num_l_caps"],
        num_h_caps=cfg["num_h_caps"], routing_iters=cfg["routing_iters"],
        l_caps_dim=cfg["l_caps_dim"], h_caps_dim=cfg["h_caps_dim"],
        image_hw=cfg["image_hw"], image_channels=cfg["image_channels"],
        conv_channels=cfg["conv_channels"],
        caps_channels=cfg["caps_channels"])


def build_net(cfg: dict, weights: Dict[str, torch.Tensor],
              device: torch.device):
    """The program's ``CapsNet`` on ``device`` holding ``weights`` (copied
    in through its parameter names; every name and shape must match)."""
    from repro_torch.models.capsnet import CapsNet
    net = CapsNet(caps_config(cfg), device=device)
    params = dict(net.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError(f"the program's CapsNet has parameters "
                           f"{sorted(params)}; the configuration makes "
                           f"{sorted(weights)}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise RuntimeError(f"{name}: program {tuple(p.shape)}, "
                                   f"configuration "
                                   f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
    return net


def router_spec(cfg: dict):
    """The configuration's routing on the port's CUDA kernels (on a CPU
    tensor the kernel wrappers run their plain versions)."""
    from repro_torch.core.router import RouterSpec
    return RouterSpec(algorithm=cfg["routing"], backend="cuda",
                      iterations=cfg["routing_iters"])


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn from
    the seed (Algorithm R): item i is kept with probability k / (i + 1)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(sub_seed(seed, "sample"))
        self.seen = 0
        self.items: list = []

    def slot(self) -> int:
        """The slot the next item goes to, or -1 if it is not kept; call
        once per item offered."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(None)
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else -1

    def put(self, slot: int, item) -> None:
        self.items[slot] = item


def score_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest gap between the program's class scores and the
    reference's (scores ||v|| lie in [0, 1))."""
    return float(torch.max(torch.abs(program.float().cpu()
                                     - reference.float().cpu())))
