"""The paper's 12 CapsNet benchmarks (Table 1) — a copy of the JAX package's
``repro/configs/caps_benchmarks.py`` (the port imports nothing of ``repro``).

| network  | dataset          | BS  | L caps | H caps | iters |
|----------|------------------|-----|--------|--------|-------|
| Caps-MN1 | MNIST            | 100 | 1152   | 10     | 3     |
| ...      |                  |     |        |        |       |

All use the CapsNet-MNIST-like structure (paper §2.1): Conv(9x9,256) →
PrimaryCaps(32×C_L=8 maps) → DigitCaps (C_H=16) with dynamic routing, plus
the FC reconstruction decoder.  L caps counts follow from the dataset's
spatial dims; we parameterise directly by the Table-1 numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class CapsConfig:
    name: str
    dataset: str
    batch_size: int
    num_l_caps: int
    num_h_caps: int
    routing_iters: int
    l_caps_dim: int = 8
    h_caps_dim: int = 16
    image_hw: int = 28
    image_channels: int = 1
    conv_channels: int = 256
    caps_channels: int = 32

    @property
    def spatial(self) -> int:
        """PrimaryCaps spatial size implied by num_l_caps = s*s*caps_channels."""
        s2 = self.num_l_caps // self.caps_channels
        return int(round(s2 ** 0.5))


CAPS_BENCHMARKS: Dict[str, CapsConfig] = {
    "Caps-MN1": CapsConfig("Caps-MN1", "MNIST", 100, 1152, 10, 3),
    "Caps-MN2": CapsConfig("Caps-MN2", "MNIST", 200, 1152, 10, 3),
    "Caps-MN3": CapsConfig("Caps-MN3", "MNIST", 300, 1152, 10, 3),
    "Caps-CF1": CapsConfig("Caps-CF1", "CIFAR10", 100, 2304, 11, 3,
                           image_hw=32, image_channels=3),
    "Caps-CF2": CapsConfig("Caps-CF2", "CIFAR10", 100, 3456, 11, 3,
                           image_hw=32, image_channels=3, caps_channels=48),
    "Caps-CF3": CapsConfig("Caps-CF3", "CIFAR10", 100, 4608, 11, 3,
                           image_hw=32, image_channels=3, caps_channels=64),
    "Caps-EN1": CapsConfig("Caps-EN1", "EMNIST_Letter", 100, 1152, 26, 3),
    "Caps-EN2": CapsConfig("Caps-EN2", "EMNIST_Balanced", 100, 1152, 47, 3),
    "Caps-EN3": CapsConfig("Caps-EN3", "EMNIST_By_Class", 100, 1152, 62, 3),
    "Caps-SV1": CapsConfig("Caps-SV1", "SVHN", 100, 576, 10, 3,
                           image_hw=32, image_channels=3, caps_channels=16),
    "Caps-SV2": CapsConfig("Caps-SV2", "SVHN", 100, 576, 10, 6,
                           image_hw=32, image_channels=3, caps_channels=16),
    "Caps-SV3": CapsConfig("Caps-SV3", "SVHN", 100, 576, 10, 9,
                           image_hw=32, image_channels=3, caps_channels=16),
}


def smoke_caps() -> CapsConfig:
    """Reduced config for CPU tests: ~4x smaller routing problem than
    Caps-MN1, with num_l_caps exactly matching the conv pipeline's natural
    6x6x8 capsule grid (28px: conv9 -> 20, caps-conv9/s2 -> 6) so no
    capsule crop/tile distorts position information."""
    return CapsConfig("Caps-smoke", "synthetic", 16, 288, 10, 3,
                      caps_channels=8, image_hw=28, conv_channels=64)
