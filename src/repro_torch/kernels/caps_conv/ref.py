"""The float64 oracle of the PrimaryCaps convolution: NHWC in and out, an
OIHW weight, VALID padding."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def caps_conv_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """(B, H, W, C_in) -> (B, H_o, W_o, C_out) in float64."""
    y = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), b.double(),
                 stride=stride)
    return y.permute(0, 2, 3, 1)
