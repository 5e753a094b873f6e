"""LR schedules as pure functions of the step index (a copy of the JAX
package's ``repro/optim/schedule.py`` in torch).  ``step`` may be an int or
a tensor; the result is an fp32 scalar tensor."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1):
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return final_frac + (1.0 - final_frac) * cos


def linear_warmup_cosine(step, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    step = _f32(step)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    return warm * cosine_schedule(torch.clamp(step - warmup, min=0.0),
                                  max(total_steps - warmup, 1), final_frac)
