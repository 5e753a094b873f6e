"""Exact oracles for the fastmath kernel (the JAX package's
``repro/kernels/fastmath/ref.py``)."""
from __future__ import annotations

import torch


def exp_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.float())


def inv_sqrt_ref(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.sqrt(x.float())


def reciprocal_ref(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / x.float()


def squash_ref(s: torch.Tensor) -> torch.Tensor:
    s = s.float()
    n2 = torch.sum(s * s, dim=-1, keepdim=True)
    return s * (n2 / (1.0 + n2)) / torch.sqrt(n2 + 1e-9)
