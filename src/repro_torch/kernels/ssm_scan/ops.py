"""Public entry point of the selective-scan kernel (the JAX package's
``repro/kernels/ssm_scan/ops.py``).  The reference's chunk rule stays: the
largest power of two up to 64 that divides T."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssm_scan.kernel import selective_scan


def scan(x, dt, A, B, C, D, *, h0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, h_T); the reference's ``scan`` returns y alone."""
    T = x.shape[1]
    chunk = 64
    while T % chunk:
        chunk //= 2
    return selective_scan(x, dt, A, B, C, D, chunk=chunk, h0=h0)
