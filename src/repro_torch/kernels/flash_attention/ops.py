"""Public entry points of the flash-attention kernel (the JAX package's
``repro/kernels/flash_attention/ops.py``): the inference forward, and the
differentiable form that LM training brings."""
from __future__ import annotations

import torch

from repro_torch import slices
from repro_torch.kernels.flash_attention.kernel import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0.
    Returns (B, Hq, S, D) in q's dtype.  Any S runs: both versions mask the
    ragged last block, so the reference's halving of the block until it
    divides S is not needed."""
    return flash_attention(q, k, v, causal=causal)


def attention_train(q, k, v, causal: bool = True):
    """Differentiable flash attention over the forward-with-lse and backward
    kernels (the reference's ``attention_train``)."""
    raise slices.not_ported("attention_train (flash_attention_fwd_lse and "
                            "flash_attention_bwd)", slices.LM_TRAINING)
