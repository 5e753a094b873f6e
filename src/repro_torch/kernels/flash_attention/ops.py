"""Public entry points of the flash-attention kernels (the JAX package's
``repro/kernels/flash_attention/ops.py``): the inference forward, and the
differentiable form that LM training runs."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention, flash_attention_bwd, flash_attention_fwd_lse)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0, and
    Sk = Sq where ``causal`` (bidirectional attention takes any Sk: cross
    attention).  Returns (B, Hq, Sq, D) in q's dtype.  Any length runs:
    both versions mask the ragged last block, so the reference's halving of
    the block until it divides S is not needed.  ``window``: the causal
    sliding window (each row sees its last ``window`` keys, itself
    included)."""
    return flash_attention(q, k, v, causal=causal, window=window)


class _AttentionTrain(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves q, k, v, o and lse
    (``_attn_fwd``); the backward runs the backward kernels
    (``_attn_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd_lse(q, k, v, causal=causal,
                                         window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse,
                                         do.to(q.dtype).contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Differentiable flash attention over the forward-with-lse and backward
    kernels (the reference's ``attention_train``).  q: (B, Hq, Sq, D); k,
    v: (B, Hkv, Sk, D) with GQA Hq % Hkv == 0, as in ``attention``.
    Returns o (B, Hq, Sq, D) in q's dtype; its gradient reaches q, k and v.
    ``window`` as in ``attention``."""
    return _AttentionTrain.apply(q, k, v, causal, window)
