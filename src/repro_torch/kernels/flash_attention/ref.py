"""Dense oracle for the flash-attention kernel — the full softmax
materialised (the JAX package's ``kernels/flash_attention/ref.py``)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale: Optional[float] = None,
            window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0 (GQA),
    Sk = Sq where causal.  ``window`` (causal only): row r sees keys
    r - window < c <= r.

    Returns (B, Hq, Sq, D) in q's dtype.  fp32 softmax accumulation."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if window is not None and not causal:
        raise ValueError("a sliding window needs causal attention")
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        if window is not None:
            mask = mask.triu(1 - window)
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
