"""Gradient compression: int8 quantization with error feedback (EF-SGD
style).

A copy of the JAX package's ``repro/runtime/compression.py`` in PyTorch:
gradients are quantized to int8 with a per-leaf scale and dequantized, with
the quantization residual fed back into the next step.  Here a tree is a
mapping from parameter name to tensor (the train step's flat gradients).
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads_with_feedback(grads: Mapping[str, torch.Tensor],
                                 error: Mapping[str, torch.Tensor]
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            Dict[str, torch.Tensor]]:
    """Quantize (grads + carried error); return (dequantized grads in each
    gradient's dtype, new fp32 error).  ``error`` has the keys of
    ``grads``; start it with ``init_error_feedback``."""
    out, new_error = {}, {}
    for k, g in grads.items():
        g32 = g.float() + error[k]
        dq = dequantize_int8(*quantize_int8(g32))
        out[k], new_error[k] = dq.to(g.dtype), g32 - dq
    return out, new_error


def init_error_feedback(grads_like: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}
