"""Gradient compression: int8 quantization with error feedback (EF-SGD
style).

A copy of the JAX package's ``repro/runtime/compression.py`` in PyTorch:
gradients are quantized to int8 with a per-leaf scale and dequantized, with
the quantization residual fed back into the next step.  Here a tree is a
mapping from parameter name to tensor (the train step's flat gradients).
``torch.round`` rounds half to even, as ``jnp.round`` does.  A sharded
gradient (this rank's block of a leaf) takes the scale of the whole leaf:
the max is ``pmax``'d over the axes the leaf is held in blocks over.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.runtime import mesh_utils


def quantize_int8(x: torch.Tensor, axes=None,
                  mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and the scale max|x| / 127; ``axes``: the mesh axes
    ``x`` is a block of a leaf over (its max is the leaf's)."""
    x = x.float()
    amax = mesh_utils.pmax(x.abs().max(), axes or None, mesh=mesh)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads_with_feedback(grads: Mapping[str, torch.Tensor],
                                 error: Mapping[str, torch.Tensor],
                                 held: Optional[Mapping[str, tuple]] = None,
                                 mesh=None
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            Dict[str, torch.Tensor]]:
    """Quantize (grads + carried error); return (dequantized grads in each
    gradient's dtype, new fp32 error).  ``error`` has the keys of
    ``grads``; start it with ``init_error_feedback``.  ``held``: each
    sharded gradient's block axes on ``mesh`` (``quantize_int8``)."""
    out, new_error = {}, {}
    for k, g in grads.items():
        g32 = g.float() + error[k]
        axes = held[k] if held is not None else None
        dq = dequantize_int8(*quantize_int8(g32, axes, mesh))
        out[k], new_error[k] = dq.to(g.dtype), g32 - dq
    return out, new_error


def init_error_feedback(grads_like: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}
