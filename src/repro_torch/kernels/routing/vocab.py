"""Routing-kernel vocabulary — the spec-level constants, importable light.

``core.router._validate`` needs only the legal ``fusion`` / ``stream_dtype``
vocabularies to reject a bad ``RouterSpec`` at construction; this module
holds them with no kernel imports (the counterpart of the JAX package's
``repro/kernels/routing/vocab.py``).
"""
from __future__ import annotations

import torch

# û streaming dtypes on the cuda backend: accumulation is always fp32;
# bf16 halves the bytes of the only O(B·L·H·C) operand, int8 quarters them
# (per-L-tile symmetric scale, dequantized in-kernel).  int8 is
# procedure-kernel-only and inference-only; ops.resolve_fusion /
# router._validate enforce both.
STREAM_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}

# RouterSpec.fusion vocabulary: "auto" resolves to the procedure kernel when
# the plan is shard-local and the reference's tile-budget model fits.
FUSION_LEVELS = ("auto", "iteration", "procedure")


def stream_itemsize(stream_dtype: str) -> int:
    """Bytes per û element at ``stream_dtype`` (validates the name)."""
    if stream_dtype not in STREAM_DTYPES:
        raise ValueError(f"unknown stream_dtype {stream_dtype!r}; expected "
                         f"one of {sorted(STREAM_DTYPES)}")
    return torch.empty((), dtype=STREAM_DTYPES[stream_dtype]).element_size()
