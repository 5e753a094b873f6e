"""Shape-generic entry points of the fastmath kernel (the JAX package's
``repro/kernels/fastmath/ops.py``): any shape is flattened, zero-padded to
rows of 512 and run through ``fastmath_2d`` in blocks of up to 256 rows."""
from __future__ import annotations

import torch

from repro_torch.kernels.fastmath.kernel import fastmath_2d


def _as_2d(x: torch.Tensor):
    shape = x.shape
    flat = x.reshape(-1)
    n = flat.shape[0]
    # pad to a 2D tile multiple (rows of 512)
    cols = 512 if n >= 512 else n
    rows = -(-n // cols)
    if rows * cols > n:
        flat = torch.nn.functional.pad(flat, (0, rows * cols - n))
    return flat.reshape(rows, cols), shape


def _apply(x: torch.Tensor, op: str, recover: bool) -> torch.Tensor:
    x2d, shape = _as_2d(x)
    r, c = x2d.shape
    out = fastmath_2d(x2d, op=op, recover=recover, block_rows=min(256, r),
                      block_cols=c)
    return out.reshape(-1)[:shape.numel()].reshape(shape)


def exp(x: torch.Tensor, recover: bool = True) -> torch.Tensor:
    return _apply(x, "exp", recover)


def inv_sqrt(x: torch.Tensor, recover: bool = True) -> torch.Tensor:
    return _apply(x, "inv_sqrt", recover)


def reciprocal(x: torch.Tensor, recover: bool = True) -> torch.Tensor:
    return _apply(x, "reciprocal", recover)
