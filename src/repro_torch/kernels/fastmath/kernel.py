"""The paper's §5.2.2 PE special-function unit as an elementwise kernel for
Hopper: the launch wrapper and its plain PyTorch version.

Port of the JAX package's ``repro/kernels/fastmath/kernel.py``
(``fastmath_2d``): bit-trick exp / inverse square root / reciprocal over a
2-D fp32 array, one Newton step where the op has one, and the optional
accuracy-recovery multiplier.  The CUDA source is
``repro_torch/csrc/fastmath.cu``, built with every other kernel into one
library by ``repro_torch.kernels.cudalib``; its arithmetic is the routing
kernels' own (``csrc/routing.cuh``), as the plain version's is
``repro_torch.core.approx``.

``fastmath_2d`` runs its plain version for a CPU tensor and launches the
kernel for a tensor on a Hopper card (``repro_torch.kernels.plain_mode``
raises for anything else).  ``fastmath_2d.launches`` counts the calls that
launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import approx
from repro_torch.kernels import cudalib, plain_mode, refuse_fake

_OPS = ("exp", "inv_sqrt", "reciprocal")
# op codes shared with fastmath.cu
_OP_CODE = {op: i for i, op in enumerate(_OPS)}


def _check_args(x: torch.Tensor, op: str, block_rows: int,
                block_cols: int) -> None:
    """The reference's error surface: a 2-D array divisible by its block,
    and a known op."""
    if x.dim() != 2:
        raise ValueError(f"fastmath_2d takes a 2-D array; got shape "
                         f"{tuple(x.shape)}")
    R, Ccols = x.shape
    br, bc = min(block_rows, R), min(block_cols, Ccols)
    if R % br or Ccols % bc:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by block "
                         f"({br},{bc})")
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op}")


def fastmath_2d_plain(x: torch.Tensor, *, op: str, recover: bool = True,
                      block_rows: int = 256,
                      block_cols: int = 512) -> torch.Tensor:
    """Plain version of ``fastmath_2d``: ``core.approx``'s bit-level
    functions, which repeat the reference kernel's fp32 operation order."""
    _check_args(x, op, block_rows, block_cols)
    x = x.float()
    if op == "exp":
        return approx.fast_exp(x, recover=recover)
    if op == "inv_sqrt":
        return approx.fast_inv_sqrt(x, recover=recover)
    return approx.fast_reciprocal(x, recover=recover)


def fastmath_2d(x: torch.Tensor, *, op: str, recover: bool = True,
                block_rows: int = 256, block_cols: int = 512) -> torch.Tensor:
    """Apply a PE-approximated special function over a 2-D array; returns
    fp32 of the same shape.  ``block_rows``/``block_cols`` are the
    reference's slab, kept for its divisibility error; the kernel walks the
    array as one flat range."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("fastmath_2d has no autograd formula: its input "
                         "requires grad; call under torch.no_grad() or use "
                         "repro_torch.core.approx")
    refuse_fake("fastmath_2d", x)
    if plain_mode(x):
        return fastmath_2d_plain(x, op=op, recover=recover,
                                 block_rows=block_rows,
                                 block_cols=block_cols)
    _check_args(x, op, block_rows, block_cols)
    x = x.float()
    if not x.is_contiguous():
        raise ValueError("fastmath_2d needs a contiguous array")
    lib = cudalib.build()
    out = torch.empty_like(x)
    err = lib.fastmath_apply(cudalib.ptr(x), cudalib.ptr(out), x.numel(),
                             _OP_CODE[op], int(recover),
                             cudalib.stream(x.device))
    cudalib.check(err)
    fastmath_2d.launches += 1
    return out


fastmath_2d.launches = 0
