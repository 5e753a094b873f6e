r"""Paper §5.2.2 — low-cost bit-level approximation of the RP special functions.

The PIM-CapsNet PE has only adders, multipliers and bit-shifters; the paper
replaces the routing procedure's special functions (exp in softmax Eq.5,
division + inverse-sqrt in squash Eq.3) with bit-shifting approximations and
recovers accuracy with a single calibrated multiplier ("Accuracy Recovery").

Port of the JAX package's ``repro/core/approx.py``: the same constants and
the same fp32 operation order, with ``Tensor.view(torch.int32)`` as the
FP32<->int32 reinterpret.  Gradients follow the reference's: the float->int
cast and the bitcasts carry no tangent, so ``fast_exp`` (and with it
``approx_softmax``) has gradient zero — a zero, not a missing gradient —
while the Newton steps of ``fast_inv_sqrt``/``fast_reciprocal`` carry their
input's tangent.  The three bit-level functions (``fast_exp``,
``fast_inv_sqrt``, ``fast_reciprocal``) are bit-identical to the reference
on the same fp32 inputs; the softmax/squash composites add a reduction
(whose order XLA and PyTorch choose differently) and agree to a few ulp
(tests/test_torch_approx.py).  The CUDA
kernels repeat these formulas as ``__device__`` helpers
(``repro_torch/csrc/routing.cu``).

Math recap (paper Fig.12):
  e^x = 2^y with y = log2(e)*x = floor(y) + f,  f in [0,1)
  FP32(result) has exponent field floor(y)+bias and mantissa (2^f - 1)*2^23.
  As an integer:  bits = (y + bias + (2^f - 1 - f)) * 2^23.
  The data-dependent term (2^f - 1 - f) is replaced by its mean
  Avg = \int_0^1 (2^t - 1 - t) dt = 1/ln2 - 1.5  ~= -0.057304959
  so   bits ~= (log2(e)*x + bias + Avg) * 2^23,
  i.e. one MAC plus a bit-shift ("BS") realised here as the int cast+bitcast.
"""
from __future__ import annotations

from typing import Callable

import torch

LOG2E = 1.4426950408889634  # log2(e), computed offline per the paper
# Avg = integral_0^1 (2^t - 1 - t) dt = 1/ln2 - 3/2
EXP_AVG = 1.0 / 0.6931471805599453 - 1.5
_F32_BIAS = 127.0
_F32_MANT = float(2 ** 23)

# Accuracy-recovery multipliers (paper: "enlarging the results by the mean
# percentage of the value difference", calibrated offline on 10k samples).
EXP_RECOVERY = 1.0000973  # mean(exact/approx) for x ~ U[-10, 10]
INV_SQRT_RECOVERY = 1.0008818  # after one Newton step, x ~ U[0.01, 100]
RECIP_RECOVERY = 1.0013653  # after one Newton step, x ~ U[0.01, 100]


def _bitcast_i32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _bitcast_f32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.float32)


class _ZeroTangent(torch.autograd.Function):
    """``out``, a bit-level function of ``x``, as a constant of ``x`` with
    gradient zero: what ``jax.grad`` gives through ``astype(int32)`` and
    ``bitcast_convert_type``.  (No straight-through estimate.)"""

    @staticmethod
    def forward(ctx, out, x):
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.x_meta
        return None, torch.zeros(shape, dtype=dtype, device=device)


def fast_exp(x: torch.Tensor, *, recover: bool = True) -> torch.Tensor:
    """Paper Eq. "ExpResult ~= BS(log2(e) * x + Avg + b - 1)" (Fig.12).

    One multiply + one add + one bit-shift; FP32 only.  The input is clipped
    to [0, 254.999] before the int32 cast, so the cast's truncation equals
    floor and the bitcast cannot wrap.
    """
    x = x.float()
    y = LOG2E * x + (_F32_BIAS + EXP_AVG)
    y = torch.clamp(y, 0.0, 254.999)
    bits = (y * _F32_MANT).to(torch.int32)  # the "BS" stage
    out = _bitcast_f32(bits)
    if recover:
        # the reference's fp32 multiply (XLA) flushes a subnormal operand to
        # zero; bits < 2^23 is exactly the subnormal range of the bitcast
        out = torch.where(bits < 0x800000, torch.zeros_like(out),
                          out * EXP_RECOVERY)
    if torch.is_grad_enabled() and x.requires_grad:
        out = _ZeroTangent.apply(out, x)
    return out


def fast_inv_sqrt(x: torch.Tensor, *, newton_iters: int = 1,
                  recover: bool = True) -> torch.Tensor:
    """Inverse square root via bit shifting [paper ref 60, Lomont 2003]:
    i' = 0x5f3759df - (i >> 1), then ``newton_iters`` Newton-Raphson steps."""
    x = x.float()
    i = 0x5F3759DF - (_bitcast_i32(x) >> 1)
    y = _bitcast_f32(i.to(torch.int32))
    for _ in range(newton_iters):
        y = y * (1.5 - 0.5 * x * y * y)
    if recover:
        y = y * INV_SQRT_RECOVERY
    return y


def fast_reciprocal(x: torch.Tensor, *, newton_iters: int = 1,
                    recover: bool = True) -> torch.Tensor:
    """Division via bit shifting: bits(1/x) ~= 0x7EF311C2 - bits(x), then
    Newton steps y <- y * (2 - x*y).  Positive inputs (squash norms) only."""
    x = x.float()
    i = 0x7EF311C2 - _bitcast_i32(x)
    y = _bitcast_f32(i.to(torch.int32))
    for _ in range(newton_iters):
        y = y * (2.0 - x * y)
    if recover:
        y = y * RECIP_RECOVERY
    return y


def approx_softmax(b: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Eq.5 softmax with the PE's fast_exp (max-subtracted, as the
    reference keeps it, so the fast_exp clamp never saturates)."""
    b = b.float()
    b = b - torch.amax(b, dim=axis, keepdim=True).detach()
    e = fast_exp(b)
    denom = torch.sum(e, dim=axis, keepdim=True)
    return e * fast_reciprocal(denom)


def approx_squash(s: torch.Tensor, axis: int = -1,
                  eps: float = 1e-9) -> torch.Tensor:
    """Eq.3 squash with fast inverse-sqrt + fast reciprocal:
    v = s * |s|^2 * invsqrt(|s|^2) * recip(1+|s|^2)."""
    s = s.float()
    n2 = torch.sum(s * s, dim=axis, keepdim=True) + eps
    return s * (n2 * fast_inv_sqrt(n2) * fast_reciprocal(1.0 + n2))


def exact_softmax(b: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.softmax(b.float(), dim=axis)


def exact_squash(s: torch.Tensor, axis: int = -1,
                 eps: float = 1e-9) -> torch.Tensor:
    s = s.float()
    n2 = torch.sum(s * s, dim=axis, keepdim=True)
    return s * (n2 / (1.0 + n2)) / torch.sqrt(n2 + eps)


def calibrate_recovery(approx_fn: Callable[[torch.Tensor], torch.Tensor],
                       exact_fn: Callable[[torch.Tensor], torch.Tensor],
                       samples: torch.Tensor) -> float:
    """Paper §5.2.2 Accuracy Recovery: mean(exact/approx) over a calibration
    set, applied at inference as a single extra multiply."""
    a = approx_fn(samples)
    e = exact_fn(samples)
    ratio = e / torch.where(a == 0, torch.ones_like(a), a)
    return float(torch.mean(ratio))
