"""Causal / bidirectional GQA flash attention for Hopper: the launch
wrapper and its plain PyTorch version.

Port of the JAX package's ``repro/kernels/flash_attention/kernel.py``
(``flash_attention``, the forward ``_flash_kernel``).  The CUDA source is
``repro_torch/csrc/flash_attention.cu``, built with every other kernel into
one library by ``repro_torch.kernels.cudalib``.  The plain version repeats
the kernel's arithmetic — a blockwise online softmax with an fp32 running
max, sum and accumulator, the −1e30 mask value, causal k-blocks above the
diagonal skipped, the ``l == 0 → 1`` guard — and never materialises the
S × S scores.

Both take any S: the reference's rule that S divides by the block is a TPU
tiling rule, not part of the function, so the last block is ragged.
``block_q``/``block_k`` set the plain version's blocks (the reference's
128, capped at S); the kernel always tiles 64 × 64 and takes no block.
Query head h reads KV head h // (Hq / Hkv), the order of ``jnp.repeat``.

``flash_attention`` runs its plain version for a CPU tensor and launches
the kernel for a tensor on a Hopper card (``repro_torch.kernels.plain_mode``
raises for anything else); ``flash_attention.launches`` counts the calls
that launched the kernel.  It has no backward: with grad enabled and an
input that requires grad it raises, naming the slice that ports the
training kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cudalib, plain_mode, refuse_grad

_NEG_INF = -1e30
# dtype codes shared with flash_attention.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,Hq,S,D) and k, v "
                         f"(B,Hkv,S,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={k.shape[1]}")


def _scale(D: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else float(1.0 / D ** 0.5)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, block_q: int = 128,
                          block_k: int = 128,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of ``flash_attention``: the reference kernel's online
    softmax over (block_q × block_k) blocks, KV heads broadcast over their
    query-head group rather than copied."""
    _check_args(q, k, v)
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    scale = _scale(D, scale)
    bq, bk = min(block_q, S), min(block_k, S)
    qf = q.float().reshape(B, Hkv, group, S, D)
    kf = k.float()[:, :, None]                       # (B, Hkv, 1, S, D)
    vf = v.float()[:, :, None]
    out = torch.empty(B, Hkv, group, S, D, dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, S, bq):
        qb = qf[..., q0:q0 + bq, :]
        rows = torch.arange(q0, q0 + qb.shape[-2], device=q.device)
        m = torch.full((*qb.shape[:-1], 1), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, S, bk):
            if causal and k0 > q0 + bq - 1:          # wholly in the future
                break
            kb, vb = kf[..., k0:k0 + bk, :], vf[..., k0:k0 + bk, :]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if causal:
                cols = torch.arange(k0, k0 + kb.shape[-2], device=q.device)
                s = torch.where(cols[None, :] <= rows[:, None], s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vb)
            m = m_new
        out[..., q0:q0 + bq, :] = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(B, Hq, S, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D), one dtype (fp32 or bf16).
    Returns (B, Hq, S, D) in q's dtype."""
    refuse_grad("flash_attention", q, k, v)
    if plain_mode(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check_args(q, k, v)
    B, Hq, S, D = q.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"the kernel takes q, k, v of one dtype, fp32 or "
                         f"bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}; got {D}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = cudalib.build()
    err = lib.flash_attention_fwd(
        cudalib.ptr(q), cudalib.ptr(k), cudalib.ptr(v), cudalib.ptr(o),
        _DTYPE_CODE[q.dtype], B, Hq, k.shape[1], S, D, _scale(D, scale),
        int(causal), cudalib.stream(q.device))
    cudalib.check(err)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

