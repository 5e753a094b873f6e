"""Causal (optionally sliding-window) / bidirectional GQA flash attention
for Hopper: the launch wrappers and their plain PyTorch versions.

Port of the JAX package's ``repro/kernels/flash_attention/kernel.py``:

* ``flash_attention`` — the serving forward (``_flash_kernel``);
* ``flash_attention_fwd_lse`` — the training forward, o and the row
  log-sum-exp lse = m + log(l) in fp32 (``_flash_fwd_lse_kernel``);
* ``flash_attention_bwd`` — the FlashAttention-2 backward
  (``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``): delta = Σ_D o·dO
  in fp32 outside the kernels, dq per query head, dk and dv per *query*
  head in q's dtype, then summed over each KV head's group in a fixed
  order (``group_sum``, plain PyTorch) — the reference's rounding order.

The CUDA sources are ``repro_torch/csrc/flash_attention.cu`` (both
forwards), ``csrc/flash_attention_bwd.cu`` and, for head dims above 256,
``csrc/flash_attention_wide.cu`` (all three functions), built with every
other kernel into one library by ``repro_torch.kernels.cudalib``.  bf16 inputs
run on the tensor cores (``mma.sync``, bf16 operands, fp32 accumulation,
FlashAttention-2 style; the building blocks in ``csrc/flash_tc.cuh``): p,
and in the backward ds, is rounded to bf16 in registers before each
product whose operand it is, as the library's attention does.  fp32 inputs
up to D = 256 run on the tensor cores too, in split TF32
(``mma.sync.m16n8k8``: each fp32 operand split into a TF32 big part and a
TF32 small part, three products a product, fp32 accumulation), which keeps
fp32-level error; their blocks and steps are ``f32_geometry``'s.  What
bounds them is operations: at granite-3-2b's shape (B=8, Hq=32, S=1024,
D=64, causal) the forward is about 34 GFLOP, 0.035 ms at the 989 TFLOP/s
bf16 rate (0.206 ms at split TF32's 165), and the backward 2.5 times
that.

The plain versions repeat the kernels' arithmetic blockwise — an online
softmax with an fp32 running max, sum and accumulator, the −1e30 mask
value, causal blocks above the diagonal skipped, the ``l == 0 → 1`` guard,
p recomputed from lse in the backward — and never materialise S × S
scores.  ``round_operands=True`` adds the bf16 kernels' rounding of p and
ds (a model of them; the default is the fp32 arithmetic).

All take any S: the reference's rule that S divides by the block is a TPU
tiling rule, not part of the function, so the last block is ragged.
Bidirectional attention (``causal=False``) also takes keys and values of
another length than the queries: q (B, Hq, Sq, D) against k, v (B, Hkv,
Sk, D), the cross attention of an encoder–decoder (the reference's
``_chunked_attention`` with ``kv_override``); o, lse, dq follow q and dk,
dv follow k.  Causal attention with Sk ≠ Sq raises ``ValueError``: the
reference never asks for it, and where its diagonal lies would be a
choice the reference does not make.
``block_q``/``block_k`` set the plain versions' blocks (the reference's
128, capped at S); the kernels always tile 64 × 64 and take no block.
Query head h reads KV head h // (Hq / Hkv), the order of ``jnp.repeat``.
The kernels are instantiated at the head dims ``HEAD_DIMS`` (zamba2-7b's
112, stablelm-12b's 160 and 256, the largest head dim of public dense
models, beside the powers of two).  On a CUDA tensor any other D up to 256
runs zero-padded to the next instantiated one (``forward_padded``,
``backward_padded``): zero columns of q and k add nothing to q·kᵀ, the
scale stays 1/√D of the unpadded D, the padded columns of o, dq, dk and dv
are dropped, and lse and delta do not change.  A D above 256 runs as it
is, unpadded, on the wide kernels (``flash_attention_wide.cu``).  Their
bf16 forward and backward run on the tensor cores and round p, and ds,
as the other bf16 kernels do, at the geometries ``wide_fwd_geometry`` and
``wide_bwd_geometry`` compute from D (the forward and the dq kernel: one
piece of the head dim up to 512, the score products once per tile pair;
pieces of at most 512 columns above, each recomputing the scores; the
dk/dv kernel: two pieces up to 512, ceil(D / 256) above); the fp32
forward and backward compute in fp32 FFMA on the CUDA cores at the
geometries ``wide_f32_fwd_geometry`` and ``wide_f32_bwd_geometry``
compute from D (pieces of o, dq, dv and dk up to 512 columns, the
pieces of a tile one cluster that runs the score products once per tile
pair).  Every D runs.

``window`` (causal only) is the reference's sliding window
(``repro/models/layers.py::_chunked_attention``): key ``col`` counts for
row ``row`` iff ``col <= row`` and ``col > row - window``.  Blocks wholly
before the window are skipped as causal blocks past the diagonal are;
``window=None``, or a window of S or more, gives the causal result
bitwise.  A window on bidirectional attention raises ``ValueError``: the
reference never asks for it.

Each launching wrapper runs its plain version for a CPU tensor and
launches its kernel for a tensor on a Hopper card
(``repro_torch.kernels.plain_mode`` raises for anything else); its
``launches`` attribute counts the calls that launched the kernel.  On a
fake tensor (the dry run's: ``repro_torch.kernels.fake_mode``) a wrapper
takes its launch path up to the launch — the same allocations, pad copies,
delta and group sum — and reports the kernel's operations and bytes
(``attention_cost``, the formulas of its bound) instead of launching.  The
two forwards record no gradient: with grad enabled and an input that
requires grad they raise — gradients go through ``ops.attention_train``,
the autograd Function over the training forward and the backward.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import (cudalib, fake_mode, plain_mode,
                                 refuse_grad, report_kernel)

_NEG_INF = -1e30
# dtype codes shared with flash_attention.cu, flash_attention_bwd.cu and
# flash_attention_wide.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 160, 256)  # the kernels' instantiations
# above this head dim the wide kernels run, at D itself
WIDE_ABOVE = HEAD_DIMS[-1]
_GRAD_HINT = "gradients go through kernels.flash_attention.ops.attention_train"


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B,Hq,Sq,D) and k, v "
                         f"(B,Hkv,Sk,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    if (k.shape[0], k.shape[3]) != (B, D):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={k.shape[1]}")
    if causal and k.shape[2] != Sq:
        raise ValueError(f"causal attention needs as many keys as queries; "
                         f"got Sq={Sq}, Sk={k.shape[2]} (keys of another "
                         f"length are bidirectional: causal=False)")


def _check_bwd_args(q, k, v, o, lse, do, causal: bool) -> None:
    _check_args(q, k, v, causal)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} must be {tuple(q.shape)}; got "
                             f"{tuple(t.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse must be {tuple(q.shape[:3])}; got "
                         f"{tuple(lse.shape)}")


def _check_kernel_args(*tensors: torch.Tensor) -> None:
    """What the kernels take beyond the function's shapes: one device, one
    dtype (fp32 or bf16), a head dim they instantiate or one above 256 (the
    wide kernels), contiguous inputs (in bf16 also 16-byte aligned, for
    cp.async; fp32 ones up to D = 256 copy 4 bytes at a time where a base
    is not)."""
    q = tensors[0]
    if any(t.device != q.device for t in tensors):
        raise ValueError("the flash-attention inputs must lie on one device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in tensors):
        raise ValueError(f"the kernels take inputs of one dtype, fp32 or "
                         f"bf16; got {[t.dtype for t in tensors]}")
    if q.shape[3] not in HEAD_DIMS and q.shape[3] <= WIDE_ABOVE:
        raise ValueError(f"the kernels take head dims {HEAD_DIMS} and any "
                         f"above {WIDE_ABOVE}; got {q.shape[3]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the flash-attention kernels need contiguous inputs")
    if q.dtype == torch.bfloat16 and not fake_mode(q) and any(
            t.data_ptr() % 16 for t in tensors):
        raise ValueError("the bf16 flash-attention kernels load 16 bytes at "
                         "a time and need 16-byte aligned inputs")


def _check_window(causal: bool, window: Optional[int]) -> None:
    if window is None:
        return
    if not causal:
        raise ValueError("a sliding window needs causal attention; the "
                         "reference never asks for a bidirectional one")
    if int(window) < 1:
        raise ValueError(f"window must be a positive int; got {window!r}")


# the backward's products over the forward's (recomputed q·kᵀ, dO·vᵀ, and
# the three products into dq, dk, dv against the forward's two)
BWD_FLOP_FACTOR = 2.5


def attention_cost(kind: str, q: torch.Tensor, k: torch.Tensor,
                   causal: bool, window: Optional[int]) -> tuple:
    """(operations, bytes) of one call of kernel ``kind`` ("fwd",
    "fwd_lse" or "bwd") at the wrapper's shapes: 4·B·Hq·D multiply-adds
    a (row, key) pair the mask keeps (the backward 2.5 times that), and
    each input read once and each output written once (q, k, v, o; lse
    in fp32 for the training kernels; the backward also reads o, dO and
    writes dq, dk, dv)."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    if not causal:
        pairs = Sq * Sk
    elif window is None or window >= Sq:
        pairs = Sq * (Sq + 1) // 2
    else:
        pairs = window * (window + 1) // 2 + (Sq - window) * window
    flops = 4.0 * B * Hq * D * pairs
    item = q.element_size()
    lse = B * Hq * Sq * 4
    if kind == "bwd":
        return (BWD_FLOP_FACTOR * flops,
                (4 * q.numel() + 4 * k.numel()) * item + lse)
    return flops, ((2 * q.numel() + 2 * k.numel()) * item
                   + (lse if kind == "fwd_lse" else 0))


def kernel_head_dim(D: int) -> int:
    """The head dim a head dim of D runs at on the card: up to 256 the
    instantiated one, D itself or the next one up; above 256 D itself (the
    wide kernels)."""
    if D > WIDE_ABOVE:
        return D
    return next(d for d in HEAD_DIMS if d >= D)


def _pad_d(t: torch.Tensor, Dp: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, Dp - t.shape[-1]))


def forward_padded(callee, q, k, v, scale: Optional[float] = None):
    """``callee(q, k, v, scale) -> (o, lse)`` at ``kernel_head_dim(D)``:
    q, k and v zero-padded to it, the scale of the unpadded D, o's padded
    columns dropped.  At an instantiated D, ``callee`` on the inputs as
    they are."""
    D = q.shape[-1]
    Dp = kernel_head_dim(D)
    if Dp == D:
        return callee(q, k, v, scale)
    o, lse = callee(*(_pad_d(t, Dp) for t in (q, k, v)), _scale(D, scale))
    return o[..., :D].contiguous(), lse


def backward_padded(callee, q, k, v, o, lse, do,
                    scale: Optional[float] = None):
    """``callee(q, k, v, o, lse, do, scale) -> (dq, dk, dv)`` at
    ``kernel_head_dim(D)``, as ``forward_padded``: delta = Σ_D o·dO is the
    same over the zero columns, and the padded columns of dq, dk and dv
    are dropped."""
    D = q.shape[-1]
    Dp = kernel_head_dim(D)
    if Dp == D:
        return callee(q, k, v, o, lse, do, scale)
    q, k, v, o, do = (_pad_d(t, Dp) for t in (q, k, v, o, do))
    grads = callee(q, k, v, o, lse, do, _scale(D, scale))
    return tuple(g[..., :D].contiguous() for g in grads)


# the H100's opt-in shared memory a block
SMEM_OPT_IN = 232448
# blocks a key tile's dk and dv columns are split over in the fp32 dk/dv
# kernel: two above D = 128
F32_DKV_SPLIT_ABOVE = 128
# the fp32 dk/dv kernel's largest step (its scores' registers beside dk
# and dv)
F32_DKV_STEP_CAP = 32


class F32Geometry(NamedTuple):
    """An fp32 kernel's launch at a head dim up to 256
    (``flash_attention.cu::flash_fwd_f32_kernel``,
    ``flash_attention_bwd.cu::flash_bwd_dq_f32_kernel`` and
    ``flash_bwd_dkv_f32_kernel``, chosen in the source by D alone):
    ``warps`` a block, 16 of its own rows each (q rows; keys for dk/dv),
    ``rows`` = 16·``warps``; ``step`` rows of the streamed operands (k and
    v; q and dO) a pipeline step; ``splits`` blocks a key tile's dk and dv
    columns are split over; ``smem_bytes`` a block."""
    warps: int
    rows: int
    step: int
    splits: int
    smem_bytes: int


def _f32_tile_smem(D: int, res: int, warps: int, step: int,
                   stats: int) -> int:
    """``flash_tc.cuh::f32_smem``: ``res`` resident tiles of 16·``warps``
    rows, two streamed tiles of ``step`` rows double-buffered, ``stats``
    floats a streamed row double-buffered; every row D + 4 floats."""
    return 4 * ((res * 16 * warps + 4 * step) * (D + 4) + 2 * stats * step)


def f32_geometry(kind: str, D: int) -> F32Geometry:
    """The geometry of fp32 kernel ``kind`` ("fwd", "dq" or "dkv") at head
    dim D (``flash_tc.cuh::f32_warps``, ``f32_step``): 8 warps where the
    resident tiles (q; q and dO; k and v) leave room for a 16-row step,
    else 4; the largest step of 64, 32, 16 rows that fits the block's
    shared memory beside them (the dk/dv kernel's at most
    ``F32_DKV_STEP_CAP``)."""
    res, stats = {"fwd": (1, 0), "dq": (2, 0), "dkv": (2, 2)}[kind]
    warps = 8 if _f32_tile_smem(D, res, 8, 16, stats) <= SMEM_OPT_IN else 4
    step = next((st for st in (64, 32) if _f32_tile_smem(
        D, res, warps, st, stats) <= SMEM_OPT_IN), 16)
    if kind == "dkv":
        step = min(step, F32_DKV_STEP_CAP)
    splits = 2 if kind == "dkv" and D > F32_DKV_SPLIT_ABOVE else 1
    return F32Geometry(warps, 16 * warps, step, splits,
                       _f32_tile_smem(D, res, warps, step, stats))


def _window_code(window: Optional[int]) -> int:
    """The kernels' window argument: 0 for none."""
    return 0 if window is None else int(window)


def _scale(D: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else float(1.0 / D ** 0.5)


def _forward_plain(q, k, v, causal, block_q, block_k, scale,
                   round_operands=False, window=None):
    """The forward's online softmax over (block_q × block_k) blocks, KV
    heads broadcast over their query-head group rather than copied; with
    ``window``, blocks wholly before every row's window are skipped.
    ``round_operands`` rounds p to q's dtype before its product with v, as
    the bf16 tensor-core kernel does (l still sums the unrounded p).
    Returns (o in q's dtype, lse (B, Hq, Sq) fp32)."""
    _check_args(q, k, v, causal)
    _check_window(causal, window)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = _scale(D, scale)
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    qf = q.float().reshape(B, Hkv, group, Sq, D)
    kf = k.float()[:, :, None]                       # (B, Hkv, 1, Sk, D)
    vf = v.float()[:, :, None]
    out = torch.empty(B, Hkv, group, Sq, D, dtype=torch.float32,
                      device=q.device)
    lse = torch.empty(B, Hkv, group, Sq, dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, Sq, bq):
        qb = qf[..., q0:q0 + bq, :]
        rows = torch.arange(q0, q0 + qb.shape[-2], device=q.device)
        m = torch.full((*qb.shape[:-1], 1), _NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, Sk, bk):
            if causal and k0 > q0 + bq - 1:          # wholly in the future
                break
            if window is not None and k0 + bk - 1 <= q0 - window:
                continue                             # wholly before it
            kb, vb = kf[..., k0:k0 + bk, :], vf[..., k0:k0 + bk, :]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if causal:
                s = torch.where(_band(rows, k0, kb.shape[-2], window), s,
                                _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            if round_operands:
                p = p.to(q.dtype).float()
            acc = acc * alpha + torch.matmul(p, vb)
            m = m_new
        safe = torch.where(l == 0.0, 1.0, l)
        out[..., q0:q0 + bq, :] = acc / safe
        lse[..., q0:q0 + bq] = (m + torch.log(safe))[..., 0]
    return out.reshape(B, Hq, Sq, D).to(q.dtype), lse.reshape(B, Hq, Sq)


def _band(rows: torch.Tensor, k0: int, n: int,
          window: Optional[int]) -> torch.Tensor:
    """(rows, n) mask of the keys k0..k0+n-1 each row counts: causal, and
    inside the window where one is given."""
    cols = torch.arange(k0, k0 + n, device=rows.device)[None, :]
    keep = cols <= rows[:, None]
    if window is not None:
        keep &= cols > rows[:, None] - window
    return keep


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, block_q: int = 128,
                          block_k: int = 128, scale: Optional[float] = None,
                          round_operands: bool = False,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain version of ``flash_attention``; ``round_operands`` models the
    bf16 kernel's rounding of p (``_forward_plain``)."""
    return _forward_plain(q, k, v, causal, block_q, block_k, scale,
                          round_operands, window)[0]


def flash_attention_fwd_lse_plain(q, k, v, *, causal: bool = True,
                                  block_q: int = 128, block_k: int = 128,
                                  scale: Optional[float] = None,
                                  round_operands: bool = False,
                                  window: Optional[int] = None):
    """Plain version of ``flash_attention_fwd_lse``: (o, lse)."""
    return _forward_plain(q, k, v, causal, block_q, block_k, scale,
                          round_operands, window)


# the bf16 wide forward (flash_attention_wide.cu::wide_fwd_tc_kernel): its
# instantiations, in 16-column pairs of o a warp holds (a piece of D is 32
# columns a pair: the two warps of a row group split it), and the widest
# piece, whose q, k and v tiles and 8 warps' partial scores fill the
# 232,448 bytes a block may have on the H100
WIDE_TC_PAIRS = (9, 10, 12, 16)
WIDE_PIECE_COLS = 32 * WIDE_TC_PAIRS[-1]


class WideGeometry(NamedTuple):
    """The bf16 wide forward's launch at head dim D: ``pieces`` blocks a
    q-tile, each owning ``piece_cols`` columns of o (zero past D) and
    streaming q and k through the same width when there are several;
    ``pairs`` the instantiation (``piece_cols`` = 32·``pairs``);
    ``smem_bytes`` a block."""
    pieces: int
    piece_cols: int
    pairs: int
    smem_bytes: int


def wide_fwd_geometry(D: int) -> WideGeometry:
    """The geometry ``flash_attention_wide_fwd_tc`` takes at head dim D:
    the fewest pieces of at most ``WIDE_PIECE_COLS`` columns — one up to D
    = 512, so the scores run once per tile pair — each of the narrowest
    instantiated width that covers D with them (``mma.m16n8k16`` takes 16
    columns a step, and each warp of a row group's pair half of a piece;
    the columns past D are zero).  A block stages q, k and v (64 rows of
    the piece's width plus 8 columns of padding, bf16) beside the 8 warps'
    partial score tiles (16 × 64 fp32 each)."""
    pieces = -(-D // WIDE_PIECE_COLS)
    pairs = next(p for p in WIDE_TC_PAIRS if pieces * 32 * p >= D)
    smem = 3 * 2 * 64 * (32 * pairs + 8) + 4 * 8 * 16 * 64
    return WideGeometry(pieces, 32 * pairs, pairs, smem)


class WideBwdGeometry(NamedTuple):
    """The bf16 wide backward's launch at head dim D (both kernels of
    ``flash_attention_wide_bwd_tc``): ``pairs`` the instantiation, the
    score product running over pieces of 32·``pairs`` columns (held whole
    in shared memory up to ``WIDE_BWD_RESIDENT`` pairs, streamed above);
    ``ds_terms`` the bf16 terms ds is carried in; the dq kernel's
    ``dq_pieces`` blocks a q-tile, each owning ``dq_cols`` = 32·``pairs``
    columns of dq; the dk/dv kernel's ``dkv_pieces`` blocks a k-tile,
    each owning ``dkv_cols`` = 16·``pairs`` columns of dk and dv and
    recomputing the scores; the bytes a block of each kernel."""
    pairs: int
    ds_terms: int
    dq_pieces: int
    dq_cols: int
    dkv_pieces: int
    dkv_cols: int
    dq_smem: int
    dkv_smem: int


# the widest instantiation of the bf16 wide backward whose q, dO, k and v
# tiles fit a block whole (384 columns)
WIDE_BWD_RESIDENT = 12


def wide_bwd_geometry(D: int) -> WideBwdGeometry:
    """The geometry ``flash_attention_wide_bwd_tc`` takes at head dim D:
    the narrowest instantiation whose score piece covers D up to 384
    columns (q, dO, k and v held whole: 4 tiles of 64 rows × (32·pairs +
    8) bf16), 16 pairs above (3 tiles: the dq kernel's k and v taking
    turns in one, the dk/dv kernel's q and dO).  dq: one piece up
    to D = 512, so its scores run once per tile pair; dk/dv: pieces of half
    the score width, two up to 512 and ceil(D / 256) above, their
    accumulators 2·16·pairs fp32 a warp row.  ds is rounded to one bf16
    term, as the other bf16 kernels do, where D is a multiple of 8; where
    it is not (rows not 16-byte aligned, where the library has no fused
    bf16 backward and computes in fp32) it is carried as two, hi + lo,
    each a product into dq and dk.  Beside the tiles each warp has a slot
    of bf16 fragments to trade with its partner (1 KB a term of ds in the
    dq kernel; 1 KB for p and one a term of ds in the dk/dv kernel, which
    also stages the q-tile's lse and delta)."""
    pairs = next((p for p in WIDE_TC_PAIRS if p <= WIDE_BWD_RESIDENT
                  and 32 * p >= D), WIDE_TC_PAIRS[-1])
    terms = 1 if D % 8 == 0 else 2
    tile = 2 * 64 * (32 * pairs + 8)
    resident = pairs <= WIDE_BWD_RESIDENT
    return WideBwdGeometry(
        pairs, terms, -(-D // (32 * pairs)), 32 * pairs,
        -(-D // (16 * pairs)), 16 * pairs,
        (4 if resident else 3) * tile + terms * 8 * 1024,
        (4 if resident else 3) * tile + (1 + terms) * 8 * 1024 + 2 * 64 * 4)


# the fp32 wide kernels (flash_attention_wide.cu::wide_fwd_f32_kernel,
# wide_dq_f32_kernel, wide_dkv_f32_kernel): their instantiations, in
# float4 column groups of the output a thread holds (a piece is 64 columns
# a group), and the widest piece, whose accumulator (128 fp32 of o, dq, dv
# or dk at 8 groups) fills a thread's registers beside the scores
WIDE_F32_GROUPS = (5, 6, 8)
WIDE_F32_PIECE_COLS = 64 * WIDE_F32_GROUPS[-1]


class WideF32Geometry(NamedTuple):
    """An fp32 wide launch at head dim D (``flash_attention_wide_fwd``,
    ``flash_attention_wide_bwd``): ``pieces`` blocks a tile for each
    output (o; dq; dv and dk), each owning ``piece_cols`` = 64·``groups``
    columns of it (zero past D); with 2 to 8 pieces the blocks of a tile
    form a cluster, each running the score products over its own columns
    and adding the others' partial scores, so they run once a tile pair
    (above 8, each block runs them over all of D); ``groups`` the
    instantiation; ``smem_bytes`` a block."""
    pieces: int
    piece_cols: int
    groups: int
    smem_bytes: int


def _f32_pieces(D: int) -> tuple:
    """The fewest pieces of at most ``WIDE_F32_PIECE_COLS`` columns (a
    thread's registers hold one piece of an output: one piece up to D =
    512), each of the narrowest instantiated width that covers D with
    them."""
    pieces = -(-D // WIDE_F32_PIECE_COLS)
    groups = next(g for g in WIDE_F32_GROUPS if pieces * 64 * g >= D)
    return pieces, 64 * groups, groups


def _f32_smem(groups: int, stats: int) -> int:
    """Bytes a block of an fp32 wide kernel: a ring of four slots, each
    the larger of a score step's operand chunks (four 64 × 16 tiles, each
    row 4 floats longer) and 16 rows of the accumulating operand's piece
    of 64·``groups`` columns (each row 4 floats longer); the two halves'
    64 × 72 score tiles; ``stats`` 64-float row statistics."""
    slot = max(4 * 64 * (16 + 4), 16 * (64 * groups + 4))
    return 4 * (4 * slot + 2 * 64 * 72 + stats * 64)


def wide_f32_fwd_geometry(D: int) -> WideF32Geometry:
    """The geometry ``flash_attention_wide_fwd`` takes at head dim D
    (``_f32_pieces``).  A block's ring carries 32 columns of q and k a
    score step and 16 rows of v's piece an accumulating step; beside it
    the two halves' partial scores and the running max, sum and
    rescale."""
    pieces, cols, groups = _f32_pieces(D)
    return WideF32Geometry(pieces, cols, groups, _f32_smem(groups, 3))


def wide_f32_bwd_geometry(D: int) -> WideF32Geometry:
    """The geometry ``flash_attention_wide_bwd`` takes at head dim D: the
    forward's pieces for dq, dv and dk alike (the dk/dv kernel's grid
    holds ``pieces`` blocks of dv and as many of dk a k-tile, so a thread
    holds one accumulator).  A block's ring carries 16 columns of q, k, dO
    and v a score step (the dv blocks' 32 of k and q) and 16 rows of its
    accumulating operand's piece (k, dO or q) an accumulating step;
    beside it the two halves' score tiles and the rows' lse and
    delta."""
    pieces, cols, groups = _f32_pieces(D)
    return WideF32Geometry(pieces, cols, groups, _f32_smem(groups, 2))


def _launch_forward(q, k, v, causal, scale, with_lse: bool, window):
    _check_args(q, k, v, causal)
    _check_window(causal, window)
    _check_kernel_args(q, k, v)
    B, Hq, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device) \
        if with_lse else None
    if o.numel() == 0 or fake_mode(q):
        return o, lse
    lib = cudalib.build()
    args = (cudalib.ptr(q), cudalib.ptr(k), cudalib.ptr(v), cudalib.ptr(o),
            cudalib.ptr(lse))
    sizes = (B, Hq, k.shape[1], Sq, k.shape[2], D, _scale(D, scale),
             int(causal), _window_code(window))
    if D <= WIDE_ABOVE:
        err = lib.flash_attention_fwd(*args, _DTYPE_CODE[q.dtype], *sizes,
                                      cudalib.stream(q.device))
    elif q.dtype == torch.bfloat16:
        err = lib.flash_attention_wide_fwd_tc(
            *args, *sizes, *wide_fwd_geometry(D), cudalib.stream(q.device))
    else:
        err = lib.flash_attention_wide_fwd(
            *args, _DTYPE_CODE[q.dtype], *sizes, *wide_f32_fwd_geometry(D),
            cudalib.stream(q.device))
    cudalib.check(err)
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), one dtype (fp32 or bf16),
    Sk = Sq where ``causal``.  Returns (B, Hq, Sq, D) in q's dtype."""
    refuse_grad("flash_attention", _GRAD_HINT, q, k, v)
    fake = fake_mode(q)
    if not fake and plain_mode(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window)
    _check_args(q, k, v, causal)
    o, _ = forward_padded(
        lambda q, k, v, scale: _launch_forward(q, k, v, causal, scale, False,
                                               window), q, k, v, scale)
    if fake:
        report_kernel("flash_attention",
                      *attention_cost("fwd", q, k, causal, window))
    else:
        flash_attention.launches += 1
    return o


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            scale: Optional[float] = None,
                            window: Optional[int] = None):
    """The training forward.  q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), one
    dtype (fp32 or bf16), Sk = Sq where ``causal``.  Returns (o (B, Hq,
    Sq, D) in q's dtype, lse (B, Hq, Sq) fp32)."""
    refuse_grad("flash_attention_fwd_lse", _GRAD_HINT, q, k, v)
    fake = fake_mode(q)
    if not fake and plain_mode(q):
        return flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                             scale=scale, window=window)
    _check_args(q, k, v, causal)
    out = forward_padded(
        lambda q, k, v, scale: _launch_forward(q, k, v, causal, scale, True,
                                               window), q, k, v, scale)
    if fake:
        report_kernel("flash_attention_fwd_lse",
                      *attention_cost("fwd_lse", q, k, causal, window))
    else:
        flash_attention_fwd_lse.launches += 1
    return out


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = Σ_D o·dO in fp32, (B, Hq, S): the reference computes it
    outside its backward kernels, and so do both versions here.  The
    product of two converted values is exact in fp32, so multiplying into
    a fresh fp32 copy of o gives the same sums with one pass less."""
    return o.to(torch.float32, copy=True).mul_(do).sum(dim=-1)


def group_sum(x_h: torch.Tensor, n_kv: int, dtype: torch.dtype
              ) -> torch.Tensor:
    """Per-query-head dk or dv (B, Hq, Sk, D), already rounded to q's dtype,
    summed over each KV head's query-head group in a fixed order (fp32,
    head 0 first) and rounded once to ``dtype``: (B, Hkv, Sk, D)."""
    B, Hq, S, D = x_h.shape
    xg = x_h.reshape(B, n_kv, Hq // n_kv, S, D)
    # heads 0 and 1 in one pass: a sum of two rounds once in either order
    acc = xg[:, :, :2].sum(dim=2, dtype=torch.float32)
    for g in range(2, Hq // n_kv):
        acc.add_(xg[:, :, g])         # converted exactly, added in fp32
    return acc.to(dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              block_q: int = 128, block_k: int = 128,
                              scale: Optional[float] = None,
                              round_operands: bool = False,
                              window: Optional[int] = None):
    """Plain version of ``flash_attention_bwd``: (dq, dk, dv)."""
    dq, dk_h, dv_h = flash_attention_bwd_heads_plain(
        q, k, v, o, lse, do, causal=causal, block_q=block_q,
        block_k=block_k, scale=scale, round_operands=round_operands,
        window=window)
    Hkv = k.shape[1]
    return dq, group_sum(dk_h, Hkv, k.dtype), group_sum(dv_h, Hkv, v.dtype)


def flash_attention_bwd_heads_plain(q, k, v, o, lse, do, *,
                                    causal: bool = True, block_q: int = 128,
                                    block_k: int = 128,
                                    scale: Optional[float] = None,
                                    round_operands: bool = False,
                                    window: Optional[int] = None):
    """The backward before the group sum: (dq (B, Hq, Sq, D), dk_h, dv_h
    (B, Hq, Sk, D)) in q's dtype.  Per (q-block, k-block) pair: p =
    exp(s − lse) from the masked scores, dp = dO·vᵀ, ds = p·(dp −
    delta)·scale; dq += ds·k,
    dv_h += pᵀ·dO, dk_h += dsᵀ·q, accumulated in fp32 over ascending
    blocks.  ``round_operands`` models the bf16 tensor-core kernels: p and
    the unscaled p·(dp − delta) round to q's dtype before their products,
    and the scale multiplies the sums of dq and dk_h."""
    _check_bwd_args(q, k, v, o, lse, do, causal)
    _check_window(causal, window)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = _scale(D, scale)
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    shape5 = (B, Hkv, group, Sq, D)
    kshape5 = (B, Hkv, group, Sk, D)
    qf = q.float().reshape(shape5)
    dof = do.float().reshape(shape5)
    kf = k.float()[:, :, None]                       # (B, Hkv, 1, Sk, D)
    vf = v.float()[:, :, None]
    lsef = lse.float().reshape(B, Hkv, group, Sq, 1)
    delta = bwd_delta(o, do).reshape(B, Hkv, group, Sq, 1)
    dq = torch.empty(shape5, dtype=torch.float32, device=q.device)
    dk_h = torch.zeros(kshape5, dtype=torch.float32, device=q.device)
    dv_h = torch.zeros(kshape5, dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, bq):
        qb, dob = qf[..., q0:q0 + bq, :], dof[..., q0:q0 + bq, :]
        lb, db = lsef[..., q0:q0 + bq, :], delta[..., q0:q0 + bq, :]
        rows = torch.arange(q0, q0 + qb.shape[-2], device=q.device)
        acc = torch.zeros_like(qb)
        for k0 in range(0, Sk, bk):
            if causal and k0 > q0 + bq - 1:          # wholly in the future
                break
            if window is not None and k0 + bk - 1 <= q0 - window:
                continue                             # wholly before it
            kb, vb = kf[..., k0:k0 + bk, :], vf[..., k0:k0 + bk, :]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if causal:
                s = torch.where(_band(rows, k0, kb.shape[-2], window), s,
                                _NEG_INF)
            p = torch.exp(s - lb)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - db)
            if round_operands:
                p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
            else:
                ds = ds * scale
            acc = acc + torch.matmul(ds, kb)
            dv_h[..., k0:k0 + bk, :] += torch.matmul(p.transpose(-1, -2), dob)
            dk_h[..., k0:k0 + bk, :] += torch.matmul(ds.transpose(-1, -2), qb)
        dq[..., q0:q0 + bq, :] = acc * scale if round_operands else acc
    if round_operands:
        dk_h = dk_h * scale
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype),
            *(t.reshape(B, Hq, Sk, D).to(q.dtype) for t in (dk_h, dv_h)))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None,
                        window: Optional[int] = None):
    """The backward.  q, o, do: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), one
    dtype (fp32 or bf16), Sk = Sq where ``causal``; lse (B, Hq, Sq) fp32
    from ``flash_attention_fwd_lse``.  Returns (dq (B, Hq, Sq, D), dk, dv
    (B, Hkv, Sk, D)) in the inputs' dtype."""
    fake = fake_mode(q)
    if not fake and plain_mode(q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale, window=window)
    _check_bwd_args(q, k, v, o, lse, do, causal)
    out = backward_padded(
        lambda *args: _launch_backward(*args, causal, window),
        q, k, v, o, lse, do, scale)
    if fake:
        report_kernel("flash_attention_bwd",
                      *attention_cost("bwd", q, k, causal, window))
    else:
        flash_attention_bwd.launches += 1
    return out


def _launch_backward(q, k, v, o, lse, do, scale, causal, window):
    _check_window(causal, window)
    _check_kernel_args(q, k, v, o, do)
    if lse.dtype != torch.float32 or lse.device != q.device or \
            not lse.is_contiguous():
        raise ValueError("lse must be a contiguous fp32 tensor on q's device")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    dkv_h = torch.empty((2, B, Hq, Sk, D), dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    delta = bwd_delta(o, do)
    if not fake_mode(q):
        lib = cudalib.build()
        args = (cudalib.ptr(q), cudalib.ptr(k), cudalib.ptr(v),
                cudalib.ptr(do), cudalib.ptr(lse), cudalib.ptr(delta),
                cudalib.ptr(dq), cudalib.ptr(dkv_h[0]),
                cudalib.ptr(dkv_h[1]))
        sizes = (B, Hq, Hkv, Sq, Sk, D, _scale(D, scale), int(causal),
                 _window_code(window))
        if D <= WIDE_ABOVE:
            err = lib.flash_attention_bwd(*args, _DTYPE_CODE[q.dtype],
                                          *sizes, cudalib.stream(q.device))
        elif q.dtype == torch.bfloat16:
            err = lib.flash_attention_wide_bwd_tc(
                *args, *sizes, *wide_bwd_geometry(D),
                cudalib.stream(q.device))
        else:
            err = lib.flash_attention_wide_bwd(
                *args, _DTYPE_CODE[q.dtype], *sizes,
                *wide_f32_bwd_geometry(D), cudalib.stream(q.device))
        cudalib.check(err)
    # dk and dv (k and v share q's dtype) summed in one pass each
    dk, dv = group_sum(dkv_h.view(2 * B, Hq, Sk, D), Hkv, k.dtype).view(
        2, B, Hkv, Sk, D)
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_fwd_lse.launches = 0
flash_attention_bwd.launches = 0
