"""The PrimaryCaps convolution (9×9, stride 2, VALID, with bias) as an
implicit GEMM in split TF32 on Hopper's tensor cores: the launch wrapper,
its geometry and its plain PyTorch version.

It replaces no kernel of the JAX package, which leaves this convolution to
XLA (``repro/core/capsule_layers.py::primary_caps_forward``); it was added
because the convolution takes most of the serving path's device time, and
in fp32 cuDNN runs it on the CUDA cores.  The CUDA source is
``repro_torch/csrc/caps_conv.cu`` (its header gives the design), built with
every other kernel into one library by ``repro_torch.kernels.cudalib``.  As
a GEMM, M = B·H_o·W_o output positions, N = C_out, K = k·k·C_in, the
activation read in NHWC with C_in contiguous, the weight relaid to
(C_out, kh, kw, C_in) and split into TF32 big and small parts once a call.

``caps_conv`` runs its plain version (``F.conv2d`` in fp32) for a CPU
tensor and launches the kernel for a tensor on a Hopper card
(``repro_torch.kernels.plain_mode`` raises for anything else);
``caps_conv.launches`` counts the calls that launched it.  On a fake
tensor (the dry run's) it allocates what a launch allocates and reports
the launch's operations and bytes.  It records no gradient: the encoder
calls it through ``ops.caps_conv``, whose autograd Function gives it
cuDNN's backward.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import (cudalib, fake_mode, plain_mode, refuse_grad,
                                 report_kernel)

# csrc/caps_conv.cu's launch constants: 8 warps (4 along M × 2 along N),
# 128 rows a block, stages of 32 K terms (one tap, 32 channels) in a ring of
# 4, at least 8 stages a split of K, at most 256 taps; the H100's 132 SMs
WARPS_N = 2
BLOCK_M = 128
BLOCK_K = 32
STAGES = 4
MIN_STAGES_PER_SPLIT = 8
MAX_TAPS = 256
SMS = 132
# a split of K fills the SMs' waves of blocks to at least this share, where
# some split does
WAVE_FILL = 0.95
_GRAD_HINT = ("kernels.caps_conv.ops.caps_conv records the gradient "
              "(ops.CapsConvFunction)")


class CapsConvGeometry(NamedTuple):
    """The launch at one shape: the GEMM's ``m``, ``n``, ``k_terms``; the
    output's ``out_h``, ``out_w``; ``n_tiles`` 8-column tiles a warp (the
    instantiation: 8 where C_out is a multiple of 128, else 4), so
    ``block_n`` columns a block; ``grid`` (row blocks, column blocks,
    splits of K), each split ``stages_per_split`` stages of 32 K terms;
    ``smem_bytes`` of the ring a block."""
    m: int
    n: int
    k_terms: int
    out_h: int
    out_w: int
    n_tiles: int
    block_n: int
    grid: tuple
    splits: int
    stages_per_split: int
    smem_bytes: int


def _wave_fill(blocks: int) -> float:
    """The share of the SMs' slots that ``blocks`` fill in whole waves of
    one block an SM."""
    return blocks / (-(-blocks // SMS) * SMS)


# a serving path asks for the same shape on every call
@functools.lru_cache(maxsize=None)
def caps_conv_geometry(B: int, H_in: int, W_in: int, C_in: int, C_out: int,
                       k: int, stride: int) -> CapsConvGeometry:
    """The kernel's tiles, split of K and shared memory for a convolution of
    a (B, H_in, W_in, C_in) activation by k × k at ``stride``, VALID, to
    C_out channels.  The split of K is the smallest divisor of the stage
    count (at least ``MIN_STAGES_PER_SPLIT`` stages each) whose blocks fill
    their waves to ``WAVE_FILL``; where none does, the one that fills them
    most, the smaller on a tie.  Raises ValueError for a
    shape the kernel does not take: C_in not a multiple of 32, C_out not
    of 64, more than 256 taps, a kernel larger than the image."""
    if min(B, k, stride) < 1 or H_in < k or W_in < k:
        raise ValueError(f"caps_conv: no output for B={B}, {H_in}×{W_in}, "
                         f"k={k}, stride={stride}")
    if C_in < BLOCK_K or C_in % BLOCK_K or C_out < 64 or C_out % 64:
        raise ValueError(f"caps_conv takes C_in a multiple of {BLOCK_K} and "
                         f"C_out of 64; got {C_in} and {C_out}")
    if k * k > MAX_TAPS:
        raise ValueError(f"caps_conv takes at most {MAX_TAPS} taps; got "
                         f"{k}×{k}")
    out_h = (H_in - k) // stride + 1
    out_w = (W_in - k) // stride + 1
    m, n, k_terms = B * out_h * out_w, C_out, k * k * C_in
    n_tiles = 8 if n % 128 == 0 else 4
    block_n = WARPS_N * 8 * n_tiles
    m_blocks, n_blocks = -(-m // BLOCK_M), n // block_n
    stages = k_terms // BLOCK_K
    tiles = m_blocks * n_blocks
    divisors = [s for s in range(1, stages + 1)
                if stages % s == 0 and stages // s >= MIN_STAGES_PER_SPLIT]
    splits = next((s for s in divisors
                   if _wave_fill(tiles * s) >= WAVE_FILL),
                  min(divisors, key=lambda s: (-_wave_fill(tiles * s), s)))
    if max(B * H_in * W_in * C_in, m * n * splits) >= 2 ** 31:
        raise ValueError(f"caps_conv: B={B} is past the kernel's 32-bit "
                         "offsets")
    smem = 4 * STAGES * BLOCK_K * (BLOCK_M + 2 * block_n)
    return CapsConvGeometry(m, n, k_terms, out_h, out_w, n_tiles, block_n,
                            (m_blocks, n_blocks, splits), splits,
                            stages // splits, smem)


def caps_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """Plain version: ``F.conv2d`` in fp32 on the NHWC activation, the
    computation the encoder made before the kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride)
    return y.permute(0, 2, 3, 1)


def caps_conv_cost(geo: CapsConvGeometry, x: torch.Tensor,
                   w: torch.Tensor) -> tuple:
    """(operations, bytes) of the bound: 2·M·N·K, the activation, weight
    and bias read once and the output written once, fp32."""
    return (2.0 * geo.m * geo.n * geo.k_terms,
            4.0 * (x.numel() + w.numel() + geo.n + geo.m * geo.n))


def _check_kernel_args(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       stride: int) -> CapsConvGeometry:
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != w.shape[3] \
            or w.shape[1] != x.shape[3] or b.shape != (w.shape[0],):
        raise ValueError(f"caps_conv takes x (B, H, W, C_in), w (C_out, "
                         f"C_in, k, k), b (C_out,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if any(t.dtype != torch.float32 for t in (x, w, b)):
        raise ValueError("caps_conv runs in fp32")
    if any(t.device != x.device for t in (w, b)):
        raise ValueError("caps_conv's tensors lie on different devices")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("caps_conv takes a contiguous NHWC activation and "
                         "a contiguous weight and bias")
    B, H, W, C = x.shape
    return caps_conv_geometry(B, H, W, C, w.shape[0], w.shape[2], stride)


def _scratch(geo: CapsConvGeometry, x: torch.Tensor):
    """The launch's buffers: the weight's two TF32 planes and, beyond one
    split, the partial sums (one allocation), and the output."""
    planes = 2 * geo.n * geo.k_terms
    partial = geo.splits * geo.m * geo.n if geo.splits > 1 else 0
    scratch = torch.empty(planes + partial, device=x.device)
    out = torch.empty((x.shape[0], geo.out_h, geo.out_w, geo.n),
                      device=x.device)
    return scratch[:planes], scratch[planes:] if partial else None, out


def caps_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              stride: int) -> torch.Tensor:
    """x (B, H, W, C_in) NHWC, w (C_out, C_in, k, k), b (C_out,), fp32 ->
    (B, H_o, W_o, C_out): the convolution at ``stride``, VALID, plus the
    bias (contiguous from the kernel, a permuted view from the plain
    version)."""
    refuse_grad("caps_conv", _GRAD_HINT, x, w, b)
    if fake_mode(x):
        geo = _check_kernel_args(x, w, b, stride)
        *_, out = _scratch(geo, x)
        report_kernel("caps_conv", *caps_conv_cost(geo, x, w))
        return out
    if plain_mode(x):
        return caps_conv_plain(x, w, b, stride)
    geo = _check_kernel_args(x, w, b, stride)
    if any(t.data_ptr() % 16 for t in (x, w, b)):
        raise ValueError("caps_conv takes 16-byte aligned tensors")
    lib = cudalib.build()
    wsplit, partial, out = _scratch(geo, x)
    k = w.shape[2]
    err = lib.caps_conv_forward(
        cudalib.ptr(x), cudalib.ptr(w), cudalib.ptr(b), cudalib.ptr(wsplit),
        cudalib.ptr(partial), cudalib.ptr(out), *x.shape, geo.n, k, stride,
        geo.n_tiles, geo.splits, geo.smem_bytes, cudalib.stream(x.device))
    cudalib.check(err)
    caps_conv.launches += 1
    return out


caps_conv.launches = 0

