"""Mamba-1 (falcon-mamba) blocks.

Port of the Mamba-1 half of the JAX package's ``repro/models/ssm.py``.
A full-sequence block runs the selective scan along the route its caller
names (``layers.ROUTES``):

  "kernels"         prefill: the hand-written scan kernel
                    (``kernels.ssm_scan.ops.scan``), forward only, which
                    computes the function of the reference's
                    ``_chunked_selective_scan`` plus D·x and returns the
                    final state the decode path starts from;
  "train", "plain"  ``_chunked_selective_scan``, the reference's pure
                    chunked scan in PyTorch: differentiable, and free of
                    any hand-written kernel.  The reference trains through
                    it too (its Pallas scan has no backward).

Decode is the single-step recurrence in plain PyTorch, as in the
reference.  Mamba-2 (zamba2's SSD form, ``version=2``) comes with the
hybrid family: it raises, naming that slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import slices
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.layers import check_route, init_linear


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int
    d_state: int
    dt_rank: int
    conv_kernel: int = 4
    version: int = 1          # 1 = mamba1 (per-channel dt), 2 = mamba2


def _require_mamba1(cfg: SSMConfig) -> None:
    if cfg.version != 1:
        raise slices.not_ported("Mamba-2 (the SSD recurrence)",
                                slices.LM_FAMILIES)


def init_mamba(gen: torch.Generator, cfg: SSMConfig, dtype=torch.bfloat16,
               device="cuda") -> dict:
    _require_mamba1(cfg)
    conv_w = torch.randn(cfg.conv_kernel, cfg.d_inner, generator=gen,
                         device=device) * 0.1
    states = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                          device=device)
    return {
        "in_proj": init_linear(gen, cfg.d_model, 2 * cfg.d_inner, dtype,
                               device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(cfg.d_inner, dtype=dtype, device=device),
        "out_proj": init_linear(gen, cfg.d_inner, cfg.d_model, dtype, device),
        # x -> (dt_low, B, C)
        "x_proj": init_linear(gen, cfg.d_inner,
                              cfg.dt_rank + 2 * cfg.d_state, dtype, device),
        "dt_proj": init_linear(gen, cfg.dt_rank, cfg.d_inner, dtype, device),
        "dt_bias": torch.zeros(cfg.d_inner, device=device),
        "A_log": torch.log(states).repeat(cfg.d_inner, 1),
        "D": torch.ones(cfg.d_inner, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: (B, T, D); w: (K, D).  With ``state``
    (B, K-1, D) prepended (decode), the history; returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[0], K - 1, x.shape[2], dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, T+K-1, D)
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[i][None, None] for i in range(K))
    return y + b[None, None], xp[:, -(K - 1):]


def _pick_chunk(T: int, preferred: int) -> int:
    """Largest divisor of T that is <= preferred."""
    c = min(preferred, T)
    while T % c:
        c -= 1
    return c


def _inclusive_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The b half of the inclusive scan along axis 1 of the pairs (a_t, b_t)
    under the reference's ``combine``: (a1, b1) ∘ (a2, b2) = (a1·a2,
    a2·b1 + b2) — that is, h_t = a_t·h_{t−1} + b_t.  Log-step (Hillis–
    Steele) doubling: ⌈log2 c⌉ rounds of whole-chunk operations, where the
    reference's ``lax.associative_scan`` takes a work-efficient order of the
    same products (the two agree to round-off)."""
    n = a.shape[1]
    s = 1
    while s < n:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        if 2 * s < n:
            a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
        s *= 2
    return b


def _chunked_selective_scan(dt: torch.Tensor, u: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor,
                            A: torch.Tensor, h0: torch.Tensor, chunk: int):
    """Chunked scan of  h_t = exp(dt_t·A) ⊙ h_{t−1} + (u_t ⊗ B_t);
    y_t = <h_t, C_t>  (the reference's ``_chunked_selective_scan``, Mamba-1
    form) without a (B, T, D, N) tensor: the chunks run in order carrying
    h, and within a chunk ``_inclusive_scan`` runs on (B, chunk, D, N)
    tensors, h folded into the chunk's first element.

    dt, u: (B, T, D) fp32 (u = dt·x); Bm, Cm: (B, T, N) fp32; A: (D, N);
    h0: (B, D, N).  Returns (y (B, T, D) fp32, h_T).  Differentiable; the
    decay form that Mamba-2 passes instead of dt comes with slice 11."""
    T = u.shape[1]
    ys = []
    h = h0
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        a_c = torch.exp(dt[:, sl, :, None] * A[None, None])    # (B,c,D,N)
        bmat = u[:, sl, :, None] * Bm[:, sl, None, :]           # (B,c,D,N)
        bmat = torch.cat([bmat[:, :1] + a_c[:, :1] * h[:, None],
                          bmat[:, 1:]], dim=1)
        hs = _inclusive_scan(a_c, bmat)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cm[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def _ssm_core_m1(params, x: torch.Tensor, cfg: SSMConfig,
                 h0: Optional[torch.Tensor], *, route: str = "kernels",
                 chunk: int = 16):
    """Mamba-1 selective SSM over a full sequence.  x: (B, T, d_inner) ->
    (y in x's dtype, h_T (B, d_inner, d_state) fp32).  ``chunk`` is the
    chunked scan's preferred chunk (the kernel takes none)."""
    check_route(route)
    N = cfg.d_state
    proj = x @ params["x_proj"]
    dt_low, Bm, Cm = torch.split(proj, [cfg.dt_rank, N, N], dim=-1)
    dt = F.softplus((dt_low @ params["dt_proj"]).float()
                    + params["dt_bias"])                      # (B,T,Din)
    A = -torch.exp(params["A_log"])                           # (Din,N)
    if route == "kernels":
        return scan_ops.scan(x, dt, A, Bm.contiguous(), Cm.contiguous(),
                             params["D"], h0=h0)
    B, T, Din = x.shape
    xf = x.float()
    if h0 is None:
        h0 = torch.zeros(B, Din, N, device=x.device)
    y, h_last = _chunked_selective_scan(dt, dt * xf, Bm.float(), Cm.float(),
                                        A, h0, _pick_chunk(T, chunk))
    y = y + params["D"][None, None] * xf
    return y.to(x.dtype), h_last


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_inner)
    ssm: torch.Tensor    # (B, d_inner, d_state) fp32


def init_ssm_state(batch: int, cfg: SSMConfig, dtype=torch.bfloat16,
                   device="cuda") -> SSMState:
    return SSMState(
        conv=torch.zeros(batch, cfg.conv_kernel - 1, cfg.d_inner,
                         dtype=dtype, device=device),
        ssm=torch.zeros(batch, cfg.d_inner, cfg.d_state, device=device))


def mamba_forward(params, x: torch.Tensor, cfg: SSMConfig, *,
                  chunk: int = 16, state: Optional[SSMState] = None,
                  route: str = "kernels"):
    """Full-sequence mamba block along ``route`` (module docstring).
    x: (B, T, d_model) -> (y, final SSMState)."""
    _require_mamba1(cfg)
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                  state.conv if state is not None else None)
    xc = F.silu(xc.float()).to(x.dtype)
    y, h_last = _ssm_core_m1(params, xc, cfg,
                             state.ssm if state is not None else None,
                             route=route, chunk=chunk)
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ params["out_proj"], SSMState(conv=conv_state, ssm=h_last)


def mamba_decode_step(params, x: torch.Tensor, state: SSMState,
                      cfg: SSMConfig):
    """Single-token recurrence.  x: (B, 1, d_model) -> (y (B, 1, d_model),
    new SSMState)."""
    _require_mamba1(cfg)
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)         # (B,1,Din)
    xc, conv_state = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                  state.conv)
    xs = F.silu(xc.float()).to(x.dtype)[:, 0]                 # (B,Din)
    proj = xs @ params["x_proj"]
    dt_low, Bm, Cm = torch.split(
        proj, [cfg.dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus((dt_low @ params["dt_proj"]).float()
                    + params["dt_bias"])                      # (B,Din)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt[..., None] * A[None])                    # (B,Din,N)
    bmat = (dt * xs.float())[..., None] * Bm.float()[:, None, :]
    h = a * state.ssm + bmat
    y = torch.einsum("bdn,bn->bd", h, Cm.float())
    y = y + params["D"][None] * xs.float()
    y = (y.to(x.dtype) * F.silu(z[:, 0].float()).to(x.dtype))[:, None]
    return y @ params["out_proj"], SSMState(conv=conv_state, ssm=h)
