"""Mamba-1 (falcon-mamba) blocks.

Port of the Mamba-1 half of the JAX package's ``repro/models/ssm.py``.
Prefill runs the selective scan through the hand-written kernel
(``kernels.ssm_scan.ops.scan``), which computes the function of the
reference's pure-JAX ``_chunked_selective_scan`` plus D·x on the same
inputs, and returns the final state the decode path starts from.  Decode
is the single-step recurrence in plain PyTorch, as in the reference.

Mamba-2 (zamba2's SSD form, ``version=2``) has no kernel of its own and
comes with the hybrid family: it raises, naming that slice.  The
reference's ``chunk`` arguments and ``_pick_chunk`` have no counterpart:
the scan's entry point keeps its own chunk rule, which on the card is only
a staging tile.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import slices
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.layers import init_linear


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


def _ssm_core_m1(params, x: torch.Tensor, cfg: SSMConfig,
                 h0: Optional[torch.Tensor]):
    """Mamba-1 selective SSM over a full sequence.  x: (B, T, d_inner) ->
    (y in x's dtype, h_T (B, d_inner, d_state) fp32)."""
    N = cfg.d_state
    proj = x @ params["x_proj"]
    dt_low, Bm, Cm = torch.split(proj, [cfg.dt_rank, N, N], dim=-1)
    dt = F.softplus((dt_low @ params["dt_proj"]).float()
                    + params["dt_bias"])                      # (B,T,Din)
    A = -torch.exp(params["A_log"])                           # (Din,N)
    return scan_ops.scan(x, dt, A, Bm.contiguous(), Cm.contiguous(),
                         params["D"], h0=h0)


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
                  state: Optional[SSMState] = None):
    """Full-sequence mamba block.  x: (B, T, d_model) -> (y, final
    SSMState)."""
    _require_mamba1(cfg)
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                  state.conv if state is not None else None)
    xc = F.silu(xc.float()).to(x.dtype)
    y, h_last = _ssm_core_m1(params, xc, cfg,
                             state.ssm if state is not None else None)
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
