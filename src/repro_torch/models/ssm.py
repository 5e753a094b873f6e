"""Mamba-1 (falcon-mamba) and Mamba-2 (zamba2) blocks.

Port of the JAX package's ``repro/models/ssm.py``.  A full-sequence block
runs its recurrence along the route its caller names (``layers.ROUTES``):

  Mamba-1, "kernels"         prefill: the hand-written scan kernel
                             (``kernels.ssm_scan.ops.scan``), forward
                             only, which computes the function of the
                             reference's ``_chunked_selective_scan`` plus
                             D·x and returns the final state the decode
                             path starts from;
  Mamba-1, "train", "plain"  ``_chunked_selective_scan``, the reference's
                             pure chunked scan in PyTorch: differentiable,
                             and free of any hand-written kernel.  The
                             reference trains through it too (its Pallas
                             scan has no backward).

Mamba-2 (``version=2``, zamba2's SSD form: a per-head scalar decay shared
by the head's channels) computes the reference's ``_ssm_core_m2`` on every
route: ``algo="ssd"`` the matmul-form chunk loop ``_ssd_chunked``,
``algo="diag"`` the diagonal recurrence through
``_chunked_selective_scan`` with the decay given directly.  Both are plain
PyTorch and differentiable.  The reference has no Pallas kernel for the
SSD (its Pallas scan is Mamba-1's), so there is no hand-written kernel to
port for it: on the "kernels" route Mamba-2 runs the same chunk loop as on
the others, which is the reference's own function, not a fallback from a
kernel.

Decode is the single-step recurrence in plain PyTorch, as in the
reference.

Under sharding ``rules`` (``layers.AxisRules``) the d_inner channels —
Mamba-2's heads, whole — are split over the ``ssm_inner`` axis: each rank
runs its channels' conv and scan (the scan kernel at the local shape),
``x_proj`` (Mamba-1) or ``bc_proj`` and ``dt_head_proj`` (Mamba-2) are
row-parallel, so dt, B and C are ``psum``'d before the scan, and
``out_proj`` is row-parallel with a ``psum``.  ``in_proj``'s columns hold
x and z one after the other, so a block of them is not the rank's x and
z: the leaf is gathered and the rank's columns of each taken.  Where the
axis does not split d_inner into whole heads, every leaf is gathered and
every rank runs every channel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models.layers import (NO_RULES, PARAM_AXES, AxisRules,
                                       as_rules, check_route, init_linear,
                                       leaf, local_axis)
from repro_torch.runtime import mesh_utils


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int
    d_state: int
    dt_rank: int
    conv_kernel: int = 4
    version: int = 1          # 1 = mamba1 (per-channel dt), 2 = mamba2
    headdim: int = 64         # mamba2 only
    n_groups: int = 1         # mamba2 B/C groups
    # mamba2 chunk algorithm: "ssd" the matmul form (``_ssd_chunked``),
    # "diag" the elementwise diagonal recurrence
    algo: str = "ssd"

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim


def init_mamba(gen: torch.Generator, cfg: SSMConfig, dtype=torch.bfloat16,
               device="cuda") -> dict:
    conv_w = torch.randn(cfg.conv_kernel, cfg.d_inner, generator=gen,
                         device=device) * 0.1
    p = {
        "in_proj": init_linear(gen, cfg.d_model, 2 * cfg.d_inner, dtype,
                               device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(cfg.d_inner, dtype=dtype, device=device),
        "out_proj": init_linear(gen, cfg.d_inner, cfg.d_model, dtype, device),
    }
    if cfg.version == 1:
        states = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                              device=device)
        p.update({
            # x -> (dt_low, B, C)
            "x_proj": init_linear(gen, cfg.d_inner,
                                  cfg.dt_rank + 2 * cfg.d_state, dtype,
                                  device),
            "dt_proj": init_linear(gen, cfg.dt_rank, cfg.d_inner, dtype,
                                   device),
            "dt_bias": torch.zeros(cfg.d_inner, device=device),
            "A_log": torch.log(states).repeat(cfg.d_inner, 1),
            "D": torch.ones(cfg.d_inner, device=device),
        })
    else:
        # Mamba-2's parameters are per head (H,), under their own names
        H, N, G = cfg.n_heads, cfg.d_state, cfg.n_groups
        p.update({
            "bc_proj": init_linear(gen, cfg.d_inner, 2 * G * N, dtype,
                                   device),
            "dt_head_proj": init_linear(gen, cfg.d_inner, H, dtype, device),
            "dt_head_bias": torch.zeros(H, device=device),
            "a_log_h": torch.zeros(H, device=device),
            "d_h": torch.ones(H, device=device),
        })
    return p


def _full_shapes(cfg: SSMConfig) -> dict:
    di, H, N = cfg.d_inner, cfg.n_heads, cfg.d_state
    shapes = {"in_proj": (cfg.d_model, 2 * di),
              "conv_w": (cfg.conv_kernel, di), "conv_b": (di,),
              "out_proj": (di, cfg.d_model)}
    if cfg.version == 1:
        shapes.update({"x_proj": (di, cfg.dt_rank + 2 * N),
                       "dt_proj": (cfg.dt_rank, di), "dt_bias": (di,),
                       "A_log": (di, N), "D": (di,)})
    else:
        shapes.update({"bc_proj": (di, 2 * cfg.n_groups * N),
                       "dt_head_proj": (di, H), "dt_head_bias": (H,),
                       "a_log_h": (H,), "d_h": (H,)})
    return shapes


class _Local(NamedTuple):
    """A Mamba block's leaves as this rank computes with them (``_local``):
    ``params`` (channel leaves in the rank's block, the rest whole), the
    mesh axis the channels are split over (None: every channel here), the
    rank's slice of the heads (Mamba-2) and the rules."""
    params: dict
    axis: Optional[str]
    heads: slice
    rules: AxisRules


def _local(params, cfg: SSMConfig, rules) -> _Local:
    rules = as_rules(rules)
    di = cfg.d_inner
    ax = local_axis(rules, "ssm_inner", di,
                    cfg.headdim if cfg.version == 2 else 1)
    shapes = _full_shapes(cfg)
    keep = ("ssm_inner",) if ax is not None else ()
    p = {k: leaf(params[k], rules, PARAM_AXES[f"mamba/{k}"], shapes[k], keep)
         for k in shapes}
    heads = slice(0, cfg.n_heads)
    if ax is not None:      # in_proj came whole: its x and z columns
        n, r = rules.size(ax), rules.index(ax)
        dl = di // n
        w = p["in_proj"]
        p["in_proj"] = torch.cat([w[:, r * dl:(r + 1) * dl],
                                  w[:, di + r * dl:di + (r + 1) * dl]], 1)
        hl = cfg.n_heads // n
        heads = slice(r * hl, (r + 1) * hl)
    return _Local(p, ax, heads, rules)


def _psum(x, loc: _Local):
    return mesh_utils.psum(x, loc.axis, mesh=loc.rules.mesh)


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


def _chunked_selective_scan(dt_or_decay: torch.Tensor, u: torch.Tensor,
                            Bm: torch.Tensor, Cm: torch.Tensor,
                            A: Optional[torch.Tensor], h0: torch.Tensor,
                            chunk: int):
    """Chunked scan of  h_t = a_t ⊙ h_{t−1} + (u_t ⊗ B_t);  y_t = <h_t, C_t>
    (the reference's ``_chunked_selective_scan``) without a (B, T, D, N)
    tensor: the chunks run in order carrying h, and within a chunk
    ``_inclusive_scan`` runs on (B, chunk, D, N) tensors, h folded into the
    chunk's first element.

    dt_or_decay: (B, T, D) fp32 — dt when A (D, N) is given (a = exp(dt·A),
    Mamba-1), the decay a_t itself, shared by the N states, when A is None
    (Mamba-2's "diag" form).  u: (B, T, D) fp32 (dt·x); Bm, Cm: (B, T, N)
    fp32; h0: (B, D, N).  Returns (y (B, T, D) fp32, h_T).
    Differentiable."""
    T = u.shape[1]
    N = Bm.shape[-1]
    ys = []
    h = h0
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        g_c = dt_or_decay[:, sl, :, None]
        a_c = (torch.exp(g_c * A[None, None]) if A is not None
               else g_c.expand(*g_c.shape[:3], N))            # (B,c,D,N)
        bmat = u[:, sl, :, None] * Bm[:, sl, None, :]           # (B,c,D,N)
        bmat = torch.cat([bmat[:, :1] + a_c[:, :1] * h[:, None],
                          bmat[:, 1:]], dim=1)
        hs = _inclusive_scan(a_c, bmat)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, Cm[:, sl]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def _ssm_core_m1(params, x: torch.Tensor, cfg: SSMConfig,
                 h0: Optional[torch.Tensor], *, route: str = "kernels",
                 chunk: int = 16, loc: Optional[_Local] = None):
    """Mamba-1 selective SSM over a full sequence.  x: (B, T, d_inner) ->
    (y in x's dtype, h_T (B, d_inner, d_state) fp32).  ``chunk`` is the
    chunked scan's preferred chunk (the kernel takes none).  With ``loc``
    (``_local``) x is the rank's channels and ``x_proj``'s partial
    products are ``psum``'d."""
    check_route(route)
    N = cfg.d_state
    proj = x @ params["x_proj"]
    if loc is not None:
        proj = _psum(proj, loc)
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


def _ssd_chunked(log_a: torch.Tensor, u: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, h0: torch.Tensor, chunk: int):
    """The reference's matmul-form chunked SSD (one B/C group):
    h_t = a_t ⊙ h_{t−1} + u_t ⊗ B_t,  y_t = <h_t, C_t>, with a per-head
    scalar decay a_t = exp(log_a_t).

    log_a: (B, T, H) fp32 (dt·A); u: (B, T, H, P) fp32 (dt·x); Bm, Cm:
    (B, T, N) fp32; h0: (B, H, P, N).  Returns (y (B, T, H, P) fp32, h_T).

    The chunks run in order carrying h.  Within a chunk of c steps, with cs
    the running sum of log_a: S = C·Bᵀ (c, c) is shared by the heads, the
    causal decays L[i, j] = exp(cs_i − cs_j) weight it per head, one
    (c, c)·(c, P) product per head gives the chunk's own term, the carried
    state adds exp(cs_i)·<h, C_i>, and h moves on by a rank-c update.  A
    last chunk shorter than ``chunk`` runs at its own length.
    Differentiable."""
    T = u.shape[1]
    ys = []
    h = h0
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        la_c, u_c, b_c, c_c = log_a[:, sl], u[:, sl], Bm[:, sl], Cm[:, sl]
        c = la_c.shape[1]
        cs = torch.cumsum(la_c, dim=1)                         # (B,c,H)
        S = torch.einsum("bin,bjn->bij", c_c, b_c)             # (B,c,c)
        Lmat = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])  # (B,c,c,H)
        causal = torch.ones(c, c, dtype=torch.bool, device=u.device).tril()
        W = torch.where(causal[None, :, :, None], S[..., None] * Lmat, 0.0)
        y_intra = torch.einsum("bijh,bjhp->bihp", W, u_c)      # (B,c,H,P)
        y_inter = torch.einsum("bin,bhpn->bihp", c_c, h) \
            * torch.exp(cs)[..., None]
        total = cs[:, -1]                                      # (B,H)
        w_j = torch.exp(total[:, None, :] - cs)                # (B,c,H)
        h = torch.exp(total)[..., None, None] * h + torch.einsum(
            "bjh,bjhp,bjn->bhpn", w_j, u_c, b_c)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def _heads_m2(params, x: torch.Tensor, loc: Optional[_Local]) -> tuple:
    """Mamba-2's (B, C, dt before softplus, A, D) for x (..., d_inner);
    with ``loc`` the products are ``psum``'d and the per-head vectors cut
    to the rank's heads."""
    bc = x @ params["bc_proj"]
    dt = x @ params["dt_head_proj"]
    hs = slice(None)
    if loc is not None:
        bc, dt, hs = _psum(bc, loc), _psum(dt, loc)[..., loc.heads], \
            loc.heads
    Bm, Cm = bc.chunk(2, dim=-1)
    return (Bm, Cm, dt.float() + params["dt_head_bias"][hs],
            -torch.exp(params["a_log_h"][hs]), params["d_h"][hs])


def _ssm_core_m2(params, x: torch.Tensor, cfg: SSMConfig,
                 h0: Optional[torch.Tensor], *, chunk: int = 16,
                 loc: Optional[_Local] = None):
    """Mamba-2 recurrence over a full sequence (``cfg.algo``: "ssd" or
    "diag", module docstring).  x: (B, T, d_inner) -> (y in x's dtype, h_T
    (B, d_inner, d_state) fp32); with ``loc`` x is the rank's heads."""
    B, T, Din = x.shape
    Pd, N = cfg.headdim, cfg.d_state
    H = Din // Pd
    Bm, Cm, dt_raw, A, d_h = _heads_m2(params, x, loc)
    dt = F.softplus(dt_raw)                                   # (B,T,H)
    xf = x.float().reshape(B, T, H, Pd)
    if h0 is None:
        h0 = torch.zeros(B, Din, N, device=x.device)
    if cfg.algo == "ssd":
        y_h, h_last = _ssd_chunked(dt * A, xf * dt[..., None], Bm.float(),
                                   Cm.float(), h0.reshape(B, H, Pd, N),
                                   _pick_chunk(T, chunk))
        y, h_last = y_h.reshape(B, T, Din), h_last.reshape(B, Din, N)
    else:  # "diag": the diagonal recurrence, the decay shared by a head
        decay = torch.exp(dt * A).repeat_interleave(Pd, dim=-1)  # (B,T,Din)
        y, h_last = _chunked_selective_scan(
            decay, (xf * dt[..., None]).reshape(B, T, Din), Bm.float(),
            Cm.float(), None, h0, _pick_chunk(T, chunk))
    y = y + d_h.repeat_interleave(Pd)[None, None] * x.float()
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
                  route: str = "kernels", rules: AxisRules = NO_RULES):
    """Full-sequence mamba block along ``route`` (module docstring).
    x: (B, T, d_model) -> (y, final SSMState); under ``rules`` the state
    holds the rank's channels."""
    check_route(route)
    loc = _local(params, cfg, rules) if as_rules(rules).enabled else None
    if loc is not None:
        params = loc.params
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                  state.conv if state is not None else None)
    xc = F.silu(xc.float()).to(x.dtype)
    h0 = state.ssm if state is not None else None
    if cfg.version == 1:
        y, h_last = _ssm_core_m1(params, xc, cfg, h0, route=route,
                                 chunk=chunk, loc=loc)
    else:
        y, h_last = _ssm_core_m2(params, xc, cfg, h0, chunk=chunk, loc=loc)
    y = y * F.silu(z.float()).to(x.dtype)
    y = y @ params["out_proj"]
    if loc is not None:
        y = _psum(y, loc)
    return y, SSMState(conv=conv_state, ssm=h_last)


def mamba_decode_step(params, x: torch.Tensor, state: SSMState,
                      cfg: SSMConfig, rules: AxisRules = NO_RULES):
    """Single-token recurrence.  x: (B, 1, d_model) -> (y (B, 1, d_model),
    new SSMState); under ``rules`` the state holds the rank's channels."""
    loc = _local(params, cfg, rules) if as_rules(rules).enabled else None
    if loc is not None:
        params = loc.params
    xin, z = (x @ params["in_proj"]).chunk(2, dim=-1)         # (B,1,Din)
    xc, conv_state = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                  state.conv)
    xs = F.silu(xc.float()).to(x.dtype)[:, 0]                 # (B,Din)
    if cfg.version == 1:
        proj = xs @ params["x_proj"]
        if loc is not None:
            proj = _psum(proj, loc)
        dt_low, Bm, Cm = torch.split(
            proj, [cfg.dt_rank, cfg.d_state, cfg.d_state], dim=-1)
        dt = F.softplus((dt_low @ params["dt_proj"]).float()
                        + params["dt_bias"])                  # (B,Din)
        A = -torch.exp(params["A_log"])
        a = torch.exp(dt[..., None] * A[None])                # (B,Din,N)
        bmat = (dt * xs.float())[..., None] * Bm.float()[:, None, :]
        d_skip = params["D"]
    else:
        B, Pd = xs.shape[0], cfg.headdim
        Bm, Cm, dt_raw, A, d_h = _heads_m2(params, xs, loc)
        dt = F.softplus(dt_raw)                               # (B,H)
        # the head's decay, shared by its Pd channels and the N states
        a = torch.exp(dt * A[None]).repeat_interleave(Pd, dim=-1)[..., None]
        xdt = (xs.float().reshape(B, -1, Pd)
               * dt[..., None]).reshape(B, xs.shape[-1])
        bmat = xdt[..., None] * Bm.float()[:, None, :]
        d_skip = d_h.repeat_interleave(Pd)
    h = a * state.ssm + bmat
    y = torch.einsum("bdn,bn->bd", h, Cm.float())
    y = y + d_skip[None] * xs.float()
    y = (y.to(x.dtype) * F.silu(z[:, 0].float()).to(x.dtype))[:, None]
    y = y @ params["out_proj"]
    if loc is not None:
        y = _psum(y, loc)
    return y, SSMState(conv=conv_state, ssm=h)
