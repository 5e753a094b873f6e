"""Routing kernels for Hopper: the launch wrappers and their plain PyTorch
versions.

Port of the JAX package's ``repro/kernels/routing/kernel.py`` — the Pallas
kernels of the single-device serving and training paths:

* ``routing_iteration_fused`` — one lazy-update iteration, returns
  ``(s, b_new)``; squash runs outside (``ops.dynamic_routing_fused``).
* ``routing_procedure_fused`` — the whole procedure (all iterations, squash
  in between, only the final v comes back), with fp32/bf16 û streams, int8
  codes with one fp32 scale per L-tile, and per-tile early exit.
* ``routing_procedure_bwd`` — its recompute-b backward: (û, ∂v) -> ∂û at
  û's dtype, replaying the forward and walking the iterations in reverse
  (``ops.dynamic_routing_procedure_train`` wraps the pair in an autograd
  Function).
* ``routing_stage_votes`` / ``routing_stage_update`` /
  ``routing_stage_update_fold`` — the stage-split kernels of sharded
  routing: Eq.2's vote sum, then Eq.3's squash with Eq.4's logit update
  (and, folded, the next iteration's Eq.5 couplings); ``ops.
  dynamic_routing_fused_sharded`` puts the cross-shard collectives between
  them.
* ``em_stage_stats`` / ``em_stage_estep`` — EM routing's M-step sufficient
  statistics and E-step responsibilities (``ops.em_routing_fused`` runs the
  host arithmetic between them).

The CUDA sources are ``repro_torch/csrc/routing.cu``, ``routing_bwd.cu``,
``routing_stage.cu`` and ``em_routing.cu`` (the source notes there say what bounds each kernel
on the card and how its grid is laid out); ``repro_torch.kernels.cudalib``
builds them, with every other family's, into one library.

Each public wrapper takes its plain version for a CPU tensor and launches
the kernel for a tensor on a Hopper card (``repro_torch.kernels.plain_mode``
raises for anything else); there is no fallback from one to the other.  The
wrappers have no autograd formula of their own: given an input that
requires grad with grad mode on, they raise rather than return an output
that cuts the gradient.  ``<wrapper>.launches`` counts the calls that
launched the kernel.  On a fake tensor (the dry run's:
``repro_torch.kernels.fake_mode``) the six wrappers of dynamic routing
take their launch path up to the launch — the same checks and
allocations — and report the kernel's operations and bytes
(``routing_cost``) instead of launching; the two EM kernels, which no
dry-run cell reaches, raise there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import approx
from repro_torch.kernels import (cudalib, fake_mode, plain_mode,
                                 refuse_fake, report_kernel)
from repro_torch.kernels.cudalib import check as _check
from repro_torch.kernels.cudalib import ptr as _ptr
from repro_torch.kernels.cudalib import stream as _stream
from repro_torch.kernels.routing import ref

# stream dtype codes shared with routing.cu: 0 fp32, 1 bf16, 2 int8
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_STREAM_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def _as_stream(u_hat: torch.Tensor) -> torch.Tensor:
    """The kernels stream û in its incoming dtype (fp32 or bf16 — the
    caller hoists the stream-dtype cast out of the iteration loop);
    anything else is promoted to fp32.  Accumulation is always fp32."""
    if u_hat.dtype in (torch.float32, torch.bfloat16):
        return u_hat
    return u_hat.float()


def _check_shape(u_hat: torch.Tensor, l_tile: int) -> tuple:
    if u_hat.dim() != 4:
        raise ValueError(f"u_hat must be (B, L, H, C); got {tuple(u_hat.shape)}")
    B, L, H, C = u_hat.shape
    if l_tile < 1 or L % l_tile != 0:
        raise ValueError(f"L={L} not divisible by l_tile={l_tile}")
    return B, L, H, C


def _check_cuda_operand(name: str, t: torch.Tensor, device: torch.device,
                        dtype: torch.dtype, shape: tuple) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, û on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_no_autograd(u_hat: torch.Tensor, name: str) -> None:
    """Raise where a kernel would silently cut autograd: the wrappers pass
    raw pointers, so their output has no ``grad_fn``.  Training goes
    through the autograd Function of ``RouterSpec(differentiable=True)``,
    whose forward and backward call the kernels with grad mode off; the EM
    kernels have no backward at all, as in the reference."""
    if torch.is_grad_enabled() and u_hat.requires_grad:
        raise ValueError(
            f"{name} has no autograd formula: its input requires grad, and "
            "the kernel's output would carry no gradient back to it.  Route "
            "dynamic routing through RouterSpec(differentiable=True) (the "
            "autograd Function over routing_procedure_fused and "
            "routing_procedure_bwd), train EM on backend='torch', or call "
            "under torch.no_grad() / torch.inference_mode()")


def _check_elements(B: int, L: int, H: int, C: int) -> None:
    if B * L * H * C >= 2 ** 31:
        raise ValueError("û has 2^31 or more elements; the kernels index "
                         "its rows with 32-bit offsets")


def _check_kernel_limits(u: torch.Tensor, l_tile: int):
    """The tile kernel's launch geometry for û at ``l_tile``
    (``ops.tile_geometry``, which raises for a shape no block can take);
    raises too for a û of 2^31 elements or more."""
    # ops imports this module, so the geometry is looked up at call time
    from repro_torch.kernels.routing import ops
    B, L, H, C = u.shape
    _check_elements(B, L, H, C)
    sd = {torch.float32: "fp32", torch.bfloat16: "bf16",
          torch.int8: "int8"}[u.dtype]
    return ops.tile_geometry(B, L, H, C, l_tile, sd)


def routing_cost(kind: str, u: torch.Tensor, iterations: int = 1,
                 scales: Optional[torch.Tensor] = None) -> tuple:
    """(operations, bytes) of one call of a dynamic-routing kernel on û
    ``u`` (B,L,H,C), the formulas of its bound: û read once and the small
    fp32 operands once each; Eq.2 and Eq.4 two operations an element
    each (the procedure: every iteration, early exit or not; the backward:
    replay 4T, reverse sweep 4(T−1), ∂û 2 + 4(T−1) an element, ∂û
    written at û's dtype)."""
    B, L, H, C = u.shape
    elems = B * L * H * C
    ub = elems * u.element_size()
    bhc, lh = B * H * C * 4, L * H * 4
    T = iterations
    if kind == "iteration":
        return 4 * elems, ub + 2 * lh + 2 * bhc
    if kind == "procedure":
        extra = 0 if scales is None else scales.numel() * 4
        return 4 * elems * T, ub + bhc + extra
    if kind == "bwd":
        return elems * (4 * T + 8 * (T - 1) + 2), 2 * ub + bhc
    if kind == "votes":
        return 2 * elems, ub + lh + bhc
    if kind == "update":
        return 2 * elems, ub + 2 * bhc + lh
    if kind == "fold":
        return 2 * elems, ub + 2 * bhc + 3 * lh
    raise ValueError(f"unknown routing kernel kind {kind!r}")


def _geometry_args(geo) -> tuple:
    return geo.rows, geo.batch_chunk, geo.cluster, int(geo.staged), geo.slots


# ---------------------------------------------------------------------------
# plain versions: the kernels' schedule, tile by tile, in PyTorch
# ---------------------------------------------------------------------------

def _softmax_h(b: torch.Tensor, use_approx: bool) -> torch.Tensor:
    """The kernels' Eq.5 softmax over H (``_softmax_h_inkernel``)."""
    m = torch.amax(b, dim=-1, keepdim=True)
    if use_approx:
        e = approx.fast_exp(b - m)
        return e * approx.fast_reciprocal(torch.sum(e, dim=-1, keepdim=True))
    e = torch.exp(b - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def _tile(u: torch.Tensor, j: int, l_tile: int,
          scales: Optional[torch.Tensor]) -> torch.Tensor:
    """L-tile j of the û stream as fp32 (int8 codes times the tile's
    scale)."""
    t = u[:, j * l_tile:(j + 1) * l_tile].float()
    if scales is not None:
        t = t * scales[j, 0]
    return t


def routing_iteration_fused_plain(u_hat: torch.Tensor, b: torch.Tensor,
                                  v_prev: torch.Tensor, *, l_tile: int = 128,
                                  use_approx: bool = False):
    """Plain version of ``routing_iteration_fused``: per L-tile, the
    deferred Eq.4 update, the Eq.5 softmax and the Eq.2 partial sum,
    accumulated over the tiles in order.  Returns (s, b_new)."""
    u = _as_stream(u_hat)
    B, L, H, C = _check_shape(u, l_tile)
    b = b.float()
    v_prev = v_prev.float()
    b_new = torch.empty_like(b)
    s = None
    for j in range(L // l_tile):
        rows = slice(j * l_tile, (j + 1) * l_tile)
        ut = _tile(u, j, l_tile, None)
        db = torch.sum(ut * v_prev[:, None], dim=(0, 3))         # Eq.4
        bn = b[rows] + db
        b_new[rows] = bn
        c = _softmax_h(bn, use_approx)                           # Eq.5
        part = torch.sum(ut * c[None, :, :, None], dim=1)        # Eq.2
        s = part if s is None else s + part
    return s, b_new


def routing_procedure_fused_plain(u_hat: torch.Tensor,
                                  scales: Optional[torch.Tensor] = None, *,
                                  iterations: int = 3, l_tile: int = 128,
                                  use_approx: bool = False,
                                  early_exit_eps: Optional[float] = None):
    """Plain version of ``routing_procedure_fused``: the same lazy-update
    schedule, tile order, int8 dequantisation and early-exit rule.  Returns
    v, or (v, effective tile-iterations as an int32 scalar tensor) when
    ``early_exit_eps`` is set."""
    u = _check_procedure_args(u_hat, scales, l_tile, early_exit_eps)
    B, L, H, C = u.shape
    n = L // l_tile
    dev = u.device
    b = torch.zeros((L, H), dtype=torch.float32, device=dev)
    v = torch.zeros((B, H, C), dtype=torch.float32, device=dev)
    early_exit = early_exit_eps is not None
    converged = [False] * n
    c_frozen = torch.zeros((L, H), dtype=torch.float32, device=dev)
    cnt = 0
    for it in range(iterations):
        s = None
        for j in range(n):
            rows = slice(j * l_tile, (j + 1) * l_tile)
            ut = _tile(u, j, l_tile, scales)
            if not converged[j]:
                db = torch.sum(ut * v[:, None], dim=(0, 3))      # Eq.4
                b[rows] = b[rows] + db
                coup = _softmax_h(b[rows], use_approx)           # Eq.5
                if early_exit:
                    c_frozen[rows] = coup
                    # ε = 0 never freezes; iteration 0 (v_prev = 0) is exempt
                    delta = float(torch.max(torch.abs(db)))
                    converged[j] = it > 0 and delta < early_exit_eps
                    cnt += 1
            else:
                coup = c_frozen[rows]
            part = torch.sum(ut * coup[None, :, :, None], dim=1)  # Eq.2
            s = part if s is None else s + part
        v = ref.squash(s, use_approx)                            # Eq.3
    if early_exit:
        return v, torch.tensor(cnt, dtype=torch.int32, device=dev)
    return v


def _check_procedure_args(u_hat, scales, l_tile, early_exit_eps):
    """The reference's argument contract (kernel.py:323-343): int8 codes
    need per-tile scales and scales need int8 codes; other dtypes stream
    as fp32 unless bf16."""
    B, L, H, C = _check_shape(u_hat, l_tile)
    n = L // l_tile
    if scales is not None:
        if u_hat.dtype != torch.int8:
            raise ValueError(f"per-tile scales given but û dtype is "
                             f"{u_hat.dtype} — expected int8 codes from "
                             f"quantize_u_stream")
        if tuple(scales.shape) != (n, 1):
            raise ValueError(f"scales shape {tuple(scales.shape)} != "
                             f"(L/l_tile, 1) = ({n}, 1)")
    elif u_hat.dtype == torch.int8:
        raise ValueError("int8 û stream needs per-tile scales "
                         "(ops.quantize_u_stream)")
    else:
        u_hat = _as_stream(u_hat)
    if early_exit_eps is not None and not float(early_exit_eps) >= 0.0:
        raise ValueError(f"early_exit_eps must be >= 0, got {early_exit_eps}")
    return u_hat


def _squash_vjp(s: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
    """Eq.3 transpose at s through the *exact* squash, by autograd — the
    reference takes ``jax.vjp`` of the same function, in approx mode too.
    (``routing_bwd.cu`` writes the derivative out in closed form.)"""
    _, vjp = torch.func.vjp(lambda x: ref.squash(x, False), s)
    return vjp(gv)[0]


def routing_procedure_bwd_plain(u_hat: torch.Tensor, g: torch.Tensor, *,
                                iterations: int = 3, l_tile: int = 128,
                                use_approx: bool = False) -> torch.Tensor:
    """Plain version of ``routing_procedure_bwd``: the replay and reverse
    schedule of the reference's backward kernel, tile by tile.  Returns ∂û
    (B,L,H,C) at û's stream dtype, accumulated in fp32."""
    u = _as_stream(u_hat)
    B, L, H, C = _check_shape(u, l_tile)
    n = L // l_tile
    T = iterations
    dev = u.device
    f32 = dict(dtype=torch.float32, device=dev)
    # replay: the forward schedule, snapshotting c_t, s_t and v_{t-1}
    b = torch.zeros((L, H), **f32)
    v = torch.zeros((B, H, C), **f32)
    c_all = torch.empty((T, L, H), **f32)
    s_all = torch.empty((T, B, H, C), **f32)
    vp_all = torch.empty((T, B, H, C), **f32)
    for t in range(T):
        vp_all[t] = v
        s = None
        for j in range(n):
            rows = slice(j * l_tile, (j + 1) * l_tile)
            ut = _tile(u, j, l_tile, None)
            b[rows] = b[rows] + torch.sum(ut * v[:, None], dim=(0, 3))
            coup = _softmax_h(b[rows], use_approx)
            c_all[t, rows] = coup
            part = torch.sum(ut * coup[None, :, :, None], dim=1)
            s = part if s is None else s + part
        s_all[t] = s
        v = ref.squash(s, use_approx)
    # reverse: t = T-1 .. 0, carrying ∂v and the accumulated ∂b
    gv = g.float()
    gb = torch.zeros((L, H), **f32)
    gs_all = torch.empty((T, B, H, C), **f32)
    gb_all = torch.zeros((T, L, H), **f32)
    for t in range(T - 1, -1, -1):
        gs = _squash_vjp(s_all[t], gv)
        gs_all[t] = gs
        if t == 0:
            break           # neither ∂b_0 nor the carry reaches ∂û
        gv = None
        for j in range(n):
            rows = slice(j * l_tile, (j + 1) * l_tile)
            ut = _tile(u, j, l_tile, None)
            gc = torch.sum(ut * gs[:, None], dim=(0, 3))             # (l_t, H)
            coup = c_all[t, rows]
            gbt = gb[rows] + coup * (
                gc - torch.sum(coup * gc, dim=-1, keepdim=True))   # Eq.5 vjp
            gb[rows] = gbt
            gb_all[t, rows] = gbt
            part = torch.sum(ut * gbt[None, :, :, None], dim=1)     # Eq.4 vjp
            gv = part if gv is None else gv + part
    # ∂û = Σ_t c_t ⊗ gs_t + Σ_{t≥1} gb_t ⊗ v_{t-1}
    du = c_all[0][None, :, :, None] * gs_all[0][:, None]
    for t in range(1, T):
        du += c_all[t][None, :, :, None] * gs_all[t][:, None]
        du += gb_all[t][None, :, :, None] * vp_all[t][:, None]
    return du.to(u.dtype)


# ---------------------------------------------------------------------------
# public wrappers: plain version on the CPU, the CUDA kernel on the card
# ---------------------------------------------------------------------------

def routing_iteration_fused(u_hat: torch.Tensor, b: torch.Tensor,
                            v_prev: torch.Tensor, *, l_tile: int = 128,
                            use_approx: bool = False):
    """One fused routing iteration.  Returns (s (B,H,C), b_new (L,H)).

    û (B,L,H,C) streams at its own dtype (fp32 or bf16; anything else is
    promoted to fp32); b (L,H) and v_prev (B,H,C) are fp32."""
    check_no_autograd(u_hat, "routing_iteration_fused")
    fake = fake_mode(u_hat)
    if not fake and plain_mode(u_hat):
        return routing_iteration_fused_plain(u_hat, b, v_prev, l_tile=l_tile,
                                             use_approx=use_approx)
    u = _as_stream(u_hat)
    B, L, H, C = _check_shape(u, l_tile)
    geo = _check_kernel_limits(u, l_tile)
    dev = u.device
    _check_cuda_operand("u_hat", u, dev, u.dtype, (B, L, H, C))
    _check_cuda_operand("b", b, dev, torch.float32, (L, H))
    _check_cuda_operand("v_prev", v_prev, dev, torch.float32, (B, H, C))
    s = torch.empty((B, H, C), dtype=torch.float32, device=dev)
    b_new = torch.empty((L, H), dtype=torch.float32, device=dev)
    partial = torch.empty(geo.partial_shape(B, H, C), dtype=torch.float32,
                          device=dev)
    if fake:
        report_kernel("routing_iteration_fused", *routing_cost("iteration",
                                                               u))
        return s, b_new
    lib = cudalib.build()
    err = lib.routing_iteration(
        _ptr(u), _DTYPE_CODE[u.dtype], _ptr(b), _ptr(v_prev), _ptr(s),
        _ptr(b_new), _ptr(partial), B, L, H, C, l_tile, *_geometry_args(geo),
        int(use_approx), _stream(dev))
    _check(err)
    routing_iteration_fused.launches += 1
    return s, b_new


routing_iteration_fused.launches = 0


def routing_procedure_fused(u_hat: torch.Tensor,
                            scales: Optional[torch.Tensor] = None, *,
                            iterations: int = 3, l_tile: int = 128,
                            use_approx: bool = False,
                            early_exit_eps: Optional[float] = None):
    """The whole routing procedure in one call.

    Returns v (B, H, C), or ``(v, effective_tile_iterations)`` — an int32
    scalar tensor counting the (iteration, L-tile) cells that did Eq.4/Eq.5
    work — when ``early_exit_eps`` is set (the fixed grid gives
    iterations · L/l_tile).  û is fp32 or bf16, or int8 codes with
    ``scales`` (L/l_tile, 1) fp32 from ``ops.quantize_u_stream``."""
    check_no_autograd(u_hat, "routing_procedure_fused")
    fake = fake_mode(u_hat)
    if not fake and plain_mode(u_hat):
        return routing_procedure_fused_plain(
            u_hat, scales, iterations=iterations, l_tile=l_tile,
            use_approx=use_approx, early_exit_eps=early_exit_eps)
    u = _check_procedure_args(u_hat, scales, l_tile, early_exit_eps)
    B, L, H, C = u.shape
    geo = _check_kernel_limits(u, l_tile)
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1; got {iterations}")
    dev = u.device
    n = L // l_tile
    _check_cuda_operand("u_hat", u, dev, u.dtype, (B, L, H, C))
    if scales is not None:
        _check_cuda_operand("scales", scales, dev, torch.float32, (n, 1))
    early_exit = early_exit_eps is not None
    # the kernel starts from b = 0, v = 0 without reading them
    v = torch.empty((B, H, C), dtype=torch.float32, device=dev)
    b = torch.empty((L, H), dtype=torch.float32, device=dev)
    partial = torch.empty(geo.partial_shape(B, H, C), dtype=torch.float32,
                          device=dev)
    gmax = conv = c_frozen = cnt = None
    if early_exit:
        gmax = torch.empty((geo.groups,), dtype=torch.float32, device=dev)
        flags = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        conv, cnt = flags[:n], flags[n:]  # zeroed in one fill
        c_frozen = torch.empty((L, H), dtype=torch.float32, device=dev)
    if fake:
        report_kernel("routing_procedure_fused", *routing_cost(
            "procedure", u, iterations, scales))
        return (v, cnt[0]) if early_exit else v
    lib = cudalib.build()
    err = lib.routing_procedure(
        _ptr(u), _DTYPE_CODE[u.dtype], _ptr(scales), _ptr(v), _ptr(b),
        _ptr(partial), _ptr(gmax), _ptr(conv), _ptr(c_frozen), _ptr(cnt),
        B, L, H, C, l_tile, *_geometry_args(geo), iterations,
        int(use_approx), int(early_exit),
        float(early_exit_eps) if early_exit else 0.0, _stream(dev))
    _check(err)
    routing_procedure_fused.launches += 1
    if early_exit:
        return v, cnt[0]
    return v


routing_procedure_fused.launches = 0


def routing_procedure_bwd(u_hat: torch.Tensor, g: torch.Tensor, *,
                          iterations: int = 3, l_tile: int = 128,
                          use_approx: bool = False) -> torch.Tensor:
    """Backward of ``routing_procedure_fused``: (û (B,L,H,C), ∂v (B,H,C)
    fp32) -> ∂û (B,L,H,C) at û's stream dtype (fp32 or bf16; anything else
    is promoted to fp32), accumulated in fp32.  ``l_tile`` and
    ``use_approx`` must be the forward's, so that the replay reproduces its
    b, c and v; the squash is differentiated exactly in either mode."""
    check_no_autograd(u_hat, "routing_procedure_bwd")
    fake = fake_mode(u_hat)
    if not fake and plain_mode(u_hat):
        return routing_procedure_bwd_plain(u_hat, g, iterations=iterations,
                                           l_tile=l_tile,
                                           use_approx=use_approx)
    u = _as_stream(u_hat)
    B, L, H, C = _check_shape(u, l_tile)
    geo = _check_kernel_limits(u, l_tile)
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1; got {iterations}")
    dev = u.device
    _check_cuda_operand("u_hat", u, dev, u.dtype, (B, L, H, C))
    _check_cuda_operand("g", g, dev, torch.float32, (B, H, C))
    T = iterations
    f32 = dict(dtype=torch.float32, device=dev)
    du = torch.empty_like(u)
    b = torch.empty((L, H), **f32)     # the replay starts from b = 0
    gb = torch.zeros((L, H), **f32)
    partial = torch.empty(geo.partial_shape(B, H, C), **f32)
    c_all = torch.empty((T, L, H), **f32)
    gb_all = torch.empty((T, L, H), **f32)
    s_all = torch.empty((T, B, H, C), **f32)
    vp_all = torch.empty((T, B, H, C), **f32)  # slot 0 (v_{-1}) unread
    gs_all = torch.empty((T, B, H, C), **f32)
    if fake:
        report_kernel("routing_procedure_bwd", *routing_cost("bwd", u, T))
        return du
    lib = cudalib.build()
    err = lib.routing_procedure_backward(
        _ptr(u), _DTYPE_CODE[u.dtype], _ptr(g), _ptr(du), _ptr(b), _ptr(gb),
        _ptr(partial), _ptr(c_all), _ptr(gb_all), _ptr(s_all), _ptr(vp_all),
        _ptr(gs_all), B, L, H, C, l_tile, *_geometry_args(geo), T,
        int(use_approx), _stream(dev))
    _check(err)
    routing_procedure_bwd.launches += 1
    return du


routing_procedure_bwd.launches = 0


# ---------------------------------------------------------------------------
# stage-split kernels of sharded routing (the reference's kernel.py:590-760):
# the iteration surfaces at the paper's Table-2 aggregation points, so that
# ops.dynamic_routing_fused_sharded can put the cross-shard collectives
# between the stages.  They keep no per-tile state, so their CUDA grids are
# their own (``em_stats_chunks`` splits L for the vote sums) and ``l_tile``
# survives as the reference's error surface and the plain versions' order.
# ---------------------------------------------------------------------------

def routing_stage_votes_plain(u_hat: torch.Tensor, c: torch.Tensor, *,
                              l_tile: int = 128) -> torch.Tensor:
    """Plain version of ``routing_stage_votes``: the reference's
    ``_stage_votes_kernel`` per L-tile, the partial sums added in tile
    order.  Returns s (B,H,C) fp32."""
    u = _as_stream(u_hat)
    B, L, H, C = _check_shape(u, l_tile)
    c = c.float()
    s = None
    for j in range(L // l_tile):
        rows = slice(j * l_tile, (j + 1) * l_tile)
        part = torch.sum(_tile(u, j, l_tile, None)
                         * c[rows][None, :, :, None], dim=1)      # Eq.2
        s = part if s is None else s + part
    return s


def routing_stage_update_plain(u_hat: torch.Tensor, s: torch.Tensor, *,
                               l_tile: int = 128, use_approx: bool = False):
    """Plain version of ``routing_stage_update``: v = squash(s) and, per
    L-tile, db = Σ_{b,c} û·v (the reference's ``_stage_update_kernel``).
    Returns (v (B,H,C), db (L,H)), fp32."""
    u = _as_stream(u_hat)
    B, L, H, C = _check_shape(u, l_tile)
    v = ref.squash(s.float(), use_approx)                         # Eq.3
    db = torch.empty((L, H), dtype=torch.float32, device=u.device)
    for j in range(L // l_tile):
        rows = slice(j * l_tile, (j + 1) * l_tile)
        db[rows] = torch.sum(_tile(u, j, l_tile, None) * v[:, None],
                             dim=(0, 3))                          # Eq.4
    return v, db


def routing_stage_update_fold_plain(u_hat: torch.Tensor, s: torch.Tensor,
                                    b: torch.Tensor, *, l_tile: int = 128,
                                    use_approx: bool = False):
    """Plain version of ``routing_stage_update_fold``: the update stage,
    then b_new = b + db and the next iteration's c = softmax_H(b_new) (the
    reference's ``_stage_update_fold_kernel``).  Returns (v, b_new, c)."""
    v, db = routing_stage_update_plain(u_hat, s, l_tile=l_tile,
                                       use_approx=use_approx)
    b_new = b.float() + db
    return v, b_new, _softmax_h(b_new, use_approx)               # Eq.5


def _stage_stream(u_hat: torch.Tensor, l_tile: int):
    """The stage wrappers' û on the card: fp32 or bf16 (other dtypes are
    promoted to fp32), contiguous, L divisible by ``l_tile``."""
    u = _as_stream(u_hat)
    B, L, H, C = _check_shape(u, l_tile)
    _check_elements(B, L, H, C)
    _check_cuda_operand("u_hat", u, u.device, u.dtype, (B, L, H, C))
    return u, (B, L, H, C)


def _stage_small(name: str, t: torch.Tensor, device: torch.device,
                 shape: tuple) -> torch.Tensor:
    """A small fp32 operand of a stage kernel, made contiguous."""
    t = t.float().contiguous()
    _check_cuda_operand(name, t, device, torch.float32, shape)
    return t


def routing_stage_votes(u_hat: torch.Tensor, c: torch.Tensor, *,
                        l_tile: int = 128) -> torch.Tensor:
    """STAGE 1 of sharded routing, Eq.2: (û (B,L,H,C), c (L,H)) -> the
    vote sum s (B,H,C) fp32 over this shard's L rows.  û streams at its own
    dtype (fp32 or bf16; anything else is promoted to fp32)."""
    for name, t in (("u_hat", u_hat), ("c", c)):
        check_no_autograd(t, f"routing_stage_votes ({name})")
    fake = fake_mode(u_hat)
    if not fake and plain_mode(u_hat):
        return routing_stage_votes_plain(u_hat, c, l_tile=l_tile)
    u, (B, L, H, C) = _stage_stream(u_hat, l_tile)
    dev = u.device
    c = _stage_small("c", c, dev, (L, H))
    rows, chunks = em_stats_chunks(B, L)
    s = torch.empty((B, H, C), dtype=torch.float32, device=dev)
    partial = torch.empty((chunks, B, H, C), dtype=torch.float32, device=dev)
    if fake:
        report_kernel("routing_stage_votes", *routing_cost("votes", u))
        return s
    lib = cudalib.build()
    err = lib.routing_stage_votes(_ptr(u), _DTYPE_CODE[u.dtype], _ptr(c),
                                  _ptr(s), _ptr(partial), B, L, H, C, rows,
                                  chunks, _stream(dev))
    _check(err)
    routing_stage_votes.launches += 1
    return s


routing_stage_votes.launches = 0


def _stage_update_launch(u_hat, s, b, l_tile, use_approx, fold):
    """The update stage at ``ops.stage_update_geometry``
    (``csrc/routing_stage.cu``): the squash launch, then the update kernel
    (Eq.4 and, with ``fold``, the next iteration's softmax) as its
    programmatic dependent; a û that is not 16-byte aligned takes the
    one-element runs, and a row of more runs than a block has threads is
    walked in several passes."""
    from repro_torch.kernels.routing import ops
    u, (B, L, H, C) = _stage_stream(u_hat, l_tile)
    dev = u.device
    s = _stage_small("s", s, dev, (B, H, C))
    b = _stage_small("b", b, dev, (L, H)) if fold else None
    fake = fake_mode(u)
    geo = ops.stage_update_geometry(B, L, H, C, _STREAM_NAME[u.dtype],
                                    aligned=fake or u.data_ptr() % 16 == 0)
    f32 = dict(dtype=torch.float32, device=dev)
    v = torch.empty((B, H, C), **f32)
    db = b_new = c_new = None
    if fold:
        b_new = torch.empty((L, H), **f32)
        c_new = torch.empty((L, H), **f32)
    else:
        db = torch.empty((L, H), **f32)
    if fake:
        kind, name = (("fold", "routing_stage_update_fold") if fold
                      else ("update", "routing_stage_update"))
        report_kernel(name, *routing_cost(kind, u))
        return (v, b_new, c_new) if fold else (v, db)
    lib = cudalib.build()
    err = lib.routing_stage_update(
        _ptr(u), _DTYPE_CODE[u.dtype], _ptr(s), _ptr(v), _ptr(db), _ptr(b),
        _ptr(b_new), _ptr(c_new), B, L, H, C, int(use_approx), int(fold),
        geo.rows, geo.slices, geo.passes, geo.vector, int(geo.smem_ring),
        geo.chunk_rows, geo.chunks, geo.threads, geo.blocks,
        geo.smem_bytes, _stream(dev))
    _check(err)
    return (v, b_new, c_new) if fold else (v, db)


def routing_stage_update(u_hat: torch.Tensor, s: torch.Tensor, *,
                         l_tile: int = 128, use_approx: bool = False):
    """STAGE 2 of sharded routing, Eq.3 and Eq.4: (û (B,L,H,C), the
    complete vote sum s (B,H,C)) -> (v = squash(s) (B,H,C), this shard's
    logit update db (L,H)), fp32."""
    for name, t in (("u_hat", u_hat), ("s", s)):
        check_no_autograd(t, f"routing_stage_update ({name})")
    fake = fake_mode(u_hat)
    if not fake and plain_mode(u_hat):
        return routing_stage_update_plain(u_hat, s, l_tile=l_tile,
                                          use_approx=use_approx)
    out = _stage_update_launch(u_hat, s, None, l_tile, use_approx, False)
    if not fake:
        routing_stage_update.launches += 1
    return out


routing_stage_update.launches = 0


def routing_stage_update_fold(u_hat: torch.Tensor, s: torch.Tensor,
                              b: torch.Tensor, *, l_tile: int = 128,
                              use_approx: bool = False):
    """STAGE 2 with the next iteration's Eq.5 folded in: (û, s (B,H,C),
    b (L,H)) -> (v (B,H,C), b_new = b + db (L,H), c = softmax_H(b_new)
    (L,H)), fp32.  Legal only where neither B nor H is sharded: db must be
    complete and the softmax shard-local inside the kernel."""
    for name, t in (("u_hat", u_hat), ("s", s), ("b", b)):
        check_no_autograd(t, f"routing_stage_update_fold ({name})")
    fake = fake_mode(u_hat)
    if not fake and plain_mode(u_hat):
        return routing_stage_update_fold_plain(u_hat, s, b, l_tile=l_tile,
                                               use_approx=use_approx)
    out = _stage_update_launch(u_hat, s, b, l_tile, use_approx, True)
    if not fake:
        routing_stage_update_fold.launches += 1
    return out


routing_stage_update_fold.launches = 0


# ---------------------------------------------------------------------------
# EM routing stages (the reference's kernel.py:767-881): the M-step
# aggregates over L, the E-step's softmax is over H
# ---------------------------------------------------------------------------

# em_stage_stats cuts L into chunks so that about this many (b, chunk)
# blocks fill the card: 8 per SM on the H100's 132 SMs
_EM_TARGET_BLOCKS = 8 * 132


def em_stats_chunks(B: int, L: int) -> tuple:
    """(rows per chunk, chunks) of the (b, L-chunk) grids of
    ``em_stage_stats`` and ``routing_stage_votes``: L split so that
    B · chunks is near ``_EM_TARGET_BLOCKS``.  Neither kernel keeps
    per-tile state, so the chunks need not be the reference's L-tiles."""
    want = min(L, max(1, math.ceil(_EM_TARGET_BLOCKS / B)))
    rows = math.ceil(L / want)
    return rows, math.ceil(L / rows)


def em_stage_stats_plain(votes: torch.Tensor, r: torch.Tensor,
                         a_in: torch.Tensor, *, l_tile: int = 128):
    """Plain version of ``em_stage_stats``: the reference's
    ``_em_stats_kernel`` arithmetic over the whole L axis.  Returns
    (Σ_l r·a (B,H), Σ_l r·a·v (B,H,C), Σ_l r·a·v² (B,H,C)), fp32."""
    _check_shape(votes, l_tile)
    v, r, a = votes.float(), r.float(), a_in.float()
    rw = r * a[..., None]                                    # (B, L, H)
    return (torch.sum(rw, dim=1),
            torch.sum(rw[..., None] * v, dim=1),
            torch.sum(rw[..., None] * (v * v), dim=1))


def em_stage_estep_plain(votes: torch.Tensor, mu: torch.Tensor,
                         inv_sigma2: torch.Tensor, bias: torch.Tensor, *,
                         l_tile: int = 128) -> torch.Tensor:
    """Plain version of ``em_stage_estep``: the reference's
    ``_em_estep_kernel`` arithmetic over the whole L axis.  Returns the
    responsibilities r (B,L,H) = softmax_H(bias − ½Σ_c (v−μ)²·(1/σ²))."""
    _check_shape(votes, l_tile)
    v = votes.float()
    d = v - mu.float()[:, None]                              # (B, L, H, C)
    logits = bias.float()[:, None] - 0.5 * torch.sum(
        d * d * inv_sigma2.float()[:, None], dim=-1)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def em_stage_stats(votes: torch.Tensor, r: torch.Tensor, a_in: torch.Tensor,
                   *, l_tile: int = 128):
    """EM M-step sufficient statistics in one pass over the votes:
    votes (B,L,H,C), r (B,L,H), a_in (B,L) -> (Σ_l r·a (B,H),
    Σ_l r·a·v (B,H,C), Σ_l r·a·v² (B,H,C)), fp32.

    ``l_tile`` is the reference's tile, kept for its error surface (L must
    divide by it); the kernel's grid is ``em_stats_chunks``.  ``a_in`` may
    be a broadcast view (stride 0 along L): the kernel reads it by stride."""
    for name, t in (("votes", votes), ("r", r), ("a_in", a_in)):
        check_no_autograd(t, f"em_stage_stats ({name})")
    refuse_fake("em_stage_stats", votes)
    if plain_mode(votes):
        return em_stage_stats_plain(votes, r, a_in, l_tile=l_tile)
    votes, r, a = votes.float(), r.float(), a_in.float()
    B, L, H, C = _check_shape(votes, l_tile)
    _check_elements(B, L, H, C)
    dev = votes.device
    _check_cuda_operand("votes", votes, dev, torch.float32, (B, L, H, C))
    _check_cuda_operand("r", r, dev, torch.float32, (B, L, H))
    if a.device != dev or tuple(a.shape) != (B, L):
        raise ValueError(f"a_in must be ({B}, {L}) on {dev}; got "
                         f"{tuple(a.shape)} on {a.device}")
    lib = cudalib.build()
    rows, chunks = em_stats_chunks(B, L)
    f32 = dict(dtype=torch.float32, device=dev)
    rsum = torch.empty((B, H), **f32)
    rv = torch.empty((B, H, C), **f32)
    rv2 = torch.empty((B, H, C), **f32)
    partial = torch.empty((chunks, B, H, 2 * C + 1), **f32)
    err = lib.em_stage_stats(
        _ptr(votes), _ptr(r), _ptr(a), a.stride(0), a.stride(1), _ptr(rsum),
        _ptr(rv), _ptr(rv2), _ptr(partial), B, L, H, C, rows, chunks,
        _stream(dev))
    _check(err)
    em_stage_stats.launches += 1
    return rsum, rv, rv2


em_stage_stats.launches = 0


def em_stage_estep(votes: torch.Tensor, mu: torch.Tensor,
                   inv_sigma2: torch.Tensor, bias: torch.Tensor, *,
                   l_tile: int = 128) -> torch.Tensor:
    """EM E-step: votes (B,L,H,C), μ and 1/σ² (B,H,C), bias (B,H) ->
    responsibilities r (B,L,H) fp32, a softmax over H.  ``l_tile`` is the
    reference's tile, kept for its error surface; the kernel's grid is
    ``ops.estep_geometry`` (``csrc/em_routing.cu``)."""
    for name, t in (("votes", votes), ("mu", mu),
                    ("inv_sigma2", inv_sigma2), ("bias", bias)):
        check_no_autograd(t, f"em_stage_estep ({name})")
    refuse_fake("em_stage_estep", votes)
    if plain_mode(votes):
        return em_stage_estep_plain(votes, mu, inv_sigma2, bias,
                                    l_tile=l_tile)
    votes = votes.float()
    B, L, H, C = _check_shape(votes, l_tile)
    _check_elements(B, L, H, C)
    dev = votes.device
    mu, inv_sigma2, bias = mu.float(), inv_sigma2.float(), bias.float()
    _check_cuda_operand("votes", votes, dev, torch.float32, (B, L, H, C))
    _check_cuda_operand("mu", mu, dev, torch.float32, (B, H, C))
    _check_cuda_operand("inv_sigma2", inv_sigma2, dev, torch.float32,
                        (B, H, C))
    _check_cuda_operand("bias", bias, dev, torch.float32, (B, H))
    from repro_torch.kernels.routing import ops
    geo = ops.estep_geometry(B, L, H, C)
    aligned = all(t.data_ptr() % 16 == 0 for t in (votes, mu, inv_sigma2))
    lib = cudalib.build()
    r = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    err = lib.em_stage_estep(_ptr(votes), _ptr(mu), _ptr(inv_sigma2),
                             _ptr(bias), _ptr(r), B, L, H, C,
                             geo.rows_per_pass, geo.h_per_lane,
                             geo.vector if aligned else 1, geo.warps,
                             geo.blocks, geo.h_passes, _stream(dev))
    _check(err)
    em_stage_estep.launches += 1
    return r


em_stage_estep.launches = 0

KERNEL_WRAPPERS = (routing_procedure_fused, routing_iteration_fused,
                   routing_procedure_bwd, routing_stage_votes,
                   routing_stage_update, routing_stage_update_fold,
                   em_stage_stats, em_stage_estep)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
