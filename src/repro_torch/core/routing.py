"""Dynamic routing procedure (paper Algorithm 1 / Eq.1-5), unsharded.

Port of the JAX package's ``repro/core/routing.py``:

    u_hat[k,i,j]   = u[k,i] @ W[i,j]                       (Eq.1, done by caller)
    repeat I times:
        c[i,j]     = softmax_j(b[i,j])                     (Eq.5)
        s[k,j]     = sum_i u_hat[k,i,j] * c[i,j]           (Eq.2)
        v[k,j]     = squash(s[k,j])                        (Eq.3)
        b[i,j]    += sum_k <v[k,j], u_hat[k,i,j]>          (Eq.4)

This slice runs the procedure on one device.  The reference's distributed
forms (``sharded_dim``/``axes``: the paper's Table-2 cross-shard
aggregations) belong to the distribution slice and raise here.
"""
from __future__ import annotations

from typing import Literal, NamedTuple, Optional

import torch

from repro_torch import slices
from repro_torch.core import approx

ShardedDim = Optional[Literal["B", "L", "H"]]


class RoutingConfig(NamedTuple):
    """Static routing configuration.

    iterations:   paper Table 1 "Iter" (3..9).
    use_approx:   paper §5.2.2 PE approximations for exp / rsqrt / div.
    sharded_dim / axis_name / axes: the reference's distribution knobs;
                  kept for signature parity, they raise until slice 5.
    fused:        route via the CUDA per-iteration kernel
                  (``kernels/routing/ops.dynamic_routing_fused``); the plain
                  eager loop otherwise.
    """
    iterations: int = 3
    use_approx: bool = False
    sharded_dim: ShardedDim = None
    axis_name: Optional[str] = None
    fused: bool = False
    axes: Optional[tuple] = None    # tuple of (dim, axis_name) pairs


def _check_unsharded(cfg: RoutingConfig) -> None:
    if cfg.axes or cfg.sharded_dim is not None:
        raise slices.not_ported(
            "sharded routing (RoutingConfig.sharded_dim / axes — the "
            "paper's Table-2 cross-shard aggregations)", slices.DISTRIBUTION)


def _softmax(b: torch.Tensor, cfg: RoutingConfig) -> torch.Tensor:
    """softmax over the H dim of b:(L,H)."""
    if cfg.use_approx:
        return approx.approx_softmax(b, axis=-1)
    return torch.softmax(b, dim=-1)


def _squash(s: torch.Tensor, cfg: RoutingConfig) -> torch.Tensor:
    if cfg.use_approx:
        return approx.approx_squash(s, axis=-1)
    return approx.exact_squash(s, axis=-1)


def routing_iteration(u_hat: torch.Tensor, b: torch.Tensor,
                      cfg: RoutingConfig):
    """One full routing iteration. u_hat:(B,L,H,C)  b:(L,H) -> (v, new_b)."""
    _check_unsharded(cfg)
    c = _softmax(b, cfg)                                   # Eq.5
    s = torch.einsum("blhc,lh->bhc", u_hat, c)             # Eq.2
    v = _squash(s, cfg)                                    # Eq.3
    db = torch.einsum("blhc,bhc->lh", u_hat, v)            # Eq.4
    return v, b + db


def dynamic_routing(u_hat: torch.Tensor,
                    cfg: RoutingConfig = RoutingConfig()) -> torch.Tensor:
    """Run the full routing procedure.  u_hat:(B,L,H,C) -> v:(B,H,C).

    The iteration loop carries b (the paper's strong sequential dependency,
    §2.2 summary point (1)); the final iteration's v is the routed output.
    """
    _check_unsharded(cfg)
    if cfg.fused:
        from repro_torch.kernels.routing import ops as routing_ops
        return routing_ops.dynamic_routing_fused(
            u_hat, iterations=cfg.iterations, use_approx=cfg.use_approx)
    v, _ = _loop_routing(u_hat, cfg)
    return v


def _loop_routing(u_hat: torch.Tensor, cfg: RoutingConfig):
    """The eager iteration loop shared by ``dynamic_routing`` and
    ``dynamic_routing_with_stats``.  Returns (final v, final b)."""
    u_hat = u_hat.float()
    B, L, H, C = u_hat.shape
    b = torch.zeros((L, H), dtype=torch.float32, device=u_hat.device)
    v = None
    for _ in range(cfg.iterations):
        v, b = routing_iteration(u_hat, b, cfg)
    return v, b


def dynamic_routing_with_stats(u_hat: torch.Tensor,
                               cfg: RoutingConfig = RoutingConfig()):
    """Like ``dynamic_routing`` but also returns (b, c) for inspection/tests
    (eager path only — the kernels keep b on the card)."""
    _check_unsharded(cfg)
    v, b = _loop_routing(u_hat, cfg)
    return v, b, _softmax(b, cfg)
