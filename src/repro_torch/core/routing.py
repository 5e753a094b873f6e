"""Dynamic routing procedure (paper Algorithm 1 / Eq.1-5), distribution-aware.

Port of the JAX package's ``repro/core/routing.py``:

    u_hat[k,i,j]   = u[k,i] @ W[i,j]                       (Eq.1, done by caller)
    repeat I times:
        c[i,j]     = softmax_j(b[i,j])                     (Eq.5)
        s[k,j]     = sum_i u_hat[k,i,j] * c[i,j]           (Eq.2)
        v[k,j]     = squash(s[k,j])                        (Eq.3)
        b[i,j]    += sum_k <v[k,j], u_hat[k,i,j]>          (Eq.4)

Distribution (paper §5.1): every equation is independently parallel along at
least one of {B, L, H} (paper Table 2) but no dimension parallelises all
five, so sharding one dimension leaves a small set of cross-shard
aggregations:

    shard B  ->  Eq.4's sum over k crosses shards          (psum of b-updates)
    shard L  ->  Eq.2's sum over i crosses shards          (psum of s)
    shard H  ->  Eq.5's softmax denominator crosses shards (pmax and psum)

``dynamic_routing`` runs unsharded, or as the per-rank body of
``runtime.mesh_utils.shard_call`` with any of the three logical dims mapped
to a mesh axis (``sharded_dim`` + ``axis_name``, or ``axes``): the
collective of ``runtime.mesh_utils`` is inserted exactly where the paper's
inter-vault aggregation happens.
"""
from __future__ import annotations

from typing import Literal, NamedTuple, Optional

import torch

from repro_torch.core import approx
from repro_torch.runtime import mesh_utils

ShardedDim = Optional[Literal["B", "L", "H"]]


class RoutingConfig(NamedTuple):
    """Static routing configuration.

    iterations:   paper Table 1 "Iter" (3..9).
    use_approx:   paper §5.2.2 PE approximations for exp / rsqrt / div.
    sharded_dim:  which logical dimension is sharded across the mesh axis
                  ``axis_name`` (paper §5.1 inter-vault distribution choice).
    axes:         several dims at once, ((dim, axis_name), ...) (e.g. B
                  over "data" x L over "model" on a 2-D mesh); overrides
                  sharded_dim/axis_name when set.
    fused:        route via the CUDA kernels: the per-iteration kernel
                  unsharded, the stage-split kernels with the cross-shard
                  collectives between them when a dim is sharded
                  (``kernels/routing/ops``); the eager loop otherwise.
    """
    iterations: int = 3
    use_approx: bool = False
    sharded_dim: ShardedDim = None
    axis_name: Optional[str] = None
    fused: bool = False
    axes: Optional[tuple] = None    # tuple of (dim, axis_name) pairs

    def axis_of(self, dim: str) -> Optional[str]:
        if self.axes is not None:
            for d, a in self.axes:
                if d == dim:
                    return a
            return None
        return self.axis_name if self.sharded_dim == dim else None


def _softmax(b: torch.Tensor, cfg: RoutingConfig) -> torch.Tensor:
    """softmax over the H dim of b:(L,H); cross-shard when H is sharded."""
    h_axis = cfg.axis_of("H")
    if h_axis is not None:
        m = mesh_utils.pmax(torch.amax(b, dim=-1, keepdim=True), h_axis)
        e = approx.fast_exp(b - m) if cfg.use_approx else torch.exp(b - m)
        denom = mesh_utils.psum(torch.sum(e, dim=-1, keepdim=True), h_axis)
        if cfg.use_approx:
            return e * approx.fast_reciprocal(denom)
        return e / denom
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
    c = _softmax(b, cfg)                                   # Eq.5
    s = torch.einsum("blhc,lh->bhc", u_hat, c)             # Eq.2
    s = mesh_utils.psum(s, cfg.axis_of("L"))               # inter-vault
    v = _squash(s, cfg)                                    # Eq.3
    db = torch.einsum("blhc,bhc->lh", u_hat, v)            # Eq.4 (local)
    db = mesh_utils.psum(db, cfg.axis_of("B"))             # inter-vault
    return v, b + db


def dynamic_routing(u_hat: torch.Tensor,
                    cfg: RoutingConfig = RoutingConfig()) -> torch.Tensor:
    """Run the full routing procedure.  u_hat:(B,L,H,C) -> v:(B,H,C).

    The iteration loop carries b (the paper's strong sequential dependency,
    §2.2 summary point (1)); the final iteration's v is the routed output.
    """
    if cfg.fused:
        from repro_torch.kernels.routing import ops as routing_ops
        axes = dict(cfg.axes or ())
        if not axes and cfg.sharded_dim is not None:
            axes = {cfg.sharded_dim: cfg.axis_name}
        if axes:
            # the stage-split kernels with the Table-2 collectives on the
            # active mesh's axes
            return routing_ops.dynamic_routing_fused_sharded(
                u_hat, axes=axes, iterations=cfg.iterations,
                use_approx=cfg.use_approx)
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
    v, b = _loop_routing(u_hat, cfg)
    return v, b, _softmax(b, cfg)


def make_sharded_routing(mesh, dim: ShardedDim, axis_name: str,
                         cfg: RoutingConfig, *, device="cuda"):
    """The reference's deprecated shim: ``dynamic_routing`` with ``dim``
    sharded over ``axis_name`` of ``mesh``, through ``build_router``."""
    return make_multi_sharded_routing(mesh, ((dim, axis_name),), cfg,
                                      device=device)


def make_multi_sharded_routing(mesh, axes, cfg: RoutingConfig, *,
                               device="cuda"):
    """The reference's deprecated shim for several sharded dims: axes is a
    tuple of (dim, mesh_axis) pairs."""
    from repro_torch.core import router as router_lib
    spec = router_lib.RouterSpec(
        algorithm="dynamic", backend="cuda" if cfg.fused else "torch",
        iterations=cfg.iterations, use_approx=cfg.use_approx)
    plan = router_lib.ExecutionPlan(mesh=mesh, axes=tuple(axes))
    return router_lib.build_router(spec, plan, device=device)
