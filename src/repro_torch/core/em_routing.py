"""EM routing [Hinton, Sabour, Frosst 2018] — paper §2.2: "the routing
algorithms (e.g., Dynamic Routing, Expectation-Maximization Routing) share
the similar execution pattern".

Port of the JAX package's ``repro/core/em_routing.py``: matrix-capsule EM
routing over the same (B,L,H,C) vote layout, the E-step aggregating over H
(softmax-like) and the M-step over L — the same Table-2 dimension
structure as dynamic routing.  ``em_routing`` is the eager oracle that the
cuda backend's stage kernels (``kernels/routing/ops.em_routing_fused``) are
held against.  Sharded over L, the M-step's three sums over L become psums
over the mesh axis (``runtime.mesh_utils``); sharded over B, every shard is
independent and no collective runs.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.runtime import mesh_utils


class EMRoutingConfig(NamedTuple):
    iterations: int = 3
    beta_a: float = 1.0          # activation bias
    beta_u: float = 1.0          # per-dim cost bias
    inv_temp: float = 1.0        # lambda schedule base
    sharded_dim: Optional[str] = None   # "B" | "L" | None
    axis_name: Optional[str] = None
    eps: float = 1e-9


def em_routing(votes: torch.Tensor, a_in: torch.Tensor,
               cfg: EMRoutingConfig = EMRoutingConfig()):
    """votes: (B,L,H,C) vote vectors; a_in: (B,L) L-capsule activations.

    Returns (pose (B,H,C), a_out (B,H))."""
    votes = votes.float()
    B, L, H, C = votes.shape
    f32 = dict(dtype=torch.float32, device=votes.device)
    r = torch.full((B, L, H), 1.0 / H, **f32)
    mu = torch.zeros((B, H, C), **f32)
    a_out = torch.zeros((B, H), **f32)

    def psum_l(x):
        if cfg.sharded_dim == "L":
            return mesh_utils.psum(x, cfg.axis_name)
        return x

    for it in range(cfg.iterations):
        lam = cfg.inv_temp * (1.0 - 0.95 ** (it + 1))
        # ---- M-step: per-H Gaussian stats, aggregation over L ----
        rw = r * a_in[..., None]                       # (B,L,H)
        r_sum = psum_l(torch.sum(rw, dim=1)) + cfg.eps  # (B,H)
        mu = psum_l(torch.einsum("blh,blhc->bhc", rw, votes)) \
            / r_sum[..., None]
        diff2 = torch.square(votes - mu[:, None])
        sigma2 = psum_l(torch.einsum("blh,blhc->bhc", rw, diff2)) \
            / r_sum[..., None] + cfg.eps
        cost = (cfg.beta_u + 0.5 * torch.log(sigma2)) * r_sum[..., None]
        a_out = torch.sigmoid(lam * (cfg.beta_a - torch.sum(cost, dim=-1)))
        # ---- E-step: responsibilities, softmax over H (H is never
        # ---- sharded, so it is local) ----
        log_p = -0.5 * torch.sum(torch.log(2.0 * math.pi * sigma2[:, None])
                                 + diff2 / sigma2[:, None], dim=-1)
        logits = torch.log(a_out[:, None] + cfg.eps) + log_p
        r = torch.softmax(logits, dim=-1)
    return mu, a_out


def make_sharded_em_routing(mesh, dim: str, axis_name: str,
                            cfg: EMRoutingConfig = EMRoutingConfig(),
                            backend: str = "torch", *, device="cuda"):
    """The reference's deprecated shim: EM routing with ``dim`` ("B" or
    "L") sharded over ``axis_name`` of ``mesh``, through ``build_router``.
    "L" psums the M-step's sums over L; "B" needs no collective (EM keeps
    no cross-batch state).  ``backend="cuda"`` runs the stage kernels."""
    from repro_torch.core import router as router_lib
    spec = router_lib.RouterSpec(
        algorithm="em", backend=backend,
        iterations=cfg.iterations).with_options(
            beta_a=cfg.beta_a, beta_u=cfg.beta_u,
            inv_temp=cfg.inv_temp, eps=cfg.eps)
    plan = router_lib.ExecutionPlan(mesh=mesh, axes=((dim, axis_name),))
    return router_lib.build_router(spec, plan, device=device)
