"""Eager oracle for the routing kernels — the lazy-update schedule, every
intermediate materialised (the JAX package's ``kernels/routing/ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.core import approx


def softmax_h(b: torch.Tensor, use_approx: bool = False) -> torch.Tensor:
    if use_approx:
        return approx.approx_softmax(b, axis=-1)
    return torch.softmax(b, dim=-1)


def squash(s: torch.Tensor, use_approx: bool = False) -> torch.Tensor:
    if use_approx:
        return approx.approx_squash(s, axis=-1)
    return approx.exact_squash(s, axis=-1)


def routing_iteration_ref(u_hat: torch.Tensor, b: torch.Tensor,
                          v_prev: torch.Tensor, use_approx: bool = False):
    """One *lazy-update* routing iteration, matching the kernels' schedule:

    given v_prev (the previous iteration's H-capsules, zeros on iteration 0):
        b'   = b + sum_k <v_prev[k], u_hat[k]>      (Eq.4, deferred)
        c    = softmax_H(b')                        (Eq.5)
        s    = sum_i c * u_hat                      (Eq.2)
    returns (s, b').  The caller applies squash (Eq.3) and loops.

    Algebraically identical to Algorithm 1: iteration t's b-update uses
    iteration t-1's v, and b0 = 0 with v_prev0 = 0 leaves b unchanged.
    """
    u_hat = u_hat.float()
    db = torch.einsum("blhc,bhc->lh", u_hat, v_prev)
    b_new = b + db
    c = softmax_h(b_new, use_approx)
    s = torch.einsum("blhc,lh->bhc", u_hat, c)
    return s, b_new


def dynamic_routing_ref(u_hat: torch.Tensor, iterations: int,
                        use_approx: bool = False) -> torch.Tensor:
    """Full routing loop via the lazy-update schedule. u_hat:(B,L,H,C)->(B,H,C)."""
    u_hat = u_hat.float()
    B, L, H, C = u_hat.shape
    b = torch.zeros((L, H), dtype=torch.float32, device=u_hat.device)
    v = torch.zeros((B, H, C), dtype=torch.float32, device=u_hat.device)
    for _ in range(iterations):
        s, b = routing_iteration_ref(u_hat, b, v, use_approx)
        v = squash(s, use_approx)
    return v
