"""Oracle for the selective-scan kernel (the JAX package's
``kernels/ssm_scan/ref.py``):

    h[t] = exp(dt[t] * A) * h[t-1] + (dt[t] * x[t]) ⊗ B[t]
    y[t] = <h[t], C[t]>_N + D * x[t]

Shapes: x, dt: (Bt, T, Din); A: (Din, N); B, C: (Bt, T, N); D: (Din,).
The reference evaluates the recurrence with ``jax.lax.associative_scan``
over T on the materialised (Bt, T, Din, N) element tensors; this oracle
runs the same combine as a Hillis–Steele prefix scan (log2 T doubling
steps), also materialising them — oracle only.
"""
from __future__ import annotations

import torch


def selective_scan_ref(x, dt, A, B, C, D, h0=None):
    """Returns (y (Bt, T, Din) fp32, h_T (Bt, Din, N) fp32)."""
    x = x.float()
    dt = dt.float()
    a = torch.exp(dt[..., None] * A.float()[None, None])      # (Bt,T,Din,N)
    b = (dt * x)[..., None] * B.float()[:, :, None, :]       # (Bt,T,Din,N)
    if h0 is not None:
        # fold the initial state into the first element
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0.float()
    T = x.shape[1]
    shift = 1
    while shift < T:
        # (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2), element t with t − shift
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        b = torch.cat([b[:, :shift], a[:, shift:] * b_prev + b[:, shift:]], 1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a_prev], 1)
        shift *= 2
    y = torch.einsum("btdn,btn->btd", b, C.float())
    return y + D.float()[None, None] * x, b[:, -1]


def selective_step_ref(h, x_t, dt_t, A, B_t, C_t, D):
    """Single decode step.  h: (Bt, Din, N) -> (y_t (Bt, Din), h_new)."""
    a = torch.exp(dt_t[..., None] * A[None])                 # (Bt,Din,N)
    h_new = a * h + (dt_t * x_t)[..., None] * B_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", h_new, C_t) + D[None] * x_t
    return y, h_new
