"""The plain reference of the benchmark's CapsNet cells.

CapsNet as Sabour et al. (arXiv:1710.09829) define it and the paper's Table 1
sizes it (arXiv:1911.03451): Conv 9x9 + ReLU, PrimaryCaps (a 9x9 stride-2
conv whose NHWC activation is read as capsules, squashed), the Eq.1 votes,
dynamic routing (Eqs. 2-5, the logits ``b`` shared over the B rows of a
microbatch), class scores ||v||, the margin loss with the reconstruction
decoder, global-norm clipping and AdamW under a linear-warmup cosine
schedule.

Plain PyTorch in fp32 on tensors of the benchmark's own making: no kernel,
no batching trick, nothing of the measured program.  The weights are a
dict from the program's parameter names to tensors (conv weights OIHW,
``digit.W`` (L, H, C_L, C_H), dense ``w`` (din, dout)), so the benchmark
hands the same tensors to both sides.

``tf32=True`` is the control: the same arithmetic with the convolutions'
and products' operands in TF32.  On a card it turns on the TF32 paths of
cuDNN and cuBLAS; on the CPU, which has none, it rounds the operands of
every forward convolution and product to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

SQUASH_EPS = 1e-9


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (10 explicit mantissa bits,
    ties away from zero on the dropped 13 bits)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision:
    """fp32 with TF32 off (``tf32=False``), or the TF32 control."""

    def __init__(self, tf32: bool, device: torch.device):
        self.tf32 = tf32
        self.emulate = tf32 and device.type != "cuda"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if not self.emulate:
            return x
        # rounded forward, the gradient passed straight through
        return x + (round_tf32(x.detach()) - x.detach())

    @contextlib.contextmanager
    def scope(self):
        m = torch.backends.cuda.matmul.allow_tf32
        c = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = m
            torch.backends.cudnn.allow_tf32 = c


def squash(s: torch.Tensor) -> torch.Tensor:
    """Eq.3 over the last dim: |s|^2 / (1 + |s|^2) * s / |s|."""
    n2 = torch.sum(s * s, dim=-1, keepdim=True)
    return s * (n2 / (1.0 + n2)) / torch.sqrt(n2 + SQUASH_EPS)


def _conv(x, w, b, stride, prec: Precision):
    return F.conv2d(prec.operand(x), prec.operand(w), b, stride=stride)


def _einsum(eq: str, a, b, prec: Precision):
    return torch.einsum(eq, prec.operand(a), prec.operand(b))


def primary_caps(w: Weights, images: torch.Tensor, cfg: dict,
                 prec: Precision) -> torch.Tensor:
    """images (B, H, W, C) -> u (B, L, C_L): the conv stack, the NHWC grid
    read as (position, map) capsules, cropped or tiled to L, squashed."""
    x = images.permute(0, 3, 1, 2)
    h = F.relu(_conv(x, w["primary.conv1.w"], w["primary.conv1.b"], 1, prec))
    h = _conv(h, w["primary.caps_conv.w"], w["primary.caps_conv.b"],
              cfg["caps_stride"], prec)
    h = h.permute(0, 2, 3, 1)
    B, S1, S2, _ = h.shape
    u = h.reshape(B, S1 * S2 * cfg["caps_channels"], cfg["l_caps_dim"])
    L = cfg["num_l_caps"]
    if u.shape[1] < L:
        u = u.repeat(1, -(-L // u.shape[1]), 1)
    return squash(u[:, :L])


def votes(w: Weights, images: torch.Tensor, cfg: dict,
          prec: Precision) -> torch.Tensor:
    """Eq.1: u_hat[k, i, j] = u[k, i] @ W[i, j] -> (B, L, H, C_H)."""
    u = primary_caps(w, images, cfg, prec)
    return _einsum("blc,lhcd->blhd", u, w["digit.W"], prec)


def route(u_hat: torch.Tensor, iterations: int,
          prec: Precision) -> torch.Tensor:
    """Dynamic routing over one microbatch, b (L, H) shared by its rows.
    u_hat (B, L, H, C) -> v (B, H, C)."""
    B, L, H, C = u_hat.shape
    b = torch.zeros((L, H), dtype=torch.float32, device=u_hat.device)
    v = None
    for _ in range(iterations):
        c = torch.softmax(b, dim=-1)                           # Eq.5
        s = _einsum("blhc,lh->bhc", u_hat, c, prec)            # Eq.2
        v = squash(s)                                          # Eq.3
        b = b + _einsum("blhc,bhc->lh", u_hat, v, prec)        # Eq.4
    return v


def wave_scores(w: Weights, images: torch.Tensor, mask: torch.Tensor,
                cfg: dict, tf32: bool = False) -> torch.Tensor:
    """Class scores of one serving wave.  images (n_micro, mb, H, W, C),
    mask (n_micro, mb) of 1 for a lane that holds an image -> ||v||
    (n_micro, mb, N_H).  Each microbatch routes on its own; a masked lane's
    votes are zero, so it adds nothing to any sum over the microbatch."""
    prec = Precision(tf32, images.device)
    out = []
    with torch.no_grad(), prec.scope():
        for t in range(images.shape[0]):
            u_hat = votes(w, images[t], cfg, prec)
            u_hat = u_hat * mask[t][:, None, None, None]
            v = route(u_hat, cfg["routing_iters"], prec)
            out.append(torch.linalg.vector_norm(v, dim=-1))
    return torch.stack(out)


def decoder(w: Weights, v: torch.Tensor, labels: torch.Tensor, cfg: dict,
            prec: Precision) -> torch.Tensor:
    """The reconstruction decoder on the label's capsule alone."""
    B, H, C = v.shape
    mask = F.one_hot(labels.long(), H).to(v.dtype)[..., None]
    h = (v * mask).reshape(B, H * C)
    n = len(cfg["decoder_hidden"]) + 1
    for i in range(n):
        h = prec.operand(h) @ prec.operand(w[f"decoder.fc{i}.w"])
        h = h + w[f"decoder.fc{i}.b"]
        h = F.relu(h) if i < n - 1 else torch.sigmoid(h)
    return h


def margin_loss(v: torch.Tensor, labels: torch.Tensor, n_classes: int,
                m_pos: float = 0.9, m_neg: float = 0.1,
                lam: float = 0.5) -> torch.Tensor:
    norms = torch.linalg.vector_norm(v, dim=-1)
    t = F.one_hot(labels.long(), n_classes).to(norms.dtype)
    pos = t * torch.square(torch.clamp(m_pos - norms, min=0.0))
    neg = lam * (1.0 - t) * torch.square(torch.clamp(norms - m_neg, min=0.0))
    return torch.mean(torch.sum(pos + neg, dim=-1))


def loss(w: Weights, images: torch.Tensor, labels: torch.Tensor, cfg: dict,
         prec: Precision) -> torch.Tensor:
    """Margin loss plus recon_weight x the reconstruction's mean squared
    error, over one batch routed as one microbatch."""
    u_hat = votes(w, images, cfg, prec)
    v = route(u_hat, cfg["routing_iters"], prec)
    margin = margin_loss(v, labels, cfg["num_h_caps"])
    recon = decoder(w, v, labels, cfg, prec)
    flat = images.reshape(images.shape[0], -1)
    return margin + cfg["recon_weight"] * torch.mean(
        torch.square(recon - flat))


def lr_scale(step: int, warmup: int, total: int,
             final_frac: float = 0.1) -> float:
    """Linear warmup to 1 over ``warmup`` steps, then a cosine down to
    ``final_frac`` at ``total``; ``step`` is 1-based (the step being
    taken)."""
    warm = min(step / max(warmup, 1), 1.0)
    t = min(max(step - warmup, 0) / max(total - warmup, 1), 1.0)
    return warm * (final_frac + (1.0 - final_frac)
                   * 0.5 * (1.0 + math.cos(math.pi * t)))


def train(w: Weights, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          cfg: dict, opt: dict, tf32: bool = False,
          start: Optional[Tuple[Weights, Weights, int]] = None) -> dict:
    """``len(batches)`` training steps from the weights ``w`` (left as they
    are).  ``opt``: lr, b1, b2, eps, weight_decay, max_grad_norm, warmup,
    total_steps.  ``start``: the AdamW moments (mu, nu) and the number of
    steps already taken, to go on from; by default none.  Returns each
    step's loss, the first step's clipped gradients and the weights after
    the last step."""
    device = next(iter(w.values())).device
    prec = Precision(tf32, device)
    params = {k: t.detach().clone() for k, t in w.items()}
    if start is None:
        mu = {k: torch.zeros_like(t) for k, t in params.items()}
        nu = {k: torch.zeros_like(t) for k, t in params.items()}
        taken = 0
    else:
        mu = {k: t.detach().clone() for k, t in start[0].items()}
        nu = {k: t.detach().clone() for k, t in start[1].items()}
        taken = start[2]
    losses: List[float] = []
    first_grads = None
    b1, b2 = opt["b1"], opt["b2"]
    with prec.scope():
        for step, (images, labels) in enumerate(batches, start=taken + 1):
            leaves = {k: t.requires_grad_(True) for k, t in params.items()}
            value = loss(leaves, images, labels, cfg, prec)
            grads = dict(zip(leaves, torch.autograd.grad(
                value, list(leaves.values()))))
            losses.append(float(value.detach()))
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(torch.square(g))
                                      for g in grads.values()))
                clip = torch.clamp(opt["max_grad_norm"]
                                   / torch.clamp(norm, min=1e-9), max=1.0)
                grads = {k: g * clip for k, g in grads.items()}
                if first_grads is None:
                    first_grads = {k: g.clone() for k, g in grads.items()}
                lr = opt["lr"] * lr_scale(step, opt["warmup"],
                                          opt["total_steps"])
                new = {}
                for k, p in params.items():
                    g = grads[k]
                    mu[k] = b1 * mu[k] + (1 - b1) * g
                    nu[k] = b2 * nu[k] + (1 - b2) * torch.square(g)
                    mhat = mu[k] / (1.0 - b1 ** step)
                    vhat = nu[k] / (1.0 - b2 ** step)
                    delta = mhat / (torch.sqrt(vhat) + opt["eps"])
                    if p.dim() >= 2:          # decay matrices only
                        delta = delta + opt["weight_decay"] * p
                    new[k] = p.detach() - lr * delta
                params = new
    return {"losses": losses, "first_grads": first_grads, "params": params}
