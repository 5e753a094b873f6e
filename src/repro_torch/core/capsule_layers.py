"""CapsNet layers (paper §2.1): conv stack, PrimaryCaps, Caps layer (Eq.1 +
routing), the reconstruction decoder and the margin loss.

Port of the JAX package's ``repro/core/capsule_layers.py``.  Parameters live
in ``nn.Module``s whose names follow the reference's tree paths (``conv1.w``,
``caps_conv.b``, ``W``, ``fc0.w`` …); the forward passes are plain
functions on tensors.  Public functions keep the reference's NHWC image
layout; conv weights are stored OIHW, PyTorch's own layout (the reference's
HWIO ``w`` is ``w_torch.permute(2, 3, 1, 0)``).  Random init draws from an
explicit ``torch.Generator`` on the CPU and then moves to ``device``, so the
same seed gives the same weights on every device.  Parameters are trainable;
like every entry point of the port, the constructors default to the card
and raise when there is none (pass ``device="cpu"``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import routing as routing_lib
from repro_torch.core.approx import exact_squash
from repro_torch.kernels import resolve_device
from repro_torch.kernels.caps_conv import ops as caps_conv_ops


def _normal(shape, scale: float, generator: Optional[torch.Generator],
            device) -> nn.Parameter:
    t = torch.randn(shape, generator=generator, dtype=torch.float32) * scale
    return nn.Parameter(t.to(device))


def _zeros(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, device=device))


class Conv2d(nn.Module):
    """A conv's parameters: ``w`` (cout, cin, kh, kw), ``b`` (cout,)."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        scale = 1.0 / math.sqrt(kh * kw * cin)
        self.w = _normal((cout, cin, kh, kw), scale, generator, device)
        self.b = _zeros(cout, device)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight, VALID padding: (B,H,W,Cin) ->
    (B,H',W',Cout)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride)
    return y.permute(0, 2, 3, 1)


class PrimaryCapsConfig(NamedTuple):
    """Conv -> PrimaryCaps mapping (paper Fig.2; CapsNet-MNIST defaults)."""
    conv1_channels: int = 256
    conv1_kernel: int = 9
    caps_channels: int = 32      # capsule map count
    caps_dim: int = 8            # C_L
    caps_kernel: int = 9
    caps_stride: int = 2


class PrimaryCaps(nn.Module):
    """``conv1`` (9×9 + ReLU) and ``caps_conv`` (9×9, stride 2)."""

    def __init__(self, in_channels: int, cfg: PrimaryCapsConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.conv1 = Conv2d(cfg.conv1_kernel, cfg.conv1_kernel, in_channels,
                            cfg.conv1_channels, generator=generator,
                            device=device)
        self.caps_conv = Conv2d(cfg.caps_kernel, cfg.caps_kernel,
                                cfg.conv1_channels,
                                cfg.caps_channels * cfg.caps_dim,
                                generator=generator, device=device)


def primary_caps_forward(primary: PrimaryCaps, x: torch.Tensor,
                         cfg: PrimaryCapsConfig,
                         caps_conv: str = "kernel") -> torch.Tensor:
    """x: (B,H,W,C) image -> u: (B, N_L, C_L) squashed primary capsules.

    ``conv1`` runs on ``F.conv2d``: its NCHW view of the NHWC image has
    channels-last strides, so its output, and the ReLU's, is NHWC
    contiguous.  The caps conv reads that activation as it lies, by
    ``caps_conv`` (``kernels.caps_conv.ops``: "kernel", the split-TF32
    kernel on the card and ``F.conv2d`` on the CPU; "library",
    ``F.conv2d``).  The
    capsule grid is read from the NHWC activation (B, H, W, caps·dim),
    exactly as the reference reshapes it, so capsule i is the same
    (position, map) pair in both packages."""
    h = F.relu(conv2d(x, primary.conv1.w, primary.conv1.b))
    h = caps_conv_ops.caps_conv(h, primary.caps_conv.w, primary.caps_conv.b,
                                cfg.caps_stride, caps_conv)
    B, H, W, _ = h.shape
    u = h.reshape(B, H * W * cfg.caps_channels, cfg.caps_dim)
    return exact_squash(u, axis=-1)


class CapsLayer(nn.Module):
    """``W``: (N_L, N_H, C_L, C_H) — the Eq.1 prediction weight."""

    def __init__(self, n_l: int, n_h: int, c_l: int, c_h: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.W = _normal((n_l, n_h, c_l, c_h), 1.0 / math.sqrt(c_l),
                         generator, resolve_device(device))


def predict_votes(digit: CapsLayer, u: torch.Tensor) -> torch.Tensor:
    """Eq.1: u_hat[k,i,j] = u[k,i] @ W[i,j].   u:(B,L,C_L) -> (B,L,H,C_H)."""
    return torch.einsum("blc,lhcd->blhd", u, digit.W)


def route_votes(u_hat: torch.Tensor, route, device="cuda") -> torch.Tensor:
    """The routing procedure over the Eq.1 votes.  u_hat:(B,L,H,C_H) ->
    v:(B,H,C_H).

    ``route`` is a built Router (or any callable u_hat -> v), a
    ``RouterSpec`` (built on the spot for ``device``, unsharded), or a
    ``RoutingConfig`` (runs ``dynamic_routing`` directly)."""
    if isinstance(route, routing_lib.RoutingConfig):
        return routing_lib.dynamic_routing(u_hat, route)
    from repro_torch.core import router as router_lib
    if isinstance(route, router_lib.RouterSpec):
        return router_lib.build_router(route, device=device)(u_hat)
    if callable(route):
        return route(u_hat)
    raise TypeError(
        f"route must be a Router/callable, RouterSpec, or RoutingConfig; "
        f"got {type(route).__name__}")


# --- decoding stage (paper §2.1: FC reconstruction decoder) ----------------

class Dense(nn.Module):
    """``w`` (din, dout), ``b`` (dout,): y = x @ w + b, as the reference."""

    def __init__(self, din: int, dout: int, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.w = _normal((din, dout), 1.0 / math.sqrt(din), generator, device)
        self.b = _zeros(dout, device)


class Decoder(nn.Module):
    """``fc0`` .. ``fc{n}``: ReLU hidden layers, sigmoid output."""

    def __init__(self, n_h: int, c_h: int, out_dim: int,
                 hidden=(512, 1024), *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dims = [n_h * c_h, *hidden, out_dim]
        for i in range(len(dims) - 1):
            self.add_module(f"fc{i}", Dense(dims[i], dims[i + 1],
                                            generator=generator,
                                            device=device))


def decoder_forward(decoder: Decoder, v: torch.Tensor,
                    labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reconstruction decoder: mask all but the (label|longest) capsule."""
    B, H, C = v.shape
    norms = torch.linalg.vector_norm(v, dim=-1)
    idx = torch.argmax(norms, dim=-1) if labels is None else labels.long()
    mask = F.one_hot(idx, H).to(v.dtype)[..., None]
    h = (v * mask).reshape(B, H * C)
    layers = list(decoder.children())
    for i, fc in enumerate(layers):
        h = h @ fc.w + fc.b
        h = F.relu(h) if i < len(layers) - 1 else torch.sigmoid(h)
    return h


def margin_loss(v: torch.Tensor, labels: torch.Tensor, n_classes: int,
                m_pos: float = 0.9, m_neg: float = 0.1,
                lam: float = 0.5) -> torch.Tensor:
    """CapsNet margin loss [Sabour et al. 2017, Eq.4]."""
    norms = torch.linalg.vector_norm(v, dim=-1)  # (B, H)
    t = F.one_hot(labels.long(), n_classes).to(norms.dtype)
    l_pos = t * torch.square(torch.clamp(m_pos - norms, min=0.0))
    l_neg = lam * (1.0 - t) * torch.square(torch.clamp(norms - m_neg,
                                                       min=0.0))
    return torch.mean(torch.sum(l_pos + l_neg, dim=-1))
