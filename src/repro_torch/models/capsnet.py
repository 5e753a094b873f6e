"""CapsNet (paper §2.1 / Fig.2): Conv → PrimaryCaps → DigitCaps(+RP) → decoder.

Port of the JAX package's ``repro/models/capsnet.py``.  ``CapsNet`` is an
``nn.Module`` with the submodules ``primary``, ``digit`` and ``decoder``;
its parameter names follow the reference's tree paths (``primary.conv1.w``,
``digit.W``, ``decoder.fc0.w`` …), so ``repro_torch.convert`` carries a
JAX parameter tree across leaf by leaf.  ``primary_caps``,
``encode_votes``, ``forward`` and ``loss_fn`` are the reference's
functions over a ``CapsNet`` in place of (params, cfg).  The parameters are
trainable; serving runs under ``torch.inference_mode()`` and builds no
graph.  ``forward`` runs the encoder stage in the ``capsnet.encode`` span
(``runtime.spans``); routing opens its own.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.caps_benchmarks import CapsConfig
from repro_torch.core import capsule_layers as CL
from repro_torch.core import router as router_lib
from repro_torch.core import routing as routing_lib
from repro_torch.kernels import resolve_device
from repro_torch.runtime import spans


def _pc_cfg(cfg: CapsConfig) -> CL.PrimaryCapsConfig:
    return CL.PrimaryCapsConfig(
        conv1_channels=cfg.conv_channels, caps_channels=cfg.caps_channels,
        caps_dim=cfg.l_caps_dim)


class CapsNet(nn.Module):
    """The paper's CapsNet for one Table-1 configuration.

    ``device`` defaults to the card and raises when there is none (pass
    "cpu" to run on the CPU).  Weights are random, drawn from
    ``generator`` (or ``torch.Generator().manual_seed(seed)``) on the CPU,
    so a seed gives the same weights on every device.
    """

    def __init__(self, cfg: CapsConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.cfg = cfg
        self.primary = CL.PrimaryCaps(cfg.image_channels, _pc_cfg(cfg),
                                      generator=generator, device=dev)
        self.digit = CL.CapsLayer(cfg.num_l_caps, cfg.num_h_caps,
                                  cfg.l_caps_dim, cfg.h_caps_dim,
                                  generator=generator, device=dev)
        self.decoder = CL.Decoder(cfg.num_h_caps, cfg.h_caps_dim,
                                  cfg.image_hw * cfg.image_hw
                                  * cfg.image_channels,
                                  generator=generator, device=dev)

    @property
    def device(self) -> torch.device:
        return self.digit.W.device

    def forward(self, images: torch.Tensor, routing_cfg=None, labels=None,
                router=None) -> Dict[str, torch.Tensor]:
        return forward(self, images, routing_cfg, labels, router=router)


def primary_caps(net: CapsNet, images: torch.Tensor,
                 caps_conv: str = "kernel") -> torch.Tensor:
    """Conv stack + PrimaryCaps.  images: (B,H,W,C) -> u: (B, N_L, C_L).

    If the conv pipeline's capsule grid does not match num_l_caps (the
    Table-1 configs imply differing caps-map counts), it is cropped or
    tiled to the configured N_L, as the reference does — so the routing
    workload is always exactly (N_L, N_H, C_L, C_H).  ``caps_conv`` picks
    the caps conv's implementation (``CL.primary_caps_forward``)."""
    cfg = net.cfg
    u = CL.primary_caps_forward(net.primary, images, _pc_cfg(cfg), caps_conv)
    n = u.shape[1]
    if n < cfg.num_l_caps:
        reps = -(-cfg.num_l_caps // n)
        u = u.repeat(1, reps, 1)
    return u[:, :cfg.num_l_caps]


def encode_votes(net: CapsNet, images: torch.Tensor,
                 caps_conv: str = "kernel") -> torch.Tensor:
    """The §4 pipeline's encoder stage: conv stack + PrimaryCaps + the Eq.1
    vote projection.  images (B,H,W,C) -> u_hat (B, N_L, N_H, C_H)."""
    u = primary_caps(net, images, caps_conv)
    return CL.predict_votes(net.digit, u)


def forward(net: CapsNet, images: torch.Tensor,
            routing_cfg: Optional[routing_lib.RoutingConfig] = None,
            labels: Optional[torch.Tensor] = None,
            router=None, caps_conv: str = "kernel") -> Dict[str, torch.Tensor]:
    """Full inference: returns {v, class_probs, reconstruction}.

    ``router``: a built Router / callable or a ``RouterSpec`` (built for
    the net's device); ``routing_cfg``: a ``RoutingConfig``.  With neither,
    exact dynamic routing on the torch backend.  ``caps_conv``: the caps
    conv's implementation (``CL.primary_caps_forward``)."""
    route = router if router is not None else routing_cfg
    if route is None:
        route = router_lib.RouterSpec(iterations=net.cfg.routing_iters)
    with spans.span("capsnet.encode"):
        u_hat = encode_votes(net, images, caps_conv)
    v = CL.route_votes(u_hat, route, device=net.device)
    probs = torch.linalg.vector_norm(v, dim=-1)
    recon = CL.decoder_forward(net.decoder, v, labels)
    return {"v": v, "class_probs": probs, "reconstruction": recon}


def loss_fn(net: CapsNet, images: torch.Tensor, labels: torch.Tensor,
            routing_cfg: Optional[routing_lib.RoutingConfig] = None,
            recon_weight: float = 0.0005, router=None,
            caps_conv: str = "kernel"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Margin loss plus the weighted reconstruction error, as the
    reference's ``loss_fn``.  Returns (loss, {margin, recon, accuracy}).
    ``caps_conv``: the caps conv's implementation
    (``CL.primary_caps_forward``)."""
    out = forward(net, images, routing_cfg, labels, router=router,
                  caps_conv=caps_conv)
    margin = CL.margin_loss(out["v"], labels, net.cfg.num_h_caps)
    flat = images.reshape(images.shape[0], -1)
    recon = torch.mean(torch.square(out["reconstruction"] - flat))
    loss = margin + recon_weight * recon
    acc = torch.mean((torch.argmax(out["class_probs"], -1)
                      == labels.long()).float())
    return loss, {"margin": margin, "recon": recon, "accuracy": acc}
