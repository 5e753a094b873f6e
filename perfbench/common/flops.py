"""Closed-form operation and byte counts of the CapsNet cells.

Operations are those of the products (convolutions, the Eq.1 votes, the
routing sums Eq.2 and Eq.4, the decoder's dense layers), two to a
multiply-add, as the plain reference computes them; element-wise work
(squash, softmax, norms, the loss) is not counted.  The tests hold these
counts to ``torch.utils.flop_counter.FlopCounterMode`` on the reference.
Bytes are each input of a function read once and each output written
once, in fp32.
"""
from __future__ import annotations

F32 = 4


def _conv_out(hw: int, k: int, stride: int) -> int:
    return (hw - k) // stride + 1


def forward_parts(cfg: dict) -> dict:
    """Operations a single image needs in each part of the forward pass."""
    k = cfg["conv_kernel"]
    s1 = _conv_out(cfg["image_hw"], k, 1)
    s2 = _conv_out(s1, cfg["caps_kernel"], cfg["caps_stride"])
    c1 = cfg["conv_channels"]
    caps = cfg["caps_channels"] * cfg["l_caps_dim"]
    L, H = cfg["num_l_caps"], cfg["num_h_caps"]
    CL, CH = cfg["l_caps_dim"], cfg["h_caps_dim"]
    route_sum = 2 * L * H * CH                    # one Eq.2 or one Eq.4
    dims = [H * CH, *cfg["decoder_hidden"],
            cfg["image_hw"] ** 2 * cfg["image_channels"]]
    return {
        "conv1": 2 * s1 * s1 * c1 * k * k * cfg["image_channels"],
        "primary_caps": 2 * s2 * s2 * caps * cfg["caps_kernel"] ** 2 * c1,
        "votes": 2 * L * H * CL * CH,
        "routing": 2 * cfg["routing_iters"] * route_sum,
        "decoder": sum(2 * a * b for a, b in zip(dims, dims[1:])),
    }


def serve_flops_per_image(cfg: dict) -> int:
    """A served image: encoder, votes and routing; scores are ||v||, no
    decoder."""
    p = forward_parts(cfg)
    return p["conv1"] + p["primary_caps"] + p["votes"] + p["routing"]


def train_flops_per_image(cfg: dict) -> int:
    """A trained image: the forward with the decoder, and the backward as
    autograd runs it on the reference.  Every product's backward costs
    twice its forward (both operands' gradients) except: the first conv,
    whose input is the image (the weight's gradient alone); the first
    iteration's Eq.2, whose couplings are the constant softmax of zero
    logits (the votes' gradient alone); the last iteration's Eq.4, whose
    logits nothing reads (no backward)."""
    p = forward_parts(cfg)
    it = cfg["routing_iters"]
    route_sum = p["routing"] // (2 * it)
    forward = sum(p.values())
    backward = (p["conv1"] + 2 * p["primary_caps"] + 2 * p["votes"]
                + 2 * p["decoder"]
                + route_sum * (1 + 2 * (it - 1))      # Eq.2
                + route_sum * 2 * (it - 1))           # Eq.4
    return forward + backward


def votes_bytes(cfg: dict, batch: int) -> int:
    return batch * cfg["num_l_caps"] * cfg["num_h_caps"] * \
        cfg["h_caps_dim"] * F32


def routing_bound_s(cfg: dict, batch: int, peak_flops: float,
                    peak_bytes_s: float, backward: bool = False) -> float:
    """The least time one routing call over a microbatch of ``batch`` rows
    can take: the larger of its bytes over the memory bandwidth and its
    operations over the peak.  Forward: û read once, v written once;
    operations I Eq.2 and I - 1 Eq.4 (the last logits are never read).
    Backward: û and dL/dv read once, dL/dû written once; operations twice
    the forward's."""
    u = votes_bytes(cfg, batch)
    v = batch * cfg["num_h_caps"] * cfg["h_caps_dim"] * F32
    it = cfg["routing_iters"]
    flops = batch * 2 * cfg["num_l_caps"] * cfg["num_h_caps"] * \
        cfg["h_caps_dim"] * (2 * it - 1)
    if backward:
        return max((2 * u + v) / peak_bytes_s, 2 * flops / peak_flops)
    return max((u + v) / peak_bytes_s, flops / peak_flops)
