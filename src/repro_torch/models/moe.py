"""Mixture-of-Experts FFN: top-k expert dispatch with static capacity.

Port of the JAX package's ``repro/models/moe.py`` for one device.  Each
token's router picks ``top_k`` experts; each expert gathers up to
``capacity`` of its tokens (the earliest first — the reference's sort-free
top-C selection), runs its SwiGLU products, and the weighted outputs are
combined per token.  All experts' products run as one batched product over
(experts, capacity, d_model); no Python loop walks the experts.

Two choices keep the port on the reference's tokens and bits:

* **ties.** ``lax.top_k`` breaks ties towards the lower index and
  ``torch.topk`` promises no order, so the expert choice is a stable
  descending sort (a zero token's uniform router picks experts 0..k-1, as
  the reference does).  The capacity pick ranks tokens by distinct
  priorities, so it has no ties.
* **the combine.** The reference scatter-adds the expert outputs
  (``y.at[idx].add``), expert after expert.  A scatter-add on the card
  goes through atomics, whose order varies; here each token adds its
  kept experts' outputs in ascending expert order, starting from zero —
  the reference's order, and the same bits on every call.

Expert parallelism is the reference's plan: tokens and router replicated,
the expert slots split over a mesh axis.  ``_moe_local`` takes the rank's
slots ``expert_offset..expert_offset+E_loc`` and the axis name; the
capacity and the Switch aux come from the replicated router statistics, so
they are the same on every rank, and y is psum'd over the axis.  It runs
behind the Router (``core.router``, an "E"-sharded ``ExecutionPlan``) and
under the sharding tables (``moe_forward(rules=...)``: the slots split
over the ``experts`` axis, the tokens over the batch axes).

Tokens split over the batch axes keep the function of the whole batch:
the capacity is the global batch's, each expert keeps the earliest of its
tokens in the global order (this rank's budget is the capacity less the
tokens the ranks before it assigned to the expert), and the aux is built
from router statistics summed over the batch axes.  (The reference's
shard_map instead runs each batch shard with its own capacity and aux,
which is another function than its unsharded one.)
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch

from repro_torch.models.layers import (NO_RULES, PARAM_AXES, AxisRules,
                                       as_rules, init_linear, leaf,
                                       local_axis)
from repro_torch.runtime import mesh_utils


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int                 # per-expert hidden (logical)
    n_experts: int            # logical expert count
    top_k: int
    capacity_factor: float = 1.25
    # each expert stored as ``sub_experts`` slices along d_ff (the
    # reference's EP x TP layout); gate/up split exactly, and the down
    # products' partials add up in the combine
    sub_experts: int = 1

    @property
    def n_shards_experts(self) -> int:
        return self.n_experts * self.sub_experts

    @property
    def d_ff_shard(self) -> int:
        return self.d_ff // self.sub_experts


def init_moe(gen, cfg: MoEConfig, dtype=torch.bfloat16,
             device="cuda") -> dict:
    """Random router (fp32) and expert weights ((E·sub, D, F/sub) stacks in
    ``dtype``), drawn from ``gen`` on ``device``."""
    E, D, F = cfg.n_shards_experts, cfg.d_model, cfg.d_ff_shard

    def draw(shape, scale):
        w = torch.randn(shape, generator=gen, device=device)
        return (w * scale).to(dtype)

    return {
        "router": init_linear(gen, D, cfg.n_experts, torch.float32, device),
        "w_gate": draw((E, D, F), 1.0 / math.sqrt(D)),
        "w_up": draw((E, D, F), 1.0 / math.sqrt(D)),
        "w_down": draw((E, F, D), 1.0 / math.sqrt(cfg.d_ff)),
    }


def logical_expert_weights(params, cfg: MoEConfig):
    """(E_logical, D, F_logical) weights from the sub-expert layout."""
    s = cfg.sub_experts
    if s == 1:
        return params["w_gate"], params["w_up"], params["w_down"]
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    wg = params["w_gate"].reshape(E, s, D, F // s).permute(0, 2, 1, 3) \
        .reshape(E, D, F)
    wu = params["w_up"].reshape(E, s, D, F // s).permute(0, 2, 1, 3) \
        .reshape(E, D, F)
    wd = params["w_down"].reshape(E, s, F // s, D).reshape(E, F, D)
    return wg, wu, wd


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return min(n_tokens, max(8, c))


def _top_k(x: torch.Tensor, k: int):
    """The k largest of each row, ties to the lower index (``lax.top_k``'s
    order)."""
    values, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def _moe_local(x2d: torch.Tensor, router_w: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor, cfg: MoEConfig, expert_offset: int = 0,
               axis_name: Optional[str] = None, token_axis=None, mesh=None):
    """x2d (T, D) replicated; w_* (E_loc, D, F/sub) the expert slots
    ``expert_offset..expert_offset+E_loc`` (every slot: offset 0, E_loc =
    E·sub).  Returns (y (T, D) in x2d's dtype, psum'd over ``axis_name``,
    aux load-balance loss).  The aux is differentiable through the mean
    router probability and not through the token fractions, as in the
    reference.  ``token_axis``: the mesh axes x2d's rows are this rank's
    block of (module docstring), on ``mesh``; ``mesh`` also names the
    expert axis's group (else the active mesh does)."""
    T, D = x2d.shape
    E, sub = cfg.n_experts, cfg.sub_experts
    n_slots = w_gate.shape[0]
    n_tok = 1 if token_axis is None else \
        mesh_utils.axis_size(mesh, token_axis)
    cap = _capacity(T * n_tok, cfg)
    dev = x2d.device

    logits = x2d.float() @ router_w                             # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = _top_k(probs, cfg.top_k)                   # (T, K)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)      # renormalize

    # Switch-style load-balance aux, from the replicated router statistics
    # of the whole batch
    me = mesh_utils.psum(torch.sum(probs, dim=0), token_axis,
                         mesh=mesh) / (T * n_tok)               # (E,)
    picked = top_ids[..., None] == torch.arange(E, device=dev)  # (T, K, E)
    ce = mesh_utils.psum(picked.float().sum(1).sum(0), token_axis,
                         mesh=mesh) / (T * n_tok)
    aux = E * torch.sum(me * ce)

    # dispatch: local slot e serves logical expert (offset + e) // sub; its
    # tokens in order of arrival (assigned first), the first ``cap`` kept
    eid = (expert_offset + torch.arange(n_slots, device=dev)) // sub  # (S,)
    mask = top_ids[None] == eid[:, None, None]                  # (S, T, K)
    assigned = mask.any(-1)                                     # (S, T)
    weight = torch.where(mask, top_p[None], 0.0).sum(-1)        # (S, T)
    ar = torch.arange(T, device=dev)
    prio = torch.where(assigned, ar, T + ar)                    # distinct
    c = min(cap, T)
    idx = torch.topk(-prio, c, dim=-1).indices                  # (S, c)
    valid = assigned.gather(1, idx)
    if token_axis is not None:
        # the slots' room left by the tokens of the ranks before this one
        counts = mesh_utils.all_gather(assigned.sum(1)[None], token_axis, 0,
                                       mesh=mesh)               # (n, S)
        budget = cap - counts[:mesh_utils.axis_index(mesh, token_axis)].sum(0)
        valid = valid & (torch.arange(c, device=dev)[None]
                         < budget[:, None])
    cap = c
    xg = x2d[idx]                                               # (S, cap, D)
    g = torch.bmm(xg, w_gate)
    u = torch.bmm(xg, w_up)
    h = torch.nn.functional.silu(g.float()).to(x2d.dtype) * u
    yo = torch.bmm(h, w_down)                                   # (S, cap, D)
    yo = yo * (weight.gather(1, idx) * valid).to(yo.dtype)[..., None]

    # combine: each token adds its experts' outputs in ascending slot
    # order (the reference's scatter order), skipping dropped slots and
    # slots of other ranks
    slot_of = torch.full((n_slots, T), -1, dtype=torch.long, device=dev)
    slot_of.scatter_(1, idx, torch.arange(cap, device=dev).expand(
        n_slots, cap))
    mine = (top_ids[:, :, None] * sub
            + torch.arange(sub, device=dev)).reshape(T, -1)     # (T, K·sub)
    mine = torch.sort(mine, dim=-1).values - expert_offset      # local ids
    here = (mine >= 0) & (mine < n_slots)
    mine = mine.clamp(0, n_slots - 1)
    s = slot_of[mine, ar[:, None]]                              # (T, K·sub)
    kept = here & (s >= 0)
    contrib = yo[mine, s.clamp(min=0)]                      # (T, K·sub, D)
    y = torch.zeros((T, D), dtype=x2d.dtype, device=dev)
    for j in range(mine.shape[1]):
        y = y + torch.where(kept[:, j, None], contrib[:, j], 0.0)
    return mesh_utils.psum(y, axis_name, mesh=mesh), aux


def moe_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: MoEConfig, *, rules: AxisRules = NO_RULES):
    """x: (B, S, D) -> (y (B, S, D), aux scalar).  Under ``rules`` x is
    this rank's batch rows (replicated over the expert axis) and the
    expert slots are split over the ``experts`` axis where it divides
    them (else every slot runs on every rank)."""
    rules = as_rules(rules)
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    if not rules.enabled:
        y, aux = _moe_local(x2d, *router_args(params), cfg)
        return y.reshape(B, S, D), aux
    E, F = cfg.n_shards_experts, cfg.d_ff_shard
    ax = local_axis(rules, "experts", E)
    keep = ("experts",) if ax is not None else ()
    shapes = {"w_gate": (E, D, F), "w_up": (E, D, F), "w_down": (E, F, D)}
    w = {k: leaf(params[k], rules, PARAM_AXES[f"moe/{k}"], shp, keep)
         for k, shp in shapes.items()}
    offset = rules.index(ax) * (E // rules.size(ax))
    y, aux = _moe_local(x2d, params["router"], w["w_gate"], w["w_up"],
                        w["w_down"], cfg, expert_offset=offset,
                        axis_name=ax, token_axis=rules.axis("batch"),
                        mesh=rules.mesh)
    return y.reshape(B, S, D), aux


def router_args(params: Mapping[str, torch.Tensor]) -> tuple:
    """Positional argument order of the 'moe' Router algorithm
    (``core.router``): ``router(x2d, *router_args(params))`` with
    ``RouterSpec(algorithm="moe", options=(("moe_cfg", cfg),))`` computes
    the same (y, aux) as ``moe_forward`` on the flattened tokens."""
    return (params["router"], params["w_gate"], params["w_up"],
            params["w_down"])


def moe_forward_dense_oracle(params, x: torch.Tensor, cfg: MoEConfig):
    """O(T·E) oracle: every expert on every token, weighted by the router —
    no capacity drops — in fp32."""
    B, S, D = x.shape
    x2d = x.reshape(B * S, D).float()
    probs = torch.softmax(x2d @ params["router"], dim=-1)
    top_p, top_ids = _top_k(probs, cfg.top_k)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    w = torch.zeros_like(probs).scatter_(1, top_ids, top_p)     # (T, E)
    wg, wu, wd = (t.float() for t in logical_expert_weights(params, cfg))
    g = torch.einsum("td,edf->tef", x2d, wg)
    u = torch.einsum("td,edf->tef", x2d, wu)
    h = torch.nn.functional.silu(g) * u
    y = torch.einsum("tef,efd->ted", h, wd)
    out = torch.einsum("ted,te->td", y, w)
    return out.reshape(B, S, D), None
