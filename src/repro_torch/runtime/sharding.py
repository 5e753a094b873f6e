"""Logical-axis sharding rules per (mode, arch, mesh), and the gradient
sums that finish a sharded backward.

A copy of the JAX package's ``repro/runtime/sharding.py`` on a torch
``DeviceMesh``: ``make_rules`` is the single source of truth for how every
logical axis maps onto the mesh, and model code never changes with it.
The port runs the rules as explicit SPMD (``models.layers`` docstring).

``sync_grads`` finishes the gradients of a sharded backward: with the
collectives' exact transposes (``runtime.mesh_utils`` docstring) every
rank of n seeds the loss it holds, so the shares of a leaf's gradient over
the ranks that hold copies of it add up to n times its gradient.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from repro_torch.models.layers import AxisRules, dim_axis
from repro_torch.models.lm import ArchConfig
from repro_torch.runtime import mesh_utils
from repro_torch.runtime.mesh_utils import axis_names, axis_size, dp_axes

MODES = ("train", "prefill", "decode")


def make_rules(cfg: ArchConfig, mesh, mode: str,
               overrides: Optional[Dict[str, object]] = None) -> AxisRules:
    """mode: train | prefill | decode."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    rules: Dict[str, object] = {
        # --- parameters ---
        "embed": "data",            # FSDP: d_model rows of weight matrices
        "qkv_out": "model",         # TP: fused head dim of wq/wk/wv/wo
        "ff": "model",              # TP: MLP hidden
        "experts": "model",         # EP: expert dim of MoE weights
        "vocab": "model",           # TP: unembed / logits vocab dim
        "vocab_table": None,        # embed table rows
        "embed_model": "model",     # embed table cols -> collective-free take
        "ssm_proj": "model",        # mamba in_proj cols
        "ssm_inner": "model",       # mamba d_inner (state, conv, A, D)
        "ssm_heads": "model",       # mamba2 head dim
        # --- activations ---
        "batch": dp,
        "seq": None,
        "seq_res": None,            # Megatron-SP residual sharding: off
        "embed_act": None,          # d_model of activations: replicated
        "heads": "model" if cfg.attn_plan == "head_tp" else None,
        "seq_attn": "model" if cfg.attn_plan == "seq_tp" else None,
        "cache_seq": None,
        "ff_act": "model",
    }
    if mode == "decode":
        # flash-decoding plan: cache sequence-sharded over model, batch on dp
        rules["cache_seq"] = "model"
        rules["heads"] = None
        rules["seq_attn"] = None
    if mode in ("prefill", "decode"):
        # serving holds no optimizer state: replicate the weights over
        # "data" where a model-axis shard is at most 8 GiB (bf16)
        try:
            shard_bytes = cfg.param_count() * 2 / axis_size(mesh, "model")
        except Exception:
            shard_bytes = float("inf")
        if shard_bytes <= 8 * 2 ** 30:
            rules["embed"] = None
    if overrides:
        rules.update(overrides)
    return AxisRules(rules=rules, mesh=mesh, enabled=True)


def batch_shape_check(cfg: ArchConfig, mesh, global_batch: int,
                      mode: str) -> None:
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(mesh, a)
    if global_batch % n and global_batch >= n:
        raise ValueError(f"global_batch {global_batch} not divisible by "
                         f"dp={n}")


def leaf_axes(axes: tuple, shape: tuple, rules: AxisRules) -> tuple:
    """The mesh axes a leaf of logical ``axes`` and global ``shape`` is
    held in blocks over (``layers.dim_axis``)."""
    out = []
    for a, n in zip(axes, shape):
        ax = dim_axis(rules, a, n)
        out.extend(mesh_utils.axis_tuple(ax))
    return tuple(out)


def param_held(cfg: ArchConfig, rules: AxisRules) -> Dict[str, tuple]:
    """Each parameter's "/"-joined path -> the mesh axes its leaf is held
    in blocks over under ``rules`` (from shapes alone)."""
    from repro_torch.checkpoint.ckpt import flatten
    from repro_torch.models import lm
    axes = flatten(lm.param_logical_axes(cfg))
    shapes = flatten(lm.init_params(cfg, device="meta"))
    return {k: leaf_axes(axes[k], tuple(shapes[k].shape), rules)
            for k in shapes}


def _by_axes(names, split: Mapping[str, tuple]) -> Dict[tuple, list]:
    groups: Dict[tuple, list] = {}
    for k in names:
        groups.setdefault(split[k], []).append(k)
    return groups


def _flat_all_reduce(tensors: list, axes: tuple, rules: AxisRules) -> list:
    """One summing ``all_reduce`` per axis of ``axes`` over the
    concatenation of ``tensors`` (fp32); the results in their own
    shapes."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    for a in axes:
        mesh_utils.all_reduce_(flat, rules.mesh.get_group(a))
    return list(flat.split([t.numel() for t in tensors]))


def sync_grads(grads: Mapping[str, torch.Tensor],
               held: Mapping[str, tuple], rules: AxisRules
               ) -> Dict[str, torch.Tensor]:
    """Finish a sharded backward's gradients (module docstring): each
    leaf's share summed over the mesh axes it is replicated over (those
    not in ``held[name]``, the axes it is held in blocks over), divided by
    the mesh's rank count.  ``grads`` and ``held`` are keyed alike; the
    results keep each gradient's dtype."""
    if not rules.enabled or rules.mesh is None:
        return dict(grads)
    names = axis_names(rules.mesh)
    n = rules.mesh.size()
    rep = {k: tuple(a for a in names if a not in held[k]) for k in grads}
    out = {}
    with torch.no_grad():
        for axes, keys in _by_axes(list(grads), rep).items():
            summed = _flat_all_reduce([grads[k] for k in keys], axes, rules)
            for k, t in zip(keys, summed):
                out[k] = (t / n).reshape(grads[k].shape).to(grads[k].dtype)
    return {k: out[k] for k in grads}


def global_norm(grads: Mapping[str, torch.Tensor],
                held: Mapping[str, tuple], rules: AxisRules
                ) -> torch.Tensor:
    """The global L2 norm of a sharded tree: each leaf's sum of squares
    summed over the axes it is held in blocks over, so every block counts
    once and a replicated leaf once."""
    total = torch.zeros((), dtype=torch.float32,
                        device=next(iter(grads.values())).device)
    groups = _by_axes(list(grads), held)
    for axes, keys in groups.items():
        sq = torch.stack([grads[k].float().square().sum() for k in keys])
        if axes and rules.enabled and rules.mesh is not None:
            sq = _flat_all_reduce([sq], axes, rules)[0]
        total = total + sq.sum()
    return torch.sqrt(total)
