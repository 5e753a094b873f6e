"""Paper §4 — host || PIM pipelined execution, single-device form.

Port of ``software_pipeline_scan`` from the JAX package's
``repro/core/pipeline.py``: microbatches flow through two stages with a
one-tick skew — at tick t stage B consumes stage A's output from tick t-1
while stage A produces tick t's.  PyTorch runs eagerly, so the skewed scan
is a Python loop issuing the stages in the same order; on the card the
stages queue on one stream.

The two-device form (``two_stage_pipeline``, stages on disjoint device
groups) is ported in slice 5 (distribution).

Inputs are pytrees of stacked microbatches (every leaf ``(n_micro, ...)``;
dicts, tuples and lists of tensors), so stages can take auxiliary per-lane
operands — the serving path threads a padding mask next to the images.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def n_micro(micro_inputs) -> int:
    leaves = tree_leaves(micro_inputs)
    if not leaves:
        raise ValueError("micro_inputs pytree has no leaves")
    counts = {l.shape[0] for l in leaves}
    if len(counts) != 1:
        raise ValueError("micro_inputs leaves disagree on n_micro "
                         f"(leading dims {sorted(counts)}); every leaf "
                         "must stack the same number of microbatches")
    return leaves[0].shape[0]


def microbatch_at(micro_inputs, t: int):
    """Microbatch t of a stacked pytree (every leaf (n_micro, ...))."""
    return tree_map(lambda x: x[t], micro_inputs)


def tree_stack(trees: list):
    """Stack a list of same-structure pytrees leaf by leaf along a new
    leading dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees, dim=0)


def software_pipeline_scan(stage_a: Callable, stage_b: Callable,
                           micro_inputs) -> Any:
    """Skewed loop: tick t runs stage_b on stage_a's output from t-1, then
    stage_a on microbatch t (the two are independent within a tick).
    stage_a's output is handed to stage_b as it is (a tuple for a
    multi-input stage B, EM's (votes, a_in)), and stage_b may return a
    pytree (EM's (pose, a_out)).  Returns stage_b's outputs stacked leaf by
    leaf along a new leading dim (n_micro, ...)."""
    n = n_micro(micro_inputs)
    prev_a = stage_a(microbatch_at(micro_inputs, 0))
    outs = []
    for t in range(1, n):
        outs.append(stage_b(prev_a))        # bubble-filled stage B
        prev_a = stage_a(microbatch_at(micro_inputs, t))
    outs.append(stage_b(prev_a))
    return tree_stack(outs)
