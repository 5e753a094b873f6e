"""Paper §4 — host || PIM pipelined execution.

Port of the JAX package's ``repro/core/pipeline.py``.  Microbatches flow
through two stages with a one-tick skew: at tick t stage B consumes stage
A's output from tick t-1 while stage A produces tick t's.  Two entry points:

  * ``software_pipeline_scan`` — one device group: the skewed scan is a
    Python loop issuing the stages in the same order; on the card they
    queue on one stream.
  * ``two_stage_pipeline`` — stages on disjoint rank groups along a
    2-sized mesh axis ("pipe"): pipe rank 0 runs stage A (the encoder, the
    paper's host), pipe rank 1 runs stage B (routing, the PIM), and the
    hand-off is a ``broadcast`` from pipe rank 0 in the pipe group — the
    counterpart of the reference's ``ppermute [(0, 1)]`` (``send``/``recv``
    are not used: gloo does not take CUDA tensors there).  Each process
    issues its own stage, so the two stages of one tick overlap on their
    own devices (paper Fig.8).

Inputs are pytrees of stacked microbatches (every leaf ``(n_micro, ...)``;
dicts, tuples and lists of tensors), so stages can take auxiliary per-lane
operands — the serving path threads a padding mask next to the images.  The
stage hand-off is a pytree too (EM's (votes, a_in)), and stage B may return
one (EM's (pose, a_out)); the stacked outputs mirror it leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.runtime import mesh_utils


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor that does not exist yet (the counterpart
    of ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list)) or (
        isinstance(tree, tuple) and not isinstance(tree, TensorSpec))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    same-structure trees ``rest``); dicts, tuples and lists are nodes."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if _is_node(tree):
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


def tree_spec(tree):
    """The ``TensorSpec`` pytree of a pytree of tensors."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def two_stage_pipeline(stage_a: Callable, stage_b: Callable, mesh, axis: str,
                       a_out_shape, *, in_spec: Any = None,
                       out_spec: Any = None,
                       stage_b_collectives: bool = False) -> Callable:
    """Build a pipelined runner over the 2-sized mesh axis ``axis``.

    stage_a: microbatch -> hidden        (runs on pipe rank 0, the "host")
    stage_b: hidden -> output            (runs on pipe rank 1, the "PIM")

    ``a_out_shape`` is the ``TensorSpec`` pytree of one microbatch's hidden
    (per shard, where stage B is sharded): pipe rank 1 receives into
    buffers of that shape, and stage A's leaves are cast to its dtypes.
    Returns f(micro_inputs) -> stacked outputs, as a function of global
    tensors (``mesh_utils.shard_call``): ``in_spec``/``out_spec`` split the
    stacked inputs/outputs over the non-pipe axes (leading dim n_micro;
    default replicated).  n_micro + 1 ticks: at tick t pipe rank 0 runs A
    on microbatch t and pipe rank 1 runs B on what arrived at tick t-1,
    then the hand-off is broadcast from pipe rank 0; the bubble tick's
    output is dropped and the stacked outputs are broadcast from pipe rank
    1, so every rank returns them.

    ``stage_b_collectives``: stage B runs collectives over a further mesh
    axis (a sharded routing stage).  B then runs on both pipe ranks every
    tick — rank 0 on a zero hand-off, its result discarded — so that its
    collectives stay uniform across the mesh, as the reference's do.  The
    zero hand-off lives on the inputs' device.
    """
    size = mesh_utils.axis_size(mesh, axis)
    if size != 2:
        raise ValueError(f"two_stage_pipeline needs |{axis}| == 2, "
                         f"got {size}")

    def per_rank(micro_inputs):
        stage = mesh_utils.axis_index(mesh, axis)
        n = n_micro(micro_inputs)
        dev = tree_leaves(micro_inputs)[0].device
        zero = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=dev), a_out_shape)
        inbox = zero
        outs = []
        for t in range(n + 1):
            b_out = None
            if stage == 1:
                b_out = stage_b(inbox)
            elif stage_b_collectives:
                b_out = stage_b(zero)
            if t > 0 and b_out is not None:
                outs.append(b_out)
            if t == n:
                break           # the drain tick hands nothing on
            if stage == 0:
                a_out = tree_map(lambda h, s: h.to(s.dtype),
                                 stage_a(microbatch_at(micro_inputs, t)),
                                 a_out_shape)
            else:
                a_out = zero
            inbox = tree_map(lambda h: mesh_utils.broadcast(h, axis, 0),
                             a_out)
        if stage == 1 or stage_b_collectives:
            stacked = tree_stack(outs)
        else:
            # pipe rank 0 learns the outputs' shapes from one stage-B call
            # on the zero hand-off
            stacked = tree_map(lambda o: o.new_empty((n,) + tuple(o.shape)),
                               stage_b(zero))
        return tree_map(lambda h: mesh_utils.broadcast(h, axis, 1), stacked)

    in_spec = mesh_utils.P(None) if in_spec is None else in_spec
    return mesh_utils.shard_call(per_rank, mesh, (in_spec,), out_spec)
