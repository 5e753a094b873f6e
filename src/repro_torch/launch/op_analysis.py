"""Op-level analysis of one step: FLOPs, HBM bytes, collective bytes and
peak memory a device — the port's counterpart of the JAX package's
``launch/hlo_analysis.py``.

Why another name: the reference lowers each cell through XLA and walks the
optimised HLO text, multiplying every op by the trip counts of the loops
around it.  The port runs eagerly and has no HLO.  Its step *runs* instead,
on fake tensors (``FakeTensorMode``: shapes, dtypes and devices, no data,
no launch), under ``OpAnalysis``, a ``TorchDispatchMode`` that sees every
aten op the step executes.  Eager execution runs every layer, microbatch
and chunk, so counting each executed op is already trip-count-aware.  Two
hooks report what the dispatcher cannot see:

* each kernel wrapper's fake route reports its kernel by name, with its
  operations and the bytes it must move, the formulas of its bound
  (``repro_torch.kernels.report_kernel``); the dry run never runs a
  plain version;
* each collective of ``runtime.mesh_utils`` reports its kind, its result's
  bytes and its group's size (``mesh_utils.COLLECTIVE_HOOKS``).

Counted per device (every tensor is one rank's block):

* ``flops`` — products (mm, bmm, addmm, convolutions and their backward)
  by ``torch.utils.flop_counter``'s formulas, with ``FlopCounterMode``'s
  decompositions (``product_flops`` holds these alone: what
  ``FlopCounterMode`` counts over the same step on the card); 1 per result
  element of a pointwise op and 1 per input element of a reduction; and
  each kernel's reported operations (``kernels``: name -> calls, flops,
  bytes).
* ``hbm_bytes`` — every op's operand and result bytes (a view, a
  metadata op or an allocation moves none; a fill writes its result
  only), each kernel's reported bytes, and each collective's result read
  and written once.  Eager PyTorch fuses nothing, so this is the traffic
  the port really issues.
* ``hbm_bytes_lower`` — the step's arguments read once and its outputs
  written once.
* ``collective_bytes`` and ``collective_by_kind`` by the reference's link
  formulas (``LINK_FACTOR``; g the group's size, on the result's bytes):
  all-reduce 2·(g−1)/g, all-gather (g−1)/g of the gathered result,
  reduce-scatter g−1, all-to-all (g−1)/g, collective-permute 1, and
  broadcast (g−1)/g, a kind the reference's programs never issue.  The
  port issues all-reduce (``psum``, ``pmax``, ``psum_scatter`` — gloo
  has no reduce-scatter), all-gather and broadcast.
* ``memory`` — live bytes of the storages the step holds, by a small
  tracker on storage lifetimes: a storage an op creates counts from that
  op to the death of its last tensor, rounded up to the card allocator's
  512-byte blocks.  Its peak is split as XLA's ``memory_analysis`` splits
  it: ``argument_bytes`` (storages registered with ``arguments`` before
  the step), ``output_bytes`` (registered with ``outputs`` after it),
  ``alias_bytes`` (outputs that are arguments, updated in place) and
  ``temp_bytes``, so that peak = argument + temp + output − alias.

``as_dict`` keeps ``HloStats.as_dict``'s keys where they mean the same;
the reference's ``collective_bytes_bf16eq`` (an XLA-on-CPU float
normalisation correction) has no counterpart.  The analysis needs no fake
tensors: on real tensors (several gloo ranks on the CPU) it counts the
same ops, kernel calls and collectives.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels
from repro_torch.runtime import mesh_utils

ALLOC_BLOCK = 512        # the CUDA caching allocator's block granularity

# link bytes a device per result byte of each collective kind, group size g
LINK_FACTOR = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
    "broadcast": lambda g: (g - 1) / g,
}

_aten = torch.ops.aten
_REDUCTIONS = {
    _aten.sum, _aten.mean, _aten.amax, _aten.amin, _aten.max, _aten.min,
    _aten.prod, _aten.logsumexp, _aten._softmax, _aten._log_softmax,
    _aten._softmax_backward_data, _aten._log_softmax_backward_data,
    _aten.var, _aten.var_mean, _aten.std, _aten.norm,
    _aten.linalg_vector_norm, _aten.cumsum, _aten.any, _aten.all,
    _aten.argmax, _aten.argmin, _aten.topk, _aten.sort,
}
# allocations: they write nothing
_NO_TRAFFIC = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided,
}
# in-place writes that read nothing of their own
_WRITE_ONLY = {_aten.fill_, _aten.zero_, _aten.normal_, _aten.uniform_,
               _aten.random_}
_SKIP = {torch.ops.prim.device.default}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _block_bytes(nbytes: int) -> int:
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    product_flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_lower: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_ops: int = 0
    collective_calls: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    # kernel name -> {"calls", "flops", "bytes"}
    kernels: Dict[str, dict] = dataclasses.field(
        default_factory=lambda: defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0}))
    # source (aten op, kernel or collective kind) -> [flops, bytes, coll]
    by_source: Dict[str, list] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0.0, 0.0, 0.0]))

    def top(self, metric: int = 0, k: int = 12) -> List[Tuple[str, list]]:
        return sorted(self.by_source.items(),
                      key=lambda kv: -kv[1][metric])[:k]

    def as_dict(self, top_k: int = 16) -> dict:
        def fmt(items):
            return {name: {"flops": v[0], "bytes": v[1], "coll": v[2]}
                    for name, v in items}
        return {"flops": self.flops, "product_flops": self.product_flops,
                "hbm_bytes": self.hbm_bytes,
                "hbm_bytes_lower": self.hbm_bytes_lower,
                "collective_bytes": self.collective_bytes,
                "collective_by_kind": dict(self.collective_by_kind),
                "collective_ops": self.collective_ops,
                "collective_calls": dict(self.collective_calls),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "top_flops": fmt(self.top(0, top_k)),
                "top_bytes": fmt(self.top(1, top_k)),
                "top_coll": fmt(self.top(2, top_k))}


class OpAnalysis(TorchDispatchMode):
    """Count one step (module docstring).  Use::

        with FakeTensorMode():
            ... build the step's inputs ...
            with OpAnalysis() as a:
                a.arguments(params, opt_state, batch)
                out = step(params, opt_state, batch)
                a.outputs(out)
        a.stats.as_dict(), a.memory()

    While active it also receives the kernel and collective reports."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self._live: Dict[int, int] = {}       # storage key -> block bytes
        self._args: Dict[int, int] = {}
        self._outs: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._depth = 0

    # -- activation ---------------------------------------------------------

    def __enter__(self):
        # re-entered for each decomposition (``__torch_dispatch__``); the
        # hooks are registered once, by the outermost entry
        if self._depth == 0:
            kernels.ANALYSES.append(self)
            mesh_utils.COLLECTIVE_HOOKS.append(self.collective)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                kernels.ANALYSES.remove(self)
                mesh_utils.COLLECTIVE_HOOKS.remove(self.collective)

    # -- storages -------------------------------------------------------------

    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until its last tensor dies;
        returns its key."""
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._live:
            size = _block_bytes(st.nbytes())
            self._live[key] = size
            self.live_bytes += size
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def arguments(self, *trees) -> None:
        """Register the step's inputs (live before it starts)."""
        for t in _tensors(trees):
            key = self._track(t)
            self._args[key] = self._live[key]
        self.stats.hbm_bytes_lower += sum(self._args.values())

    def outputs(self, *trees) -> None:
        """Register the step's outputs (after it returns)."""
        for t in _tensors(trees):
            key = self._track(t)
            self._outs[key] = self._live[key]
        self.stats.hbm_bytes_lower += sum(self._outs.values())

    def memory(self) -> dict:
        """The peak and its split (module docstring), bytes."""
        arg = sum(self._args.values())
        out = sum(self._outs.values())
        alias = sum(v for k, v in self._outs.items() if k in self._args)
        peak = self.peak_bytes
        return {"argument_bytes": arg, "output_bytes": out,
                "alias_bytes": alias,
                "temp_bytes": peak - arg - out + alias,
                "peak_bytes_per_device": peak}

    # -- reports --------------------------------------------------------------

    def kernel(self, name: str, flops: float, bytes_moved: float) -> None:
        k = self.stats.kernels[name]
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += bytes_moved
        self.stats.flops += flops
        self.stats.hbm_bytes += bytes_moved
        src = self.stats.by_source[f"kernel:{name}"]
        src[0] += flops
        src[1] += bytes_moved

    def collective(self, kind: str, nbytes: int, group_size: int) -> None:
        moved = LINK_FACTOR[kind](group_size) * nbytes
        s = self.stats
        s.collective_bytes += moved
        s.collective_by_kind[kind] += moved
        s.collective_ops += 1
        s.collective_calls[kind] += 1
        s.hbm_bytes += 2.0 * nbytes
        src = s.by_source[f"collective:{kind}"]
        src[1] += 2.0 * nbytes
        src[2] += moved

    # -- the ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SKIP:
            return func(*args, **kwargs)
        # FlopCounterMode's rule, so that products count as they do there
        with self:
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            return out                  # counted by the collective hook
        packet = func._overloadpacket
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_storage_key(t) for t in ins}
        for t in outs:
            if _storage_key(t) not in in_keys:
                self._track(t)
        s = self.stats
        flops = 0.0
        formula = flop_registry.get(packet)
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
            s.product_flops += flops
        elif torch.Tag.pointwise in func.tags:
            flops = float(sum(t.numel() for t in outs[:1]))
        elif packet in _REDUCTIONS and ins:
            flops = float(ins[0].numel())
        moved = 0
        if outs and packet not in _NO_TRAFFIC and not (
                func.is_view or (not func._schema.is_mutable and all(
                    _storage_key(t) in in_keys for t in outs))):
            moved = sum(_nbytes(t) for t in outs)
            if packet not in _WRITE_ONLY:
                moved += sum(_nbytes(t) for t in ins)
        s.flops += flops
        s.hbm_bytes += moved
        if flops or moved:
            src = s.by_source[str(packet)]
            src[0] += flops
            src[1] += moved
        return out
