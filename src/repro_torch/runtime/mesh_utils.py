"""Device meshes, the collectives of sharded routing, and the shard-call
helper — the port's counterpart of ``jax.sharding.Mesh``, ``lax.psum`` and
``shard_map``.

How distribution maps onto PyTorch (one decision, used by every module of
the distribution path):

* **A mesh is a ``torch.distributed`` ``DeviceMesh``.**  ``make_mesh(shape,
  axes)`` builds it with ``init_device_mesh`` over the default process
  group; ``mesh.get_group(axis)`` is the group each collective runs in.
  ``default_mesh()`` — the counterpart of the reference's "all local
  devices on one axis" — puts every rank of the default group on one axis
  named ``vault``.  Where no group has been initialized and the mesh has
  one rank, ``make_mesh`` initializes a 1-rank group itself over
  ``dist.HashStore()`` (no network): NCCL for the card, gloo for the CPU.
  Several ranks are always started by the caller, which chooses the
  backend, the store, the world size and the rank.
* **Four collectives, and only these:** ``all_reduce`` with SUM (``psum``),
  ``all_reduce`` with MAX (``pmax``), the list form of ``all_gather``
  (``all_gather``, along a tensor dimension) and ``broadcast``.  A 1-rank
  group is a real group: the collectives are issued all the same.  gloo
  runs all four on CUDA tensors itself, staging them through host memory,
  so one code path serves NCCL with one rank per card, gloo with several
  ranks sharing one card (NCCL refuses two ranks on one GPU) and gloo on
  the CPU.  ``send``/``recv`` are not used: gloo does not take CUDA
  tensors there.  Each helper is the identity when its axis is ``None``
  (the reference's ``_psum_if``).
* **The collectives find their group through the active mesh.**  The
  algorithm bodies name mesh axes, as the reference's do; ``shard_call``
  makes its mesh the active one (a context variable, so per thread) while
  the body runs, and ``psum(x, "vault")`` resolves ``"vault"`` against it.
* **``shard_call`` is ``shard_map``:** global tensors in, global tensors
  out.  It takes this rank's block of every input by its spec, runs the
  body (which issues the collectives itself), and gathers every output
  along its spec.  An extent that the axis size does not divide raises a
  ``ValueError`` naming the dimension; nothing pads.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import slices
from repro_torch.kernels import resolve_device

DEFAULT_AXIS = "vault"

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                         default=None)
# one default mesh per device type, as the default process group it wraps
# is one per process
_DEFAULT_MESHES: Dict[str, Any] = {}


class P(tuple):
    """A partition spec: one entry per tensor dimension, the mesh axis that
    dimension is split over or ``None`` (replicated).  Trailing dimensions
    past the spec's length are replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple(self)!r}"


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group, whose world size must be the product of
    ``shape``.  With no group yet and a 1-rank mesh, a 1-rank group is
    initialized over ``dist.HashStore()`` (NCCL for ``device="cuda"``,
    gloo for ``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    dev = resolve_device(device)
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a process group: start the "
                "ranks and call torch.distributed.init_process_group "
                "(backend, store or init_method, world_size, rank) first")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh shape {shape} holds {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    if dev.type == "cuda":
        # select the card before the mesh does (several ranks may share it)
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def default_mesh(device="cuda"):
    """Every rank of the default group on one axis named ``vault`` (the
    paper's vault array; one rank when no group was started).  Built once
    per device type."""
    dev = resolve_device(device)
    mesh = _DEFAULT_MESHES.get(dev.type)
    if mesh is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh((n,), (DEFAULT_AXIS,), dev)
        _DEFAULT_MESHES[dev.type] = mesh
    return mesh


def axis_names(mesh) -> tuple:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def axis_size(mesh, axis: str) -> int:
    return mesh.size(axis_names(mesh).index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def dp_axes(mesh) -> tuple:
    """Data-parallel axes: every axis that is not 'model'."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= axis_size(mesh, a)
    return n


# ---------------------------------------------------------------------------
# the active mesh and the four collectives
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def active(mesh):
    """Make ``mesh`` the one the collectives resolve axis names against."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def _group(axis: str, x: torch.Tensor):
    if torch.is_grad_enabled() and x.requires_grad:
        # the torch.distributed collectives have no autograd formula: the
        # gradient would skip the cross-shard sum without a word
        raise slices.not_ported(
            f"a collective over mesh axis {axis!r} on a tensor that "
            "requires grad (autograd through the Table-2 collectives)",
            slices.SHARDED_TRAINING)
    mesh = _ACTIVE.get()
    if mesh is None:
        raise RuntimeError(f"collective over mesh axis {axis!r} outside a "
                           "sharded call: run it under shard_call or "
                           "mesh_utils.active(mesh)")
    if axis not in axis_names(mesh):
        raise ValueError(f"axis {axis!r} not in mesh axes "
                         f"{axis_names(mesh)}")
    return mesh.get_group(axis)


def active_axis_index(axis: str) -> int:
    """This rank's coordinate along ``axis`` of the active mesh (inside
    ``shard_call``: the counterpart of ``lax.axis_index``)."""
    mesh = _ACTIVE.get()
    if mesh is None or axis not in axis_names(mesh):
        raise RuntimeError(f"axis {axis!r} is not an axis of an active mesh: "
                           "run under shard_call or mesh_utils.active(mesh)")
    return axis_index(mesh, axis)


def psum(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``all_reduce`` SUM); the
    identity when ``axis`` is None.  ``x`` itself is left as it was."""
    if axis is None:
        return x
    group = _group(axis, x)
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def pmax(x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
    """Element-wise max of ``x`` over the ranks of ``axis`` (``all_reduce``
    MAX); the identity when ``axis`` is None."""
    if axis is None:
        return x
    group = _group(axis, x)
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_gather(x: torch.Tensor, axis: Optional[str],
               dim: int) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``axis``, concatenated along
    ``dim`` in axis order (the list form of ``all_gather``); the identity
    when ``axis`` is None."""
    if axis is None:
        return x
    group = _group(axis, x)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, axis: Optional[str],
              src_index: int) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src_index`` along ``axis``, on every
    rank of the axis (the other ranks' ``x`` gives only shape and dtype);
    the identity when ``axis`` is None."""
    if axis is None:
        return x
    group = _group(axis, x)
    y = x.contiguous().clone()
    src = dist.get_process_group_ranks(group)[src_index]
    dist.broadcast(y, src=src, group=group)
    return y


# ---------------------------------------------------------------------------
# shard_call — global tensors in, global tensors out
# ---------------------------------------------------------------------------

def _is_spec(s) -> bool:
    return s is None or isinstance(s, P)


def _map_spec(fn, spec, tree):
    """Apply ``fn(leaf, spec)`` to every tensor leaf of ``tree``; ``spec`` is
    one ``P`` (or None) for the whole tree, or a pytree of them mirroring
    it."""
    if _is_spec(spec):
        if isinstance(tree, dict):
            return {k: _map_spec(fn, spec, v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(_map_spec(fn, spec, v) for v in tree)
        return fn(tree, spec)
    if isinstance(tree, dict):
        return {k: _map_spec(fn, spec[k], v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and len(spec) == len(tree):
        return type(tree)(_map_spec(fn, s, v) for s, v in zip(spec, tree))
    raise ValueError(f"spec {spec!r} does not match the structure of its "
                     "tensors")


def shard_block(x: torch.Tensor, spec: Optional[P], mesh,
                what: str = "input") -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``."""
    if spec is None:
        return x
    for pos, name in enumerate(spec):
        if name is None:
            continue
        n = axis_size(mesh, name)
        if x.shape[pos] % n:
            raise ValueError(
                f"{what} dimension {pos} (extent {x.shape[pos]}) is not "
                f"divisible by |{name}|={n}")
        chunk = x.shape[pos] // n
        x = x.narrow(pos, axis_index(mesh, name) * chunk, chunk)
    return x


def gather_block(x: torch.Tensor, spec: Optional[P]) -> torch.Tensor:
    """The global tensor of which ``x`` is this rank's block under
    ``spec`` (inside the active mesh)."""
    if spec is None:
        return x
    for pos, name in enumerate(spec):
        x = all_gather(x, name, pos)
    return x


def shard_call(fn: Callable, mesh, in_specs: tuple, out_specs) -> Callable:
    """``fn`` (a per-rank body over blocks, issuing its own collectives) as
    a function of global tensors, as ``jax.shard_map(fn, mesh, in_specs,
    out_specs)`` is.  ``in_specs`` holds one spec (a ``P``, None, or a
    pytree of them) per argument; ``out_specs`` one for the output."""
    in_specs = tuple(in_specs)

    def call(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_call body takes {len(in_specs)} "
                            f"argument(s); got {len(args)}")
        with active(mesh):
            blocks = tuple(
                _map_spec(lambda x, s, i=i: shard_block(
                    x, s, mesh, f"input {i}"), spec, a)
                for i, (spec, a) in enumerate(zip(in_specs, args)))
            out = fn(*blocks)
            return _map_spec(gather_block, out_specs, out)

    return call
