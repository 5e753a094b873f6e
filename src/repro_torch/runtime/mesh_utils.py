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
  tensors there; nor is ``reduce_scatter``, which gloo lacks:
  ``psum_scatter`` is a ``psum`` and this rank's block.  Each helper is the
  identity when its axis is ``None`` (the reference's ``_psum_if``).
* **Autograd crosses the collectives by their exact transposes.**  Read a
  program of n ranks as one function of every rank's tensors; a collective
  is then a linear map, and its backward is that map's transpose:
  ``psum``'s is ``psum``, ``all_gather``'s is ``psum_scatter`` and
  ``psum_scatter``'s is ``all_gather``, ``broadcast``'s sums the
  gradients onto the source rank.  ``pmax`` passes no gradient: it serves
  as the stability max of a softmax, whose gradient cancels (the
  reference's ``_pmax_nograd``).  Backpropagating a loss that every rank
  holds (each seeding 1) then gives every rank's copy of a tensor its
  share of n times the true gradient: the shares of a tensor that several
  ranks hold add up over them.  So a gradient is finished by one sum over
  the ranks that hold copies of a leaf, divided by n — ``psum`` on the
  axes a leaf is replicated over (``runtime.sharding.sync_grads``), or,
  for ``shard_call``'s global inputs, ``_global_in``.  (A ``psum`` whose
  backward is the identity, Megatron's convention, is right only where
  everything after it is computed alike on every rank; a routing body
  mixes a replicated b with each rank's own û, so the port keeps the one
  convention that holds everywhere.)
* **An analysis sees every collective.**  Each one reports its kind,
  its result's bytes and its group's size to the callables in
  ``COLLECTIVE_HOOKS`` (``launch.op_analysis`` adds one while it is
  active; with none, a report is one test of an empty list).
  ``psum_scatter`` reports an all-reduce, which is what it issues.
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

from repro_torch.kernels import resolve_device

DEFAULT_AXIS = "vault"

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                         default=None)
# one default mesh per device type, as the default process group it wraps
# is one per process
_DEFAULT_MESHES: Dict[str, Any] = {}
# callables (kind, result bytes, group size) that see each collective
# (module docstring); empty unless an analysis is active
COLLECTIVE_HOOKS: list = []


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

def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda",
              ranks: Optional[Sequence[int]] = None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group, whose world size must be the product of
    ``shape``.  With no group yet and a 1-rank mesh, a 1-rank group is
    initialized over ``dist.HashStore()`` (NCCL for ``device="cuda"``,
    gloo for ``"cpu"``).  ``ranks`` (row-major global ranks) builds the
    mesh over those ranks of a larger group instead: every rank of the
    group calls it, and a rank outside the mesh holds no coordinate
    (``mesh.get_coordinate()`` is None).  On the card each rank selects
    its own card, ``rank % device_count``, unless ``device`` names one."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
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
    world = dist.get_world_size()
    if ranks is None and world != n:
        raise ValueError(f"mesh shape {shape} holds {n} ranks; the process "
                         f"group has {world}")
    if ranks is not None and (len(ranks) != n or len(set(ranks)) != n
                              or not all(0 <= r < world for r in ranks)):
        raise ValueError(f"mesh shape {shape} needs {n} distinct ranks of "
                         f"the group's {world}; got {tuple(ranks)}")
    if dev.type == "cuda":
        # select the card before the mesh does (several ranks may share it)
        torch.cuda.set_device(dev.index if dev.index is not None
                              else dist.get_rank() % torch.cuda.device_count())
    if ranks is None:
        return init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return DeviceMesh(dev.type, torch.tensor(list(ranks)).reshape(shape),
                      mesh_dim_names=axes)


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


def axis_size(mesh, axis) -> int:
    """The number of ranks along ``axis`` (a tuple of axes: their product;
    None: 1)."""
    return math.prod(mesh.size(axis_names(mesh).index(a))
                     for a in axis_tuple(axis))


def axis_index(mesh, axis) -> int:
    """This rank's coordinate along ``axis`` (over a tuple of axes, the
    row-major index of its coordinates: the order ``all_gather`` stacks
    them in)."""
    i = 0
    for a in axis_tuple(axis):
        i = i * axis_size(mesh, a) + mesh.get_local_rank(a)
    return i


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


def _group(axis: str):
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


def axis_tuple(axis) -> tuple:
    """An axis name, a tuple of them (a product of axes, as the
    reference's ``batch`` rule gives), or None, as a tuple of names."""
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _groups(axis, mesh=None) -> tuple:
    """The process groups of ``axis`` in ``mesh``, else in the active mesh.
    The autograd Functions below resolve them in the forward and keep them:
    a backward may run on another thread, where no mesh is active, and a
    recomputation under a checkpoint runs there too (so code that may be
    rematerialised names its mesh)."""
    if mesh is not None:
        return tuple(mesh.get_group(a) for a in axis_tuple(axis))
    return tuple(_group(a) for a in axis_tuple(axis))


def _report(kind: str, result: torch.Tensor, group) -> None:
    if COLLECTIVE_HOOKS:
        size = dist.get_world_size(group)
        nbytes = result.numel() * result.element_size()
        for hook in COLLECTIVE_HOOKS:
            hook(kind, nbytes, size)


def all_reduce_(x: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` of ``x`` in place over ``group``, reported to
    ``COLLECTIVE_HOOKS``; returns ``x``."""
    dist.all_reduce(x, op=op, group=group)
    _report("all-reduce", x, group)
    return x


def _all_reduce(x: torch.Tensor, groups, op) -> torch.Tensor:
    y = x.contiguous().clone()
    for g in groups:
        all_reduce_(y, g, op)
    return y


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _report("all-gather", out, group)
    return out


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, split over ``group``."""
    chunk = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * chunk, chunk)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _all_reduce(x, groups, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups, dist.ReduceOp.SUM), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, (ctx.group,), dist.ReduceOp.SUM)
        return _block(g, ctx.group, ctx.dim), None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block(_all_reduce(x, (group,), dist.ReduceOp.SUM), group,
                      dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src_index):
        ctx.group, ctx.src = group, src_index
        y = x.contiguous().clone()
        dist.broadcast(y, src=dist.get_process_group_ranks(group)[src_index],
                       group=group)
        _report("broadcast", y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, (ctx.group,), dist.ReduceOp.SUM)
        if dist.get_rank(ctx.group) != ctx.src:
            g = torch.zeros_like(g)
        return g, None, None


def psum(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (a name, a tuple of names:
    their product, or None: the identity); ``x`` itself is left as it
    was.  Its backward is ``psum`` (module docstring)."""
    if not axis_tuple(axis):
        return x
    return _PSum.apply(x, _groups(axis, mesh))


def pmax(x: torch.Tensor, axis, mesh=None) -> torch.Tensor:
    """Element-wise max of ``x`` over the ranks of ``axis`` (``all_reduce``
    MAX); the identity when ``axis`` is None.  No gradient passes it."""
    if not axis_tuple(axis):
        return x
    return _all_reduce(x.detach(), _groups(axis, mesh), dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis, dim: int, mesh=None) -> torch.Tensor:
    """The blocks of ``x`` of every rank of ``axis``, concatenated along
    ``dim`` in axis order (the list form of ``all_gather``; over a tuple
    of axes, the last one innermost); the identity when ``axis`` is None.
    Its backward is ``psum_scatter``."""
    for group in reversed(_groups(axis, mesh)):
        x = _AllGather.apply(x, group, dim)
    return x


def psum_scatter(x: torch.Tensor, axis, dim: int,
                 mesh=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the ranks
    of ``axis`` (``psum`` then the block: gloo has no reduce-scatter, so
    an analysis counts it as the all-reduce it issues); the identity when
    ``axis`` is None.  Its backward is ``all_gather``."""
    for group in _groups(axis, mesh):
        x = _PSumScatter.apply(x, group, dim)
    return x


def broadcast(x: torch.Tensor, axis: Optional[str],
              src_index: int) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src_index`` along ``axis``, on every
    rank of the axis (the other ranks' ``x`` gives only shape and dtype);
    the identity when ``axis`` is None.  Its backward sums the gradients
    onto the source rank."""
    if axis is None:
        return x
    return _Broadcast.apply(x, _group(axis), src_index)


class _GlobalIn(torch.autograd.Function):
    """A global input of ``shard_call``: the identity forward; the backward
    sums the rank's gradient share over every rank of the mesh and divides
    by their number, which makes it the true gradient on every rank
    (module docstring)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.groups = tuple(mesh.get_group(a) for a in axis_names(mesh))
        ctx.n = mesh.size()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups, dist.ReduceOp.SUM) / ctx.n, None


def _global_in(x, mesh):
    if isinstance(x, torch.Tensor) and x.requires_grad \
            and torch.is_grad_enabled():
        return _GlobalIn.apply(x, mesh)
    return x


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
    out_specs)`` is.  Differentiable: the gradient of a global input is
    the true one on every rank (``_GlobalIn``).  ``in_specs`` holds one spec (a ``P``, None, or a
    pytree of them) per argument; ``out_specs`` one for the output."""
    in_specs = tuple(in_specs)

    def call(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_call body takes {len(in_specs)} "
                            f"argument(s); got {len(args)}")
        with active(mesh):
            blocks = tuple(
                _map_spec(lambda x, s, i=i: shard_block(
                    _global_in(x, mesh), s, mesh, f"input {i}"), spec, a)
                for i, (spec, a) in enumerate(zip(in_specs, args)))
            out = fn(*blocks)
            return _map_spec(gather_block, out_specs, out)

    return call
