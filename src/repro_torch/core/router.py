"""Unified Router API — one entry point for algorithm x backend x plan.

Port of the JAX package's ``repro/core/router.py``:

    spec = RouterSpec(algorithm="dynamic", backend="cuda", iterations=3)
    plan = ExecutionPlan(mesh=mesh, axes=(("B", "vault"),))
    router = build_router(spec, plan, device="cuda")
    v = router(u_hat)                       # u_hat (B, L, H, C) -> v (B, H, C)

* RouterSpec — WHAT to route: an algorithm from the registry ("dynamic",
  paper Algorithm 1, "em", matrix-capsule EM routing over (votes, a_in),
  or "moe", top-k expert dispatch) and a backend: "torch" (the eager
  PyTorch path, the counterpart of the reference's "jnp" and the default)
  or "cuda" (the hand-written Hopper kernels, the counterpart of
  "pallas").  ``fusion``
  picks the whole-procedure kernel or the per-iteration kernel,
  ``stream_dtype`` the û stream (fp32 | bf16 | int8), ``early_exit_eps``
  per-tile early exit, ``differentiable`` training through the procedure
  kernel's recompute-b backward.  Under a sharded plan the cuda backend
  runs the stage-split kernels with the cross-shard collectives between
  them (``kernels/routing/ops.dynamic_routing_fused_sharded``).
* ExecutionPlan — WHERE/HOW: unsharded; one or several dims sharded over
  the axes of a ``torch.distributed`` device mesh (the paper's §5.1
  inter-vault distribution, ``runtime.mesh_utils``); ``auto=True``, where
  the §5.1.2 planner (``core.distribution``) picks the dim from the votes
  shape and the mesh; or the §4 pipeline, ``"software"`` (one rank group)
  or ``"two_stage"`` (the stages on the two halves of a "pipe" axis), with
  the distribution applied to the routing stage inside it.
* build_router(spec, plan, device) — the façade.  ``device`` defaults to
  the card and raises when there is none; the router checks that its
  inputs live there.  A sharded router takes and returns global tensors,
  as the reference's ``jit(shard_map(...))`` does.

Training under a sharded plan runs on the torch backend, by autograd
through the collectives (``runtime.mesh_utils``: their backward formulas;
a global input's gradient is the true one on every rank), as the
reference's differentiates its jnp backend.  The cuda backend's
differentiable form stays shard-local.  The "moe" algorithm runs
unsharded or expert-parallel under an "E"-sharded plan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import distribution as dist_lib
from repro_torch.core import em_routing as em_lib
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import routing as routing_lib
from repro_torch.kernels import resolve_device
from repro_torch.runtime import mesh_utils, spans

P = mesh_utils.P

BACKENDS = ("torch", "cuda")


# ---------------------------------------------------------------------------
# RouterSpec — algorithm x backend (+ static algorithm options)
# ---------------------------------------------------------------------------

class RouterSpec(NamedTuple):
    """Static routing specification (hashable).

    algorithm: registry name ("dynamic", "em" or "moe").
    backend:   "torch" (eager PyTorch, default) or "cuda" (the Hopper
               kernels; their plain versions on a CPU tensor).
    fusion:    cuda-backend kernel form: "auto" (the procedure kernel when
               the reference's working-set model fits, the per-iteration
               kernel otherwise), "procedure" or "iteration".
    stream_dtype: û stream on the cuda backend: "fp32", "bf16" or "int8"
               (per-L-tile symmetric scale; procedure kernel only).
    early_exit_eps: per-tile early exit inside the procedure kernel
               (‖Δb‖∞ < ε after iteration 0 freezes a tile's couplings;
               ε = 0 is the fixed grid, None turns it off).
    differentiable: gradients will flow through the router.  On the cuda
               backend it resolves to the procedure kernel wrapped in an
               autograd Function whose backward is the recompute-b kernel
               (or, where the procedure form does not fit, plain autograd
               of the torch path); the torch backend is differentiable by
               construction.
    options:   algorithm-specific extras as a sorted (name, value) tuple
               (EM's beta_a, beta_u, inv_temp and eps; the MoEConfig of
               "moe" as moe_cfg).
    """
    algorithm: str = "dynamic"
    backend: str = "torch"
    iterations: int = 3
    use_approx: bool = False
    options: Tuple[Tuple[str, Any], ...] = ()
    fusion: str = "auto"
    stream_dtype: str = "fp32"
    differentiable: bool = False
    early_exit_eps: Optional[float] = None

    def option(self, name: str, default: Any = None) -> Any:
        for k, v in self.options:
            if k == name:
                return v
        return default

    def with_options(self, **kw) -> "RouterSpec":
        merged = dict(self.options)
        merged.update(kw)
        return self._replace(options=tuple(sorted(merged.items())))


def reference_spec(spec: RouterSpec) -> RouterSpec:
    """The eager reference twin of ``spec``: same algorithm, iterations and
    options on the "torch" backend with every kernel-only knob reset.  The
    serving output guard's NaN/Inf re-run target."""
    return spec._replace(backend="torch", fusion="auto", stream_dtype="fp32",
                         early_exit_eps=None, use_approx=False)


# ---------------------------------------------------------------------------
# Algorithm registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A routing algorithm over the common (B, L, H, C) vote layout.

    run(args, spec, axes): the per-rank computation; ``axes`` maps each
        sharded logical dim to its mesh axis and the implementation inserts
        the matching cross-shard collectives (paper Table 2).
    in_specs/out_specs(axes): the ``mesh_utils.P`` specs of the inputs and
        outputs under that mapping.
    sharded_dims: logical dims the algorithm can shard ("B"/"L"/"H").
    backends: supported backends.
    """
    name: str
    run: Callable[[tuple, RouterSpec, Mapping[str, str]], Any]
    in_specs: Callable[[Mapping[str, str]], tuple] = lambda ax: ()
    out_specs: Callable[[Mapping[str, str]], Any] = lambda ax: None
    sharded_dims: Tuple[str, ...] = ("B", "L", "H")
    backends: Tuple[str, ...] = ("torch",)
    num_inputs: int = 1
    describe: str = ""


_REGISTRY: Dict[str, Algorithm] = {}


def register_algorithm(algo: Algorithm) -> Algorithm:
    if algo.name in _REGISTRY:
        raise ValueError(f"algorithm {algo.name!r} already registered")
    _REGISTRY[algo.name] = algo
    return algo


def get_algorithm(name: str) -> Algorithm:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown routing algorithm {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def registered_algorithms() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _capsule_route(run: Callable) -> Callable:
    """A capsule routing algorithm's ``run`` inside the ``capsnet.route``
    span (``runtime.spans``): one span a call, so a pipelined wave opens
    one a microbatch, around the stream cast, the copy of û and the
    kernels' launches."""
    def spanned(args, spec: RouterSpec, axes: Mapping[str, str]):
        with spans.span("capsnet.route"):
            return run(args, spec, axes)
    return spanned


# --- "dynamic" [Sabour et al. 2017] — paper Algorithm 1 --------------------

def _dynamic_run(args, spec: RouterSpec, axes: Mapping[str, str]):
    (u_hat,) = args
    if spec.backend == "cuda" and spec.differentiable:
        # gradients flow through the recompute-b autograd Function of the
        # procedure kernel.  _validate already rejected sharded/pipelined
        # plans, use_approx, int8 and early exit; what remains is the fit:
        # where the procedure form does not fit, fall back to autograd of
        # the torch path (the gradient reference), never to a forward-only
        # kernel
        from repro_torch.kernels.routing import ops as routing_ops
        form = routing_ops.resolve_fusion(spec.fusion, tuple(u_hat.shape),
                                          spec.stream_dtype)
        if form == "procedure":
            return routing_ops.dynamic_routing_procedure_train(
                u_hat, iterations=spec.iterations,
                use_approx=spec.use_approx, stream_dtype=spec.stream_dtype)
        cfg = routing_lib.RoutingConfig(iterations=spec.iterations,
                                        use_approx=spec.use_approx)
        return routing_lib.dynamic_routing(u_hat, cfg)
    if spec.backend == "cuda":
        from repro_torch.kernels.routing import ops as routing_ops
        form = routing_ops.resolve_fusion(
            spec.fusion, tuple(u_hat.shape), spec.stream_dtype,
            sharded=bool(axes), early_exit=spec.early_exit_eps is not None)
        if form == "stage_split":
            # the stage kernels with the cross-shard collectives at the
            # Table-2 aggregation points
            return routing_ops.dynamic_routing_fused_sharded(
                u_hat, axes=axes, iterations=spec.iterations,
                use_approx=spec.use_approx, stream_dtype=spec.stream_dtype)
        if form == "procedure":
            return routing_ops.dynamic_routing_procedure_fused(
                u_hat, iterations=spec.iterations,
                use_approx=spec.use_approx, stream_dtype=spec.stream_dtype,
                early_exit_eps=spec.early_exit_eps)
        return routing_ops.dynamic_routing_fused(
            u_hat, iterations=spec.iterations, use_approx=spec.use_approx,
            stream_dtype=spec.stream_dtype)
    cfg = routing_lib.RoutingConfig(
        iterations=spec.iterations, use_approx=spec.use_approx,
        axes=tuple(sorted(axes.items())) or None)
    return routing_lib.dynamic_routing(u_hat, cfg)


DYNAMIC = register_algorithm(Algorithm(
    name="dynamic",
    run=_capsule_route(_dynamic_run),
    in_specs=lambda ax: (P(ax.get("B"), ax.get("L"), ax.get("H"), None),),
    out_specs=lambda ax: P(ax.get("B"), ax.get("H"), None),
    sharded_dims=("B", "L", "H"),
    backends=("torch", "cuda"),
    describe="dynamic routing (paper Alg.1): u_hat (B,L,H,C) -> v (B,H,C)",
))


# --- "em" [Hinton, Sabour, Frosst 2018] ------------------------------------

def _em_run(args, spec: RouterSpec, axes: Mapping[str, str]):
    votes, a_in = args
    opts = dict(beta_a=spec.option("beta_a", 1.0),
                beta_u=spec.option("beta_u", 1.0),
                inv_temp=spec.option("inv_temp", 1.0),
                eps=spec.option("eps", 1e-9))
    if spec.backend == "cuda":
        from repro_torch.kernels.routing import ops as routing_ops
        return routing_ops.em_routing_fused(
            votes, a_in, axes=axes, iterations=spec.iterations, **opts)
    cfg = em_lib.EMRoutingConfig(iterations=spec.iterations,
                                 sharded_dim="L" if "L" in axes else None,
                                 axis_name=axes.get("L"), **opts)
    return em_lib.em_routing(votes, a_in, cfg)


EM = register_algorithm(Algorithm(
    name="em",
    run=_capsule_route(_em_run),
    in_specs=lambda ax: (P(ax.get("B"), ax.get("L"), None, None),
                         P(ax.get("B"), ax.get("L"))),
    # pose (B,H,C) + activations (B,H); the L-psums leave outputs
    # replicated on L's axis, so only B stays sharded
    out_specs=lambda ax: (P(ax.get("B"), None, None), P(ax.get("B"), None)),
    # H-sharding would split the per-H Gaussian statistics
    sharded_dims=("B", "L"),
    backends=("torch", "cuda"),
    num_inputs=2,
    describe="EM routing: votes (B,L,H,C) + a_in (B,L) -> (pose, a_out)",
))


# --- "moe" top-k expert dispatch -------------------------------------------
#
# MoE expert dispatch has the routing procedure's shape (per-token
# assignment logits, a cross-token aggregation bounded by capacity), so it
# registers here as an algorithm, as in the reference, and its
# expert-parallel plan is the Table-2 seam: "E" on a mesh axis shards the
# expert stacks, each rank dispatches to its own slots, and y is psum'd.
# The torch backend; args are ``models.moe.router_args(params)`` order.

def _moe_run(args, spec: RouterSpec, axes: Mapping[str, str]):
    # lazy: CapsNet routing never pays the models-package import
    from repro_torch.models import moe as moe_lib
    x2d, router_w, w_gate, w_up, w_down = args
    cfg = spec.option("moe_cfg")
    if cfg is None:
        raise ValueError(
            "algorithm 'moe' needs the static MoEConfig in the spec "
            "options: RouterSpec(algorithm='moe', "
            "options=(('moe_cfg', cfg),))")
    axis = axes.get("E")
    offset = (mesh_utils.active_axis_index(axis) * w_gate.shape[0]
              if axis is not None else 0)
    return moe_lib._moe_local(x2d, router_w, w_gate, w_up, w_down, cfg,
                              offset, axis)


MOE = register_algorithm(Algorithm(
    name="moe",
    run=_moe_run,
    # tokens + router replicated; the three expert stacks sharded on E
    in_specs=lambda ax: (P(None, None), P(None, None),
                         P(ax.get("E"), None, None),
                         P(ax.get("E"), None, None),
                         P(ax.get("E"), None, None)),
    # y (T, D) is psum'd over the expert axis inside _moe_local, aux comes
    # from replicated statistics: both leave the call replicated
    out_specs=lambda ax: (P(None, None), P()),
    sharded_dims=("E",),
    backends=("torch",),
    num_inputs=5,
    describe="MoE top-k dispatch: x (T,D) + router/expert weights -> "
             "(y (T,D), aux)",
))


# ---------------------------------------------------------------------------
# ExecutionPlan — distribution + pipelining
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Where and how the routing procedure executes.

      ExecutionPlan()                                   unsharded
      ExecutionPlan(mesh=m, axes=(("B", "vault"),))     one dim sharded
      ExecutionPlan(mesh=m, axes=(("B", "data"),
                                  ("L", "model")))      several dims
      ExecutionPlan(mesh=m, auto=True)                  §5.1.2 planner picks
      ExecutionPlan(mesh=m, pipeline="two_stage", ...)  paper §4 host||PIM
      ExecutionPlan(pipeline="software")                skewed-loop overlap

    mesh: a ``torch.distributed`` ``DeviceMesh`` (``mesh_utils.make_mesh``);
        None means ``mesh_utils.default_mesh`` (every rank on "vault").
    auto: derive the RPShape from the votes shape (or use ``rp_shape``) and
        a DeviceModel from the mesh (or use ``device``; default
        ``DeviceModel.h100`` sized to the axis), and shard the argmax of
        the execution score among the shardable dims the axis size divides.
    pipeline: "software" (one rank group, skewed loop) or "two_stage"
        (disjoint rank groups on ``pipeline_axis``, |axis| == 2); the router
        then consumes stacked microbatches — a pytree whose leaves are
        (n_micro, ...).  ``stage_a`` is the producer stage (e.g. conv +
        votes), identity when omitted; for multi-input algorithms (EM) it
        returns the algorithm's input tuple in argument order.  Pipeline
        plans compose with axes/auto: the distribution applies to the
        routing stage inside the pipeline, over the non-pipe mesh axes,
        resolved against the stage_a output (votes) shape.
    """
    mesh: Any = None
    axes: Tuple[Tuple[str, str], ...] = ()
    auto: bool = False
    device: Optional[dist_lib.DeviceModel] = None
    rp_shape: Optional[dist_lib.RPShape] = None
    pipeline: Optional[str] = None
    pipeline_axis: str = "pipe"
    stage_a: Optional[Callable] = None

    def __post_init__(self):
        if self.pipeline not in (None, "software", "two_stage"):
            raise ValueError(f"unknown pipeline kind {self.pipeline!r}")
        if self.axes and self.auto:
            raise ValueError("ExecutionPlan: give explicit axes OR auto=True,"
                             " not both")
        dims = [d for d, _ in self.axes]
        if len(set(dims)) != len(dims):
            raise ValueError(f"duplicate logical dims in axes {self.axes}")
        names = [a for _, a in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axes in axes {self.axes}; "
                             "each sharded dim needs its own mesh axis")
        for d, a in self.axes:
            if self.mesh is None:
                raise ValueError("ExecutionPlan with sharded axes needs a "
                                 "mesh")
            if a not in mesh_utils.axis_names(self.mesh):
                raise ValueError(f"axis {a!r} not in mesh axes "
                                 f"{mesh_utils.axis_names(self.mesh)}")


def _normalize_plan(plan) -> ExecutionPlan:
    if plan is None:
        return ExecutionPlan()
    if isinstance(plan, str):
        if plan == "auto":
            return ExecutionPlan(auto=True)
        raise ValueError(f"unknown plan {plan!r} (expected None, 'auto', or "
                         "an ExecutionPlan)")
    if isinstance(plan, ExecutionPlan):
        return plan
    raise TypeError(f"plan must be None, 'auto', or ExecutionPlan; got "
                    f"{type(plan).__name__}")


def _default_mesh(device="cuda"):
    """Every rank of the default group on one axis, "vault" — the paper's
    vault array (one rank when the caller started no group)."""
    return mesh_utils.default_mesh(device)


def derive_rp_shape(algorithm: str, shapes: tuple, iterations: int
                    ) -> dist_lib.RPShape:
    """RPShape (paper Table 3) from the router's input shapes.  The votes
    are (B, L, H, C_H) for both registered algorithms; C_L is not
    recoverable from them (Eq.1 already consumed it), so C_H stands for
    both, as in the reference."""
    B, L, H, C = shapes[0]
    return dist_lib.RPShape(n_b=B, n_l=L, n_h=H, c_l=C, c_h=C,
                            iters=iterations)


def plan_axes(spec: RouterSpec, plan: ExecutionPlan, shapes: tuple, *,
              device="cuda") -> Tuple[Tuple[str, str], ...]:
    """Resolve an auto plan to concrete (dim, mesh_axis) pairs.

    Feasible dims are the algorithm's shardable dims whose extent the mesh
    axis size divides; among those, the argmax of the §5.1.2 execution
    score.  The mesh's first axis hosts the distribution — the first
    non-pipe axis under a pipeline plan.  ``device`` is where the default
    mesh lives when the plan has none."""
    mesh = plan.mesh if plan.mesh is not None else _default_mesh(device)
    candidates = [a for a in mesh_utils.axis_names(mesh)
                  if not (plan.pipeline is not None
                          and a == plan.pipeline_axis)]
    if not candidates:
        return ()
    axis = candidates[0]
    n = mesh_utils.axis_size(mesh, axis)
    algo = get_algorithm(spec.algorithm)
    if not set(algo.sharded_dims) & {"B", "L", "H"}:
        return ()
    s = plan.rp_shape or derive_rp_shape(spec.algorithm, shapes,
                                         spec.iterations)
    # an explicit DeviceModel keeps its own operating point (e.g. the
    # paper's 32-vault HMC); only the default model is sized to the mesh
    dev = plan.device or dist_lib.DeviceModel.h100(n)
    extents = {"B": s.n_b, "L": s.n_l, "H": s.n_h}
    feasible = [d for d in algo.sharded_dims if extents[d] % n == 0]
    if not feasible:
        return ()
    table = dist_lib.score_table(s, dev)
    best = max(feasible, key=table.__getitem__)
    return ((best, axis),)


# ---------------------------------------------------------------------------
# build_router
# ---------------------------------------------------------------------------

class ResolvedPlan(tuple):
    """``Router.resolve()`` result: the tuple of concrete (dim, mesh_axis)
    pairs, plus the resolved kernel execution:

    fusion:       "procedure" | "iteration" | "stage_split" for dynamic
                  routing on the cuda backend ("stage_split" under a
                  sharded plan), "stage_split" for EM on it; None for the
                  torch backend (and for the differentiable fallback).
    stream_dtype: "fp32" | "bf16" | "int8"; None for torch.
    differentiable: True when gradients run through the recompute-b
                  backward kernel; False on the torch path.
    early_exit_eps: the threshold the procedure kernel runs with; None when
                  off or on the torch backend.
    """

    def __new__(cls, axes=(), fusion=None, stream_dtype=None,
                differentiable=False, early_exit_eps=None):
        self = super().__new__(cls, tuple(axes))
        self.fusion = fusion
        self.stream_dtype = stream_dtype
        self.differentiable = differentiable
        self.early_exit_eps = early_exit_eps
        return self

    def __repr__(self):
        return (f"ResolvedPlan(axes={tuple(self)}, fusion={self.fusion!r}, "
                f"stream_dtype={self.stream_dtype!r}, "
                f"differentiable={self.differentiable!r}, "
                f"early_exit_eps={self.early_exit_eps!r})")


def _device_of(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Router:
    """The callable built by ``build_router``; carries its spec, plan and
    device and exposes ``resolve(*args)``."""

    def __init__(self, spec: RouterSpec, plan: ExecutionPlan,
                 device="cuda"):
        self.spec = spec
        self.plan = plan
        self.algorithm = get_algorithm(spec.algorithm)
        _validate(self.algorithm, spec, plan)
        self.device = _device_of(device)
        self._cache: Dict[tuple, Callable] = {}

    # -- plan resolution ----------------------------------------------------

    def resolve(self, *args) -> ResolvedPlan:
        """Concrete execution for these inputs: the (dim, mesh_axis) pairs
        and the kernel form.  With a pipeline plan the distribution lives
        inside the routing stage, so it resolves against stage_a's output
        for one microbatch (stage_a runs once on microbatch 0)."""
        if args and self.plan.pipeline is not None:
            shapes = tuple(s.shape for s in pipeline_lib.tree_leaves(
                self._hidden_struct(args[0])))
        else:
            shapes = tuple(tuple(a.shape) for a in args)
        axes = self._resolve_shapes(shapes)
        return ResolvedPlan(axes, *self._resolve_fusion(axes, shapes))

    def _resolve_fusion(self, axes, shapes):
        """(fusion, stream_dtype, differentiable, early_exit_eps) the cuda
        backend executes with — the same ``resolve_fusion`` the run path
        calls.  A no-arg resolve reports fusion None where "auto" would
        need the votes shape (except int8 / early exit, which resolve
        "procedure" without one)."""
        if self.spec.backend != "cuda":
            return None, None, False, None
        if self.spec.algorithm != "dynamic":
            # EM: the stage kernels are its only form
            return "stage_split", "fp32", False, None
        early_exit = self.spec.early_exit_eps is not None
        deep_edge = self.spec.stream_dtype == "int8" or early_exit
        if (not shapes and not axes and self.spec.fusion == "auto"
                and not deep_edge):
            return None, self.spec.stream_dtype, False, None
        from repro_torch.kernels.routing import ops as routing_ops
        form = routing_ops.resolve_fusion(self.spec.fusion,
                                          shapes[0] if shapes else None,
                                          self.spec.stream_dtype,
                                          sharded=bool(axes),
                                          early_exit=early_exit)
        if self.spec.differentiable:
            # mirrors _dynamic_run: the backward kernel exists for the
            # procedure form only; anything else is the torch fallback
            if form == "procedure" and not axes:
                return "procedure", self.spec.stream_dtype, True, None
            return None, None, False, None
        return form, self.spec.stream_dtype, False, self.spec.early_exit_eps

    def _resolve_shapes(self, shapes: tuple) -> Tuple[Tuple[str, str], ...]:
        if not self.plan.auto:
            return tuple(self.plan.axes)
        if self.spec.backend == "cuda" and (
                self.spec.differentiable
                or self.spec.stream_dtype == "int8"
                or self.spec.early_exit_eps is not None):
            # these auto plans resolve shard-local: the planner's sharded
            # pick would force the stage-split form, which has no backward,
            # no int8 dequant path and no convergence scratch
            return ()
        return plan_axes(self.spec, self.plan, shapes, device=self.device)

    def _hidden_struct(self, micro):
        """The ``TensorSpec`` pytree of stage_a's output for one microbatch
        of stacked pipeline inputs (stage_a runs on microbatch 0)."""
        stage_a = self.plan.stage_a or (lambda x: x)
        return pipeline_lib.tree_spec(
            stage_a(pipeline_lib.microbatch_at(micro, 0)))

    def _mesh(self):
        return (self.plan.mesh if self.plan.mesh is not None
                else _default_mesh(self.device))

    # -- executor construction ---------------------------------------------

    def _core_fn(self, axes: Tuple[Tuple[str, str], ...]) -> Callable:
        """The algorithm as a function of global tensors: unsharded, or
        through ``mesh_utils.shard_call`` with the per-rank body inserting
        the Table-2 collectives itself (both backends)."""
        algo, spec = self.algorithm, self.spec
        ax = dict(axes)
        if not axes:
            return lambda *args: algo.run(args, spec, {})
        return mesh_utils.shard_call(
            lambda *args: algo.run(args, spec, ax), self._mesh(),
            tuple(algo.in_specs(ax)), algo.out_specs(ax))

    def _stage_b(self, axes: Tuple[Tuple[str, str], ...]) -> Callable:
        """Pipeline stage B: the algorithm consuming the stage-A hand-off —
        a bare votes tensor for 1-input algorithms, a tuple in argument
        order for multi-input ones (EM's (votes, a_in))."""
        core = self._core_fn(axes)
        if self.algorithm.num_inputs == 1:
            return core
        return lambda h: core(*h)

    def _pipelined_fn(self, micro) -> Callable:
        plan = self.plan
        stage_a = plan.stage_a or (lambda x: x)
        hidden = self._hidden_struct(micro)
        shapes = tuple(s.shape for s in pipeline_lib.tree_leaves(hidden))
        axes = self._resolve_shapes(shapes)
        if plan.pipeline == "software":
            stage_b = self._stage_b(axes)
            return lambda m: pipeline_lib.software_pipeline_scan(
                stage_a, stage_b, m)
        if not axes:
            return pipeline_lib.two_stage_pipeline(
                stage_a, self._stage_b(()), self._mesh(),
                plan.pipeline_axis, hidden)
        return self._two_stage_sharded_fn(stage_a, hidden, axes)

    def _two_stage_sharded_fn(self, stage_a: Callable, hidden,
                              axes: Tuple[Tuple[str, str], ...]) -> Callable:
        """§4 pipeline with the §5.1 vault distribution inside the PIM
        stage: one shard_call spans the pipe axis and every vault axis;
        stage B is the per-rank algorithm body with its Table-2 collectives
        per vault axis.  B-sharded plans shard the pipeline inputs (each
        vault's host rank encodes its own lanes — logical B is the stacked
        inputs' lane dim); other sharded dims replicate the encoder, and
        each host rank slices its vault's block before the hand-off, the
        paper's host-computes-votes, scatters-to-vaults traffic.  Each
        sharded dim's position in each stage-B input comes from the
        algorithm's own ``in_specs``."""
        plan, algo, spec = self.plan, self.algorithm, self.spec
        mesh = self._mesh()
        ax = dict(axes)
        in_specs = tuple(algo.in_specs(ax))
        structs = list(hidden) if algo.num_inputs > 1 else [hidden]
        if len(structs) != len(in_specs):
            raise ValueError(
                f"stage_a must hand off {algo.num_inputs} leaves in "
                f"{algo.name!r}'s argument order; got {len(structs)}")
        axis_dim = {a: d for d, a in axes}
        b_axis = ax.get("B")

        def shard_struct(struct, ispec):
            shape = list(struct.shape)
            for pos, name in enumerate(ispec):
                if name is None:
                    continue
                n = mesh_utils.axis_size(mesh, name)
                if shape[pos] % n:
                    raise ValueError(
                        f"votes dim {axis_dim[name]}={shape[pos]} not "
                        f"divisible by |{name}|={n}")
                shape[pos] //= n
            return pipeline_lib.TensorSpec(tuple(shape), struct.dtype)

        per_shard = tuple(shard_struct(s, i)
                          for s, i in zip(structs, in_specs))
        a_out_shape = per_shard if algo.num_inputs > 1 else per_shard[0]

        def stage_a_shard(x):
            h = stage_a(x)
            leaves = list(h) if algo.num_inputs > 1 else [h]
            out = []
            for leaf, ispec in zip(leaves, in_specs):
                for pos, name in enumerate(ispec):
                    if name is None or name == b_axis:
                        continue    # B arrived pre-sharded via the inputs
                    leaf = mesh_utils.shard_block(leaf, P(*([None] * pos),
                                                          name), mesh)
                out.append(leaf.contiguous())
            return tuple(out) if algo.num_inputs > 1 else out[0]

        def stage_b_shard(h):
            args = tuple(h) if algo.num_inputs > 1 else (h,)
            return algo.run(args, spec, ax)

        in_spec = P(None, b_axis) if b_axis is not None else P(None)
        outs = algo.out_specs(ax)
        if isinstance(outs, P):
            out_spec = P(None, *outs)
        else:
            out_spec = tuple(P(None, *o) for o in outs)
        return pipeline_lib.two_stage_pipeline(
            stage_a_shard, stage_b_shard, mesh, plan.pipeline_axis,
            a_out_shape, in_spec=in_spec, out_spec=out_spec,
            stage_b_collectives=True)

    def _executor(self, args) -> Callable:
        leaves = pipeline_lib.tree_leaves(args)
        key = tuple((tuple(l.shape), l.dtype) for l in leaves)
        fn = self._cache.get(key)
        if fn is None:
            if self.plan.pipeline is not None:
                fn = self._pipelined_fn(args[0])
            else:
                fn = self._core_fn(self._resolve_shapes(
                    tuple(tuple(a.shape) for a in args)))
            self._cache[key] = fn
        return fn

    def _check_device(self, args) -> None:
        for leaf in pipeline_lib.tree_leaves(args):
            if isinstance(leaf, torch.Tensor) and leaf.device != self.device:
                raise ValueError(f"router input is on {leaf.device}; this "
                                 f"router runs on {self.device}")

    def __call__(self, *args):
        self._check_device(args)
        if self.plan.pipeline is not None:
            if len(args) != 1:
                raise TypeError("a pipelined router takes one pytree of "
                                f"stacked microbatches; got {len(args)}")
        elif len(args) != self.algorithm.num_inputs:
            raise TypeError(
                f"{self.spec.algorithm!r} router takes "
                f"{self.algorithm.num_inputs} input(s) "
                f"({self.algorithm.describe or 'see registry entry'}); "
                f"got {len(args)}")
        return self._executor(args)(*args)

    def __repr__(self):
        return (f"Router(algorithm={self.spec.algorithm!r}, "
                f"backend={self.spec.backend!r}, "
                f"fusion={self.spec.fusion!r}, "
                f"stream_dtype={self.spec.stream_dtype!r}, "
                f"differentiable={self.spec.differentiable!r}, "
                f"early_exit_eps={self.spec.early_exit_eps!r}, "
                f"plan={'auto' if self.plan.auto else self.plan.axes}, "
                f"pipeline={self.plan.pipeline!r}, device={self.device})")


def _validate(algo: Algorithm, spec: RouterSpec, plan: ExecutionPlan):
    """The reference's error surface (``router.py:786``)."""
    from repro_torch.kernels.routing import vocab as routing_vocab
    if spec.backend not in BACKENDS:
        raise ValueError(f"unknown backend {spec.backend!r}; expected one "
                         f"of {BACKENDS}")
    if spec.backend not in algo.backends:
        raise ValueError(
            f"algorithm {algo.name!r} has no {spec.backend!r} backend "
            f"(supported: {algo.backends}); register a kernel for it or "
            "use backend='torch'")
    if spec.fusion not in routing_vocab.FUSION_LEVELS:
        raise ValueError(f"unknown fusion level {spec.fusion!r}; expected "
                         f"one of {routing_vocab.FUSION_LEVELS}")
    if spec.stream_dtype not in routing_vocab.STREAM_DTYPES:
        raise ValueError(f"unknown stream_dtype {spec.stream_dtype!r}; "
                         f"expected one of "
                         f"{tuple(sorted(routing_vocab.STREAM_DTYPES))}")
    cuda_dynamic = spec.backend == "cuda" and algo.name == "dynamic"
    if spec.fusion != "auto" and not cuda_dynamic:
        raise ValueError(
            f"fusion={spec.fusion!r} is a cuda-backend knob of the "
            "'dynamic' algorithm (EM and the torch backend have no fused "
            "megakernel); leave fusion='auto'")
    if spec.stream_dtype != "fp32" and not cuda_dynamic:
        raise ValueError(
            f"stream_dtype={spec.stream_dtype!r} requires the 'dynamic' "
            "algorithm on the cuda backend (the torch path and the EM "
            "kernels stream fp32)")
    if spec.fusion == "procedure" and plan.axes:
        raise ValueError(
            "fusion='procedure' is shard-local (the megakernel keeps b/v/s "
            "on chip across iterations and cannot surface for the Table-2 "
            "collectives); use fusion='auto' or 'iteration' with sharded "
            "plans")
    if spec.early_exit_eps is not None:
        eps = spec.early_exit_eps
        if not isinstance(eps, (int, float)) or isinstance(eps, bool) \
                or not float(eps) >= 0.0:
            raise ValueError(
                f"early_exit_eps must be a float >= 0 (the ‖Δb‖∞ "
                f"convergence threshold; 0 keeps the fixed grid) or None; "
                f"got {eps!r}")
        if not cuda_dynamic:
            raise ValueError(
                "early_exit_eps is a cuda-backend knob of the 'dynamic' "
                "algorithm (only the procedure kernel tracks per-tile "
                "convergence); leave early_exit_eps=None")
        if spec.fusion == "iteration":
            raise ValueError(
                "early_exit_eps requires the procedure megakernel: "
                "fusion='iteration' has no per-tile convergence scratch; "
                "use fusion='auto' or 'procedure'")
        if plan.axes:
            raise ValueError(
                "early-exit routing is shard-local: the per-tile "
                "convergence scratch lives in the procedure megakernel, "
                "which cannot surface for the Table-2 collectives; use an "
                "unsharded plan (plan=None or 'auto')")
        if spec.differentiable:
            raise ValueError(
                "differentiable=True requires early_exit_eps=None: the "
                "recompute-b backward replays the fixed-grid schedule "
                "(data-dependent tile skipping has no replay); train "
                "fixed-grid, serve early-exit")
    if spec.stream_dtype == "int8":
        if spec.differentiable:
            raise ValueError(
                "differentiable=True requires stream_dtype 'fp32' or "
                "'bf16': int8 û quantization rounds to the nearest code "
                "(no derivative) and the backward megakernel has no "
                "dequant path; train fp32/bf16, serve int8")
        if spec.fusion == "iteration":
            raise ValueError(
                "stream_dtype='int8' requires the procedure megakernel "
                "(per-tile scales and dequant are megakernel-only); use "
                "fusion='auto' or 'procedure'")
        if plan.axes:
            raise ValueError(
                "stream_dtype='int8' is shard-local: only the procedure "
                "megakernel has a dequant path, and it cannot surface for "
                "the Table-2 collectives; use an unsharded plan (plan=None "
                "or 'auto')")
    if spec.differentiable and spec.backend == "cuda":
        # the recompute-b backward exists for the 'dynamic' procedure
        # kernel only
        if algo.name != "dynamic":
            raise ValueError(
                "differentiable=True on the cuda backend requires the "
                "'dynamic' algorithm — only the procedure megakernel has a "
                "custom VJP; use backend='torch' for differentiable "
                f"{algo.name!r} routing")
        if spec.use_approx:
            raise ValueError(
                "differentiable=True requires use_approx=False: the §5.2.2 "
                "bit-manipulation approximations have no derivative "
                "(bitcast is not differentiable); train exact, serve "
                "approx")
        if spec.fusion == "iteration":
            raise ValueError(
                "fusion='iteration' has no custom VJP; the differentiable "
                "fused form is the procedure megakernel — use "
                "fusion='auto' or 'procedure' with differentiable=True")
        if plan.axes or plan.pipeline is not None:
            raise ValueError(
                "differentiable cuda routing is shard-local: the "
                "stage-split sharded/pipelined forms have no custom VJP "
                "(the Table-2 collectives would need their own transpose "
                "rules); train with backend='torch' under sharded/pipelined "
                "plans, or use plan=None/'auto' (auto resolves unsharded "
                "when differentiable)")
    bad = [d for d, _ in plan.axes if d not in algo.sharded_dims]
    if bad:
        raise ValueError(
            f"algorithm {algo.name!r} cannot shard dims {bad} "
            f"(shardable: {algo.sharded_dims})")
    if plan.pipeline is not None:
        if any(a == plan.pipeline_axis for _, a in plan.axes):
            raise ValueError(
                f"mesh axis {plan.pipeline_axis!r} is the pipeline's stage "
                "axis; shard the routing stage over a different axis (or "
                "rename pipeline_axis)")
        if plan.pipeline == "two_stage":
            mesh = plan.mesh
            if (mesh is None or plan.pipeline_axis
                    not in mesh_utils.axis_names(mesh)):
                raise ValueError("pipeline='two_stage' needs a mesh "
                                 f"containing axis {plan.pipeline_axis!r}")


def build_router(spec: RouterSpec = RouterSpec(), plan=None, *,
                 device="cuda") -> Router:
    """One entry point: algorithm x backend x plan -> callable.

    spec: RouterSpec (default: exact dynamic routing on the torch backend).
    plan: None (unsharded) | "auto" (§5.1.2 planner over the default mesh)
          | ExecutionPlan (explicit mesh/axes/pipeline/auto).
    device: where the router runs — the card by default (raises when no
          CUDA device is present); pass "cpu" for the plain versions.

    Returns a ``Router``: call it like the algorithm (``router(u_hat)``,
    ``router(votes, a_in)`` for EM); with a pipeline plan it consumes
    stacked microbatches, a pytree whose leaves are (n_micro, ...).
    """
    return Router(spec, _normalize_plan(plan), device=device)


def as_router(spec=None, plan=None, *, device="cuda",
              default_iterations: int = 3):
    """Coerce the (spec, plan) surface of runtime entry points to a Router:
    None (default RouterSpec at ``default_iterations``), a RouterSpec, or an
    already-built Router/callable (then ``plan`` must be None)."""
    if spec is None:
        spec = RouterSpec(iterations=default_iterations)
    if callable(spec) and not isinstance(spec, RouterSpec):
        if plan is not None:
            raise ValueError("pass plan only with a RouterSpec; a prebuilt "
                             "Router already carries its ExecutionPlan")
        return spec
    return build_router(spec, plan, device=device)
