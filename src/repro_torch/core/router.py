"""Unified Router API — one entry point for algorithm x backend x plan.

Port of the JAX package's ``repro/core/router.py`` for this slice:

    spec = RouterSpec(algorithm="dynamic", backend="cuda", iterations=3)
    router = build_router(spec, device="cuda")
    v = router(u_hat)                       # u_hat (B, L, H, C) -> v (B, H, C)

* RouterSpec — WHAT to route: an algorithm from the registry ("dynamic",
  paper Algorithm 1, or "em", matrix-capsule EM routing over (votes, a_in))
  and a backend: "torch" (the eager PyTorch path, the counterpart of the
  reference's "jnp" and the default) or "cuda" (the hand-written Hopper
  kernels, the counterpart of "pallas").  ``fusion``
  picks the whole-procedure kernel or the per-iteration kernel,
  ``stream_dtype`` the û stream (fp32 | bf16 | int8), ``early_exit_eps``
  per-tile early exit, ``differentiable`` training through the procedure
  kernel's recompute-b backward.
* ExecutionPlan — WHERE/HOW: unsharded, or the single-device
  ``pipeline="software"`` skewed loop over stacked microbatches.
* build_router(spec, plan, device) — the façade.  ``device`` defaults to
  the card and raises when there is none; the router checks that its
  inputs live there.

What the port leaves to later slices raises ``NotImplementedError`` naming
the slice that ports it: ``plan="auto"`` (except with
``differentiable=True`` on the cuda backend, where it resolves shard-local
as in the reference), explicit ``axes`` and ``pipeline="two_stage"``
(slice 5, distribution) and ``algorithm="moe"`` (slice 6, LM/MoE stack).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch import slices
from repro_torch.core import em_routing as em_lib
from repro_torch.core import pipeline as pipeline_lib
from repro_torch.core import routing as routing_lib
from repro_torch.kernels import resolve_device

BACKENDS = ("torch", "cuda")

# registered in the reference, ported by a later slice of the port
_LATER_ALGORITHMS = {"moe": slices.LM_STACK}


# ---------------------------------------------------------------------------
# RouterSpec — algorithm x backend (+ static algorithm options)
# ---------------------------------------------------------------------------

class RouterSpec(NamedTuple):
    """Static routing specification (hashable).

    algorithm: registry name ("dynamic" or "em").
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
               (EM's beta_a, beta_u, inv_temp and eps).
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

    run(args, spec, axes): the computation (``axes`` is empty in this
        slice: every plan is shard-local).
    sharded_dims: logical dims the algorithm can shard ("B"/"L"/"H").
    backends: supported backends.
    """
    name: str
    run: Callable[[tuple, RouterSpec, Mapping[str, str]], Any]
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
        if name in _LATER_ALGORITHMS:
            raise slices.not_ported(f"routing algorithm {name!r}",
                                    _LATER_ALGORITHMS[name]) from None
        raise KeyError(
            f"unknown routing algorithm {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def registered_algorithms() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


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
    run=_dynamic_run,
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
    run=_em_run,
    # H-sharding would split the per-H Gaussian statistics
    sharded_dims=("B", "L"),
    backends=("torch", "cuda"),
    num_inputs=2,
    describe="EM routing: votes (B,L,H,C) + a_in (B,L) -> (pose, a_out)",
))


# ---------------------------------------------------------------------------
# ExecutionPlan — distribution + pipelining
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Where and how the routing procedure executes.

      ExecutionPlan()                                   unsharded
      ExecutionPlan(pipeline="software", stage_a=f)     skewed-loop overlap

    The reference's other plans keep their fields so that asking for them
    fails loudly: ``axes``/``mesh`` (sharded routing), ``auto`` (except
    for a differentiable cuda spec, which resolves shard-local) and
    ``pipeline="two_stage"`` raise ``NotImplementedError`` at
    ``build_router`` (slice 5).  With a pipeline plan the router consumes
    stacked microbatches — a pytree whose leaves are (n_micro, ...) —
    and ``stage_a`` (e.g. conv + votes) feeds the routing stage.
    """
    mesh: Any = None
    axes: Tuple[Tuple[str, str], ...] = ()
    auto: bool = False
    pipeline: Optional[str] = None
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


# ---------------------------------------------------------------------------
# build_router
# ---------------------------------------------------------------------------

class ResolvedPlan(tuple):
    """``Router.resolve()`` result: the tuple of concrete (dim, mesh_axis)
    pairs (always empty in this slice) plus the resolved kernel execution:

    fusion:       "procedure" | "iteration" for dynamic routing on the cuda
                  backend, "stage_split" for EM on it; None for
                  the torch backend (and for the differentiable fallback).
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

    def resolve(self, *args) -> ResolvedPlan:
        """Concrete execution for these inputs.  With a pipeline plan the
        votes shape is that of stage_a's output, so stage_a runs once on
        the first microbatch."""
        shapes = ()
        if args:
            if self.plan.pipeline is not None:
                stage_a = self.plan.stage_a or (lambda x: x)
                hidden = stage_a(pipeline_lib.microbatch_at(args[0], 0))
                shapes = tuple(tuple(l.shape)
                               for l in pipeline_lib.tree_leaves(hidden))
            else:
                shapes = tuple(tuple(a.shape) for a in args)
        return ResolvedPlan((), *self._resolve_fusion(shapes))

    def _resolve_fusion(self, shapes):
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
        if not shapes and self.spec.fusion == "auto" and not deep_edge:
            return None, self.spec.stream_dtype, False, None
        from repro_torch.kernels.routing import ops as routing_ops
        form = routing_ops.resolve_fusion(self.spec.fusion,
                                          shapes[0] if shapes else None,
                                          self.spec.stream_dtype,
                                          early_exit=early_exit)
        if self.spec.differentiable:
            # mirrors _dynamic_run: the backward kernel exists for the
            # procedure form only; anything else is the torch fallback
            if form == "procedure":
                return "procedure", self.spec.stream_dtype, True, None
            return None, None, False, None
        return form, self.spec.stream_dtype, False, self.spec.early_exit_eps

    def _check_device(self, args) -> None:
        for leaf in pipeline_lib.tree_leaves(args):
            if isinstance(leaf, torch.Tensor) and leaf.device != self.device:
                raise ValueError(f"router input is on {leaf.device}; this "
                                 f"router runs on {self.device}")

    def __call__(self, *args):
        self._check_device(args)
        algo, spec = self.algorithm, self.spec
        if self.plan.pipeline is not None:
            if len(args) != 1:
                raise TypeError("a pipelined router takes one pytree of "
                                f"stacked microbatches; got {len(args)}")
            stage_a = self.plan.stage_a or (lambda x: x)

            def stage_b(h):
                # stage A hands a 1-input algorithm its votes and a
                # multi-input one a tuple in argument order (EM's
                # (votes, a_in))
                return algo.run((h,) if algo.num_inputs == 1 else tuple(h),
                                spec, {})
            return pipeline_lib.software_pipeline_scan(stage_a, stage_b,
                                                       args[0])
        if len(args) != algo.num_inputs:
            raise TypeError(
                f"{spec.algorithm!r} router takes {algo.num_inputs} "
                f"input(s) ({algo.describe or 'see registry entry'}); "
                f"got {len(args)}")
        return algo.run(args, spec, {})

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
    """The reference's error surface (``router.py:786``) for what this
    slice runs, and ``NotImplementedError`` for what later slices port."""
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
                "(the Table-2 psums would need their own transpose rules); "
                "train with backend='torch' under sharded/pipelined plans, "
                "or use plan=None/'auto' (auto resolves unsharded when "
                "differentiable)")
    bad = [d for d, _ in plan.axes if d not in algo.sharded_dims]
    if bad:
        raise ValueError(
            f"algorithm {algo.name!r} cannot shard dims {bad} "
            f"(shardable: {algo.sharded_dims})")
    if plan.auto and not (spec.differentiable and spec.backend == "cuda"):
        # a differentiable cuda spec resolves shard-local (the planner's
        # sharded pick would force the stage-split form, which has no
        # custom VJP); every other auto plan is the planner's
        raise slices.not_ported("plan='auto' (the §5.1.2 planner picking a "
                                "sharded dimension)", slices.DISTRIBUTION)
    if plan.axes or plan.mesh is not None:
        raise slices.not_ported("sharded routing over mesh axes",
                                slices.DISTRIBUTION)
    if plan.pipeline == "two_stage":
        raise slices.not_ported("pipeline='two_stage' (stages on disjoint "
                                "device groups)", slices.DISTRIBUTION)


def build_router(spec: RouterSpec = RouterSpec(), plan=None, *,
                 device="cuda") -> Router:
    """One entry point: algorithm x backend x plan -> callable.

    spec: RouterSpec (default: exact dynamic routing on the torch backend).
    plan: None (unsharded) | ExecutionPlan(pipeline="software", ...) |
          "auto" with a differentiable cuda spec (resolves unsharded);
          other "auto" and sharded plans raise (slice 5).
    device: where the router runs — the card by default (raises when no
          CUDA device is present); pass "cpu" for the plain versions.
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
