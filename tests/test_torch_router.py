"""PyTorch port, the Router (``repro_torch.core.router``): the reference's
error surface (the deep-edge and fusion cases of ``tests/test_router.py``),
the plans that were once left to the distribution slice and now run (or
name the slice that still leaves them out), plan resolution against the
reference's, and the cuda backend (its plain versions on the CPU) against
the reference's pallas backend."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro_torch.core import router as trouter
from repro_torch.core.router import (Algorithm, ExecutionPlan, RouterSpec,
                                     as_router, build_router,
                                     reference_spec, register_algorithm,
                                     registered_algorithms)
from repro_torch.runtime import mesh_utils

CPU = "cpu"


def _mesh_x():
    """A 1-rank gloo mesh with one axis, "x" (in-process, no network)."""
    return mesh_utils.make_mesh((1,), ("x",), device=CPU)


def _votes(shape=(2, 64, 6, 8), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_registry_has_dynamic_and_defers_the_rest():
    assert registered_algorithms() == ("dynamic", "em", "moe")
    for backend in ("torch", "cuda"):
        em = build_router(RouterSpec(algorithm="em", backend=backend),
                          device=CPU)
        assert em.algorithm.num_inputs == 2
    # "moe" runs on one device and expert-parallel under an "E" plan (the
    # parity tests are tests/test_torch_moe_train.py), differentiable too
    # (sharded training, slice 8)
    assert build_router(RouterSpec(algorithm="moe"),
                        device=CPU).algorithm.num_inputs == 5
    e_plan = ExecutionPlan(mesh=_mesh_x(), axes=(("E", "x"),))
    assert build_router(RouterSpec(algorithm="moe"), e_plan,
                        device=CPU).algorithm.sharded_dims == ("E",)
    diff = build_router(RouterSpec(algorithm="moe", differentiable=True),
                        e_plan, device=CPU)
    assert diff.spec.differentiable and diff.plan.axes == (("E", "x"),)


def test_unknown_algorithm_and_backend_raise():
    with pytest.raises(KeyError, match="unknown routing algorithm"):
        build_router(RouterSpec(algorithm="quantum"), device=CPU)
    for backend in ("pallas", "jnp", "triton"):
        with pytest.raises(ValueError, match="unknown backend"):
            build_router(RouterSpec(backend=backend), device=CPU)
    register_algorithm(Algorithm(name="_torch_only",
                                 run=lambda args, spec, axes: args[0]))
    try:
        with pytest.raises(ValueError, match="no 'cuda' backend"):
            build_router(RouterSpec(algorithm="_torch_only", backend="cuda"),
                         device=CPU)
        with pytest.raises(ValueError, match="already registered"):
            register_algorithm(Algorithm(name="_torch_only",
                                         run=lambda a, s, x: a[0]))
    finally:
        del trouter._REGISTRY["_torch_only"]


def test_fusion_and_stream_dtype_error_surface():
    with pytest.raises(ValueError, match="unknown fusion"):
        build_router(RouterSpec(backend="cuda", fusion="mega"), device=CPU)
    with pytest.raises(ValueError, match="unknown stream_dtype"):
        build_router(RouterSpec(backend="cuda", stream_dtype="fp16"),
                     device=CPU)
    with pytest.raises(ValueError, match="cuda-backend knob"):
        build_router(RouterSpec(fusion="procedure"), device=CPU)
    with pytest.raises(ValueError, match="requires the 'dynamic'"):
        build_router(RouterSpec(stream_dtype="bf16"), device=CPU)
    mesh_plan = ExecutionPlan(mesh=_mesh_x(), axes=(("L", "x"),))
    with pytest.raises(ValueError, match="shard-local"):
        build_router(RouterSpec(backend="cuda", fusion="procedure"),
                     mesh_plan, device=CPU)


def test_deep_edge_error_surface():
    cuda = RouterSpec(algorithm="dynamic", backend="cuda")
    with pytest.raises(ValueError, match="must be a float >= 0"):
        build_router(cuda._replace(early_exit_eps=-1.0), device=CPU)
    with pytest.raises(ValueError, match="must be a float >= 0"):
        build_router(cuda._replace(early_exit_eps=True), device=CPU)
    with pytest.raises(ValueError, match="must be a float >= 0"):
        build_router(cuda._replace(early_exit_eps=float("nan")), device=CPU)
    with pytest.raises(ValueError, match="cuda-backend knob"):
        build_router(RouterSpec(early_exit_eps=0.1), device=CPU)
    with pytest.raises(ValueError, match="procedure megakernel"):
        build_router(cuda._replace(fusion="iteration", early_exit_eps=0.1),
                     device=CPU)
    with pytest.raises(ValueError, match="procedure megakernel"):
        build_router(cuda._replace(fusion="iteration", stream_dtype="int8"),
                     device=CPU)
    sharded = ExecutionPlan(mesh=_mesh_x(), axes=(("L", "x"),))
    for spec in (cuda._replace(early_exit_eps=0.1),
                 cuda._replace(stream_dtype="int8")):
        with pytest.raises(ValueError, match="shard-local"):
            build_router(spec, sharded, device=CPU)


def _em_args():
    rng = np.random.default_rng(5)
    votes = rng.standard_normal((4, 32, 5, 8)).astype(np.float32)
    a_in = (1.0 / (1.0 + np.exp(-rng.standard_normal((4, 32))))).astype(
        np.float32)
    return votes, a_in


@pytest.mark.parametrize("spec,plan,where", [
    # the planner's auto plans and explicit mesh axes now run (torch and
    # cuda backends, the cuda one through the stage-split kernels)
    pytest.param(RouterSpec(), lambda: "auto", "runs",
                 id="spec0-auto-slice 5"),
    pytest.param(RouterSpec(backend="cuda"), lambda: "auto", "runs",
                 id="spec1-auto-slice 5"),
    pytest.param(RouterSpec(),
                 lambda: ExecutionPlan(mesh=_mesh_x(), axes=(("B", "x"),)),
                 "runs", id="spec2-plan2-slice 5"),
    # two_stage needs a mesh with a pipe axis, as in the reference
    pytest.param(RouterSpec(), lambda: ExecutionPlan(pipeline="two_stage"),
                 (ValueError, "needs a mesh containing axis 'pipe'"),
                 id="spec3-plan3-slice 5"),
    # a differentiable torch spec under the planner's sharded pick runs,
    # autograd crossing the collectives (sharded training, slice 8)
    pytest.param(RouterSpec(differentiable=True), lambda: "auto", "runs",
                 id="spec4-auto-slice 5"),
    # a mesh with no sharded axis keeps a differentiable cuda spec
    # shard-local, on the procedure kernel's backward
    pytest.param(RouterSpec(backend="cuda", differentiable=True),
                 lambda: ExecutionPlan(mesh=_mesh_x()), "runs",
                 id="spec5-plan5-slice 5"),
    # EM's auto plan picks B or L
    pytest.param(RouterSpec(algorithm="em", backend="cuda"), lambda: "auto",
                 "runs", id="spec6-auto-slice 5"),
])
def test_later_slices_raise_not_implemented(spec, plan, where):
    """Every plan that was refused as the distribution slice: it runs and
    matches the reference's unsharded result (the reference's sharded gate,
    rtol 2e-4 / atol 2e-5), or raises what the reference raises, or names
    the slice that still leaves it out."""
    plan = plan()
    if where != "runs":
        with pytest.raises(where[0], match=where[1]):
            build_router(spec, plan, device=CPU)
        return
    router = build_router(spec, plan, device=CPU)
    if spec.algorithm == "em":
        votes, a_in = _em_args()
        want = jrouter.build_router(jrouter.RouterSpec(algorithm="em"))(
            jnp.asarray(votes), jnp.asarray(a_in))
        got = router(torch.from_numpy(votes), torch.from_numpy(a_in))
        resolved = router.resolve(torch.from_numpy(votes),
                                  torch.from_numpy(a_in))
        assert len(resolved) == 1 and resolved[0][0] in ("B", "L")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                       atol=2e-5)
        return
    u = _votes()
    want = jrouter.build_router(jrouter.RouterSpec())(jnp.asarray(u))
    with torch.no_grad():
        got = router(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    resolved = router.resolve(torch.from_numpy(u))
    if spec.differentiable and spec.backend == "cuda":
        assert tuple(resolved) == () and resolved.differentiable
    elif spec.differentiable:   # sharded, with the unsharded gradient
        assert len(resolved) == 1
        w = _votes(want.shape, seed=9)
        jg = jax.grad(lambda x: jnp.sum(jrouter.build_router(
            jrouter.RouterSpec())(x) * w))(jnp.asarray(u))
        ut = torch.tensor(u, requires_grad=True)
        (g,) = torch.autograd.grad((router(ut) * torch.from_numpy(w)).sum(),
                                   ut)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)
    else:
        assert len(resolved) == 1
        assert resolved.fusion == ("stage_split" if spec.backend == "cuda"
                                   else None)


def test_plan_value_errors():
    with pytest.raises(ValueError, match="unknown pipeline kind"):
        ExecutionPlan(pipeline="three_stage")
    with pytest.raises(ValueError, match="not both"):
        ExecutionPlan(axes=(("B", "x"),), auto=True)
    with pytest.raises(ValueError, match="duplicate logical dims"):
        ExecutionPlan(axes=(("B", "x"), ("B", "y")))
    with pytest.raises(ValueError, match="duplicate mesh axes"):
        ExecutionPlan(axes=(("B", "x"), ("L", "x")))
    with pytest.raises(ValueError, match="unknown plan"):
        build_router(RouterSpec(), "fastest", device=CPU)
    with pytest.raises(TypeError, match="plan must be"):
        build_router(RouterSpec(), 3, device=CPU)
    with pytest.raises(ValueError, match="cannot shard dims"):
        build_router(RouterSpec(), ExecutionPlan(mesh=_mesh_x(),
                                                 axes=(("C", "x"),)),
                     device=CPU)
    with pytest.raises(ValueError, match="needs a mesh"):
        ExecutionPlan(axes=(("C", "x"),))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_router(RouterSpec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        as_router(RouterSpec(backend="cuda"))


@pytest.mark.parametrize("fusion,stream_dtype,eps", [
    ("auto", "fp32", None), ("procedure", "fp32", None),
    ("iteration", "fp32", None), ("procedure", "bf16", None),
    ("auto", "int8", 1e-3), ("auto", "fp32", 0.0)])
def test_cuda_backend_matches_reference_pallas(fusion, stream_dtype, eps):
    u = _votes(seed=1)
    kw = dict(iterations=3, fusion=fusion, stream_dtype=stream_dtype,
              early_exit_eps=eps)
    jr = jrouter.build_router(jrouter.RouterSpec(backend="pallas", **kw))
    tr = build_router(RouterSpec(backend="cuda", **kw), device=CPU)
    want = np.asarray(jr(jnp.asarray(u)))
    got = tr(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jres, tres = jr.resolve(jnp.asarray(u)), tr.resolve(torch.from_numpy(u))
    assert (tres.fusion, tres.stream_dtype, tres.early_exit_eps) == \
        (jres.fusion, jres.stream_dtype, jres.early_exit_eps)
    assert tuple(tres) == tuple(jres) == ()


def test_torch_backend_matches_reference_jnp():
    u = _votes(seed=2)
    want = np.asarray(jrouter.build_router(
        jrouter.RouterSpec(iterations=3, use_approx=True))(jnp.asarray(u)))
    got = build_router(RouterSpec(iterations=3, use_approx=True),
                       device=CPU)(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resolve_reports_kernel_form():
    u = torch.from_numpy(_votes())
    auto = build_router(RouterSpec(backend="cuda"), device=CPU)
    assert auto.resolve().fusion is None     # "auto" needs the votes shape
    assert auto.resolve(u).fusion == "procedure"
    forced = build_router(RouterSpec(backend="cuda", fusion="iteration"),
                          device=CPU)
    assert forced.resolve().fusion == "iteration"
    deep = build_router(RouterSpec(backend="cuda", stream_dtype="int8",
                                   early_exit_eps=1e-3), device=CPU)
    for r in (deep.resolve(), deep.resolve(u)):
        assert (r.fusion, r.stream_dtype, r.early_exit_eps,
                r.differentiable) == ("procedure", "int8", 1e-3, False)
    assert "early_exit_eps=0.001" in repr(deep.resolve())
    plain = build_router(RouterSpec(), device=CPU).resolve(u)
    assert plain.fusion is None and plain.stream_dtype is None


def test_reference_spec_resets_kernel_knobs():
    spec = RouterSpec(backend="cuda", iterations=5, use_approx=True,
                      fusion="procedure", stream_dtype="int8",
                      early_exit_eps=0.5)
    ref = reference_spec(spec)
    assert ref == RouterSpec(iterations=5)
    want = jrouter.reference_spec(jrouter.RouterSpec(
        backend="pallas", iterations=5, use_approx=True, fusion="procedure",
        stream_dtype="int8", early_exit_eps=0.5))
    assert ref._replace(backend="jnp") == tuple(want)


def test_software_pipeline_plan_matches_per_microbatch():
    rng = np.random.default_rng(3)
    micro = {"x": torch.from_numpy(rng.standard_normal(
        (3, 2, 32, 4, 8)).astype(np.float32)),
        "mask": torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])}

    def stage_a(m):
        return m["x"] * m["mask"][:, None, None, None]

    for backend in ("torch", "cuda"):
        spec = RouterSpec(backend=backend, iterations=2)
        piped = build_router(spec, ExecutionPlan(pipeline="software",
                                                 stage_a=stage_a),
                             device=CPU)
        core = build_router(spec, device=CPU)
        got = piped(micro)
        want = torch.stack([core(stage_a({k: v[t] for k, v in
                                          micro.items()}))
                            for t in range(3)])
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert piped.resolve(micro).fusion == \
            (None if backend == "torch" else "procedure")


def test_call_arity_and_as_router():
    r = build_router(RouterSpec(), device=CPU)
    u = torch.from_numpy(_votes())
    with pytest.raises(TypeError, match="takes 1 input"):
        r(u, u)
    assert as_router(r) is r
    with pytest.raises(ValueError, match="pass plan only"):
        as_router(r, ExecutionPlan())
    built = as_router(None, device=CPU, default_iterations=2)
    assert built.spec.iterations == 2 and built.device.type == "cpu"
    assert "backend='torch'" in repr(built)
