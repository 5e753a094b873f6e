"""PyTorch port, sharded routing (the distribution slice) against the JAX
reference on the same numpy inputs:

* the §5.1.2 planner (``core.distribution``) against the reference's with
  the reference's own device coefficients, a hypothesis sweep, and the
  port's nominal H100 model;
* ``plan_axes`` against the reference's, on a 1-rank mesh and on a
  shape-only 4-shard stand-in;
* the sharded-vs-unsharded cases of ``tests/test_router.py:169-330`` and
  ``:537-553`` on a 1-rank gloo mesh in this process (``dist.HashStore``,
  no network), for the torch and cuda backends (the cuda backend's plain
  versions on the CPU), at the reference's gates;
* the reference's sharded error surface, the shard helper's divisibility
  error and the refusal of autograd through the collectives;
* four gloo ranks on the CPU in a subprocess (``FileStore`` in tmp_path):
  {B}, {L}, {H} dynamic routing, {B} and {L} EM, ``auto``, a B×L 2-D mesh,
  ``two_stage_pipeline`` on a (2, 2) mesh (``tests/test_sharded.py:199``)
  and a CapsNet serving wave over a two-stage mesh
  (``tests/test_serving.py:365``), each against the reference's output at
  the reference's tolerances.
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # vendored fallback (tests/_hypothesis_compat.py)
    from _hypothesis_compat import given, settings, strategies as st

from repro import compat
from repro.configs.caps_benchmarks import CAPS_BENCHMARKS, CapsConfig
from repro.core import distribution as JD
from repro.core import em_routing as jem
from repro.core import router as jrouter
from repro.core import routing as jrouting
from repro.data.synthetic import SyntheticCapsDataset
from repro.models import capsnet as jcapsnet
from repro.runtime import caps_serve as jserve
from repro_torch.core import distribution as TD
from repro_torch.core import em_routing as tem
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import routing as trouting
from repro_torch.core.router import (ExecutionPlan, RouterSpec, build_router,
                                     plan_axes)
from repro_torch.runtime import mesh_utils

CPU = "cpu"
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHARDED_GATE = dict(rtol=2e-4, atol=2e-5)     # tests/test_sharded.py:47-48
EM_GATE = dict(rtol=1e-4, atol=1e-5)          # tests/test_router.py:342-345


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _em_np(seed=7, shape=(4, 32, 5, 8)):
    votes = _np(shape, seed)
    a_in = (1.0 / (1.0 + np.exp(-_np(shape[:2], seed + 1)))).astype(
        np.float32)
    return votes, a_in


@pytest.fixture(scope="module")
def mesh1():
    return mesh_utils.make_mesh((1,), ("x",), device=CPU)


@pytest.fixture(scope="module")
def mesh11():
    return mesh_utils.make_mesh((1, 1), ("data", "model"), device=CPU)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the §5.1.2 planner
# ---------------------------------------------------------------------------

def _shape_pairs():
    out = []
    for c in CAPS_BENCHMARKS.values():
        js = JD.RPShape.from_caps_config(c)
        out.append((js, TD.RPShape(js.n_b, js.n_l, js.n_h, js.c_l, js.c_h,
                                   js.iters)))
    return out


def _models(n):
    """The reference's device models and the port's copies of their
    coefficients."""
    out = []
    for jm in (JD.DeviceModel.tpu_v5e(n), JD.DeviceModel.hmc(n)):
        out.append((jm, TD.DeviceModel(alpha=jm.alpha, beta=jm.beta,
                                       n_vault=n)))
    return out


@pytest.mark.parametrize("n", [1, 4, 32])
def test_planner_matches_reference_with_its_coefficients(n):
    for js, ts in _shape_pairs():
        for jm, tm in _models(n):
            assert TD.score_table(ts, tm) == JD.score_table(js, jm)
            assert TD.plan(ts, tm) == JD.plan(js, jm)
            for d in JD.DIMS:
                assert TD.workload_E(d, ts, n) == JD.workload_E(d, js, n)
                assert TD.comm_M(d, ts, n) == JD.comm_M(d, js, n)
                assert TD.estimated_time_s(d, ts, tm) == \
                    JD.estimated_time_s(d, js, jm)


def test_plan_multi_rmas_and_moe_match_reference():
    js, ts = _shape_pairs()[0]
    jm, tm = _models(16)[0]
    cands = {"B": {"B": 16}, "L": {"L": 16}, "BxL": {"B": 4, "L": 4},
             "LxH": {"L": 8, "H": 2}}
    assert TD.plan_multi(ts, tm, cands) == JD.plan_multi(js, jm, cands)
    for axes in cands.values():
        assert TD.workload_E_multi(axes, ts) == JD.workload_E_multi(axes, js)
        assert TD.comm_M_ring(axes, ts) == JD.comm_M_ring(axes, js)
    for args in ((12, 3.5, 1.0, 2.0), (8, 1e9, 1.0, 1.0), (8, 1e-9, 1, 1)):
        assert TD.rmas_optimal_grant(*args) == JD.rmas_optimal_grant(*args)
        assert TD.rmas_overhead(3, *args) == JD.rmas_overhead(3, *args)
    shape = dict(tokens=4096, d_model=2048, d_ff=768, n_experts=128,
                 top_k=8)
    assert TD.moe_plan(TD.MoEShape(**shape), tm) == \
        JD.moe_plan(JD.MoEShape(**shape), jm)


@settings(max_examples=50, deadline=None)
@given(nb=st.integers(1, 512), nl=st.integers(32, 8192),
       nh=st.integers(2, 128), i=st.integers(1, 9),
       nv=st.sampled_from([1, 2, 4, 16]))
def test_property_scores_match_reference(nb, nl, nh, i, nv):
    js = JD.RPShape(n_b=nb, n_l=nl, n_h=nh, c_l=8, c_h=16, iters=i)
    ts = TD.RPShape(n_b=nb, n_l=nl, n_h=nh, c_l=8, c_h=16, iters=i)
    for jm, tm in _models(nv):
        for d in JD.DIMS:
            sc = TD.execution_score(d, ts, tm)
            assert sc > 0 and math.isfinite(sc)
            assert sc == JD.execution_score(d, js, jm)
    tm = TD.DeviceModel.h100(nv)
    for d in TD.DIMS:
        assert TD.execution_score(d, ts, tm) > 0


def test_h100_model_and_its_pick_at_caps_mn1():
    """The nominal H100 model (67 TFLOP/s fp32, 450 GB/s each way over
    NVLink) picks H at Caps-MN1 on one vault where the reference's TPU
    model picks L: a different device, not a different planner."""
    dev = TD.DeviceModel.h100(1)
    assert dev.alpha == 1.0 / 67e12 and dev.beta == 1.0 / 450e9
    assert not hasattr(TD.DeviceModel, "tpu_v5e")
    s = TD.RPShape(n_b=100, n_l=1152, n_h=10, c_l=16, c_h=16, iters=3)
    table = TD.score_table(s, dev)
    assert {d: round(v, -2) for d, v in table.items()} == \
        {"B": 84900.0, "L": 85300.0, "H": 96800.0}
    assert TD.plan(s, dev) == "H"
    js = JD.RPShape(n_b=100, n_l=1152, n_h=10, c_l=16, c_h=16, iters=3)
    assert JD.plan(js, JD.DeviceModel.tpu_v5e(1)) == "L"


class _JFake:
    axis_names = ("vault",)
    shape = {"vault": 4}


class _TFake:
    """A shape-only 4-shard mesh: plan_axes reads only its axis names and
    sizes."""
    mesh_dim_names = ("vault",)

    def size(self, i):
        return 4


@pytest.mark.parametrize("algorithm", ["dynamic", "em"])
@pytest.mark.parametrize("shape", [(8, 6, 10, 16), (6, 6, 10, 16),
                                   (4, 32, 8, 16), (100, 1152, 10, 16),
                                   (8, 64, 6, 8)])
def test_plan_axes_matches_reference(mesh1, algorithm, shape):
    jspec = jrouter.RouterSpec(algorithm=algorithm)
    tspec = RouterSpec(algorithm=algorithm)
    for n, jmesh, tmesh, axis in (
            (4, _JFake(), _TFake(), "vault"),
            (1, compat.make_mesh((1,), ("x",)), mesh1, "x")):
        jm = JD.DeviceModel.tpu_v5e(n)
        tm = TD.DeviceModel(alpha=jm.alpha, beta=jm.beta, n_vault=n)
        want = jrouter.plan_axes(jspec, jrouter.ExecutionPlan(
            mesh=jmesh, auto=True, device=jm), (shape,))
        got = plan_axes(tspec, ExecutionPlan(mesh=tmesh, auto=True,
                                             device=tm), (shape,),
                        device=CPU)
        assert got == want
        if got:
            assert got[0][1] == axis


# ---------------------------------------------------------------------------
# sharded == unsharded on a 1-rank mesh (tests/test_router.py:169-330)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def u_np():
    return _np((4, 32, 8, 16), seed=0)


def _jwant(u, **kw):
    return jrouter.build_router(jrouter.RouterSpec(iterations=3, **kw))(
        jnp.asarray(u))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("dim", ["B", "L", "H"])
def test_sharded_equals_unsharded_1rank(mesh1, u_np, dim, backend):
    want = _jwant(u_np)
    router = build_router(RouterSpec(backend=backend, iterations=3),
                          ExecutionPlan(mesh=mesh1, axes=((dim, "x"),)),
                          device=CPU)
    got = router(torch.from_numpy(u_np))
    _close(got, want, rtol=1e-5, atol=1e-5)
    r = router.resolve(torch.from_numpy(u_np))
    assert tuple(r) == ((dim, "x"),)
    assert r.fusion == ("stage_split" if backend == "cuda" else None)


@pytest.mark.parametrize("use_approx", [False, True])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_multi_dim_sharded_1rank(mesh11, u_np, backend, use_approx):
    """The 2-D (B x L) plan, the reference's torus case."""
    want = _jwant(u_np, use_approx=use_approx)
    got = build_router(
        RouterSpec(backend=backend, iterations=3, use_approx=use_approx),
        ExecutionPlan(mesh=mesh11, axes=(("B", "data"), ("L", "model"))),
        device=CPU)(torch.from_numpy(u_np))
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("dim", ["B", "L"])
def test_em_sharded_equals_unsharded_1rank(mesh1, dim, backend):
    votes, a_in = _em_np()
    pose_ref, act_ref = jem.em_routing(jnp.asarray(votes), jnp.asarray(a_in))
    router = build_router(RouterSpec(algorithm="em", backend=backend),
                          ExecutionPlan(mesh=mesh1, axes=((dim, "x"),)),
                          device=CPU)
    pose, act = router(torch.from_numpy(votes), torch.from_numpy(a_in))
    _close(pose, pose_ref, **EM_GATE)
    _close(act, act_ref, **EM_GATE)
    with pytest.raises(ValueError, match="cannot shard dims"):
        build_router(RouterSpec(algorithm="em", backend=backend),
                     ExecutionPlan(mesh=mesh1, axes=(("H", "x"),)),
                     device=CPU)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_auto_plan_picks_a_sharded_dim_1rank(u_np, backend):
    """plan="auto" over the default mesh (one rank here) shards the
    planner's pick and matches the unsharded result; the cuda backend
    resolves to the stage-split form."""
    router = build_router(RouterSpec(backend=backend, iterations=3), "auto",
                          device=CPU)
    u = torch.from_numpy(u_np)
    r = router.resolve(u)
    pick = TD.plan(TD.RPShape(4, 32, 8, 16, 16, 3), TD.DeviceModel.h100(1))
    assert tuple(r) == ((pick, "vault"),)             # the H100 model
    assert r.fusion == ("stage_split" if backend == "cuda" else None)
    _close(router(u), _jwant(u_np), rtol=1e-5, atol=1e-5)
    # the reference's coefficients give the reference's pick
    jm = JD.DeviceModel.tpu_v5e(1)
    plan = ExecutionPlan(auto=True, device=TD.DeviceModel(
        alpha=jm.alpha, beta=jm.beta, n_vault=1))
    jr = jrouter.build_router(
        jrouter.RouterSpec(backend="pallas" if backend == "cuda" else "jnp"),
        jrouter.ExecutionPlan(auto=True, device=jm)).resolve(jnp.asarray(u_np))
    tr = build_router(RouterSpec(backend=backend), plan, device=CPU).resolve(u)
    assert [d for d, _ in tr] == [d for d, _ in jr]
    assert tr.fusion == jr.fusion


def test_software_pipeline_composes_with_sharded_plans(mesh1, mesh11):
    micro = _np((4, 2, 8, 4, 8), seed=3)
    want = jnp.stack([_jwant(m) for m in micro])
    for backend in ("torch", "cuda"):
        for plan in (ExecutionPlan(mesh=mesh1, axes=(("B", "x"),),
                                   pipeline="software"),
                     ExecutionPlan(mesh=mesh1, auto=True, pipeline="software"),
                     ExecutionPlan(mesh=mesh11, axes=(("B", "data"),
                                                      ("L", "model")),
                                   pipeline="software")):
            got = build_router(RouterSpec(backend=backend), plan,
                               device=CPU)(torch.from_numpy(micro))
            _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_em_pipelined_sharded_matches_unpipelined(mesh1, backend):
    micro = _np((3, 2, 8, 4, 6), seed=4)
    core = jrouter.build_router(jrouter.RouterSpec(algorithm="em",
                                                   iterations=2))

    def jstage(x):
        return jnp.tanh(x), jax.nn.sigmoid(x[..., 0, 0])

    refs = [core(*jstage(jnp.asarray(m))) for m in micro]

    def tstage(x):
        return torch.tanh(x), torch.sigmoid(x[..., 0, 0])

    plan = ExecutionPlan(mesh=mesh1, pipeline="software", stage_a=tstage,
                         axes=(("L", "x"),))
    pose, act = build_router(RouterSpec(algorithm="em", backend=backend,
                                        iterations=2), plan,
                             device=CPU)(torch.from_numpy(micro))
    assert float(np.max(np.abs(pose.numpy() - np.stack(
        [np.asarray(r[0]) for r in refs])))) <= 1e-5
    assert float(np.max(np.abs(act.numpy() - np.stack(
        [np.asarray(r[1]) for r in refs])))) <= 1e-5


def test_resolve_reports_stage_split_and_torch_none(mesh1, u_np):
    u = torch.from_numpy(u_np)
    sharded = build_router(RouterSpec(backend="cuda"),
                           ExecutionPlan(mesh=mesh1, axes=(("L", "x"),)),
                           device=CPU)
    for r in (sharded.resolve(u), sharded.resolve()):
        assert tuple(r) == (("L", "x"),)
        assert (r.fusion, r.stream_dtype, r.early_exit_eps) == \
            ("stage_split", "fp32", None)
    tr = build_router(RouterSpec(), "auto", device=CPU).resolve(u)
    assert tr.fusion is None and tr.stream_dtype is None and len(tr) == 1
    bf = build_router(RouterSpec(backend="cuda", stream_dtype="bf16"),
                      ExecutionPlan(mesh=mesh1, axes=(("B", "x"),)),
                      device=CPU)
    assert bf.resolve(u).stream_dtype == "bf16"
    _close(bf(u), _jwant(u_np), rtol=5e-2, atol=1e-2)


def test_legacy_shims_delegate_to_router(mesh1, u_np):
    """make_sharded_routing / make_multi_sharded_routing /
    make_sharded_em_routing (tests/test_router.py:537-586), and the
    RoutingConfig / EMRoutingConfig sharded forms under an active mesh."""
    u = torch.from_numpy(u_np)
    want = _jwant(u_np)
    for fused in (False, True):
        cfg = trouting.RoutingConfig(iterations=3, fused=fused)
        for fn in (trouting.make_sharded_routing(mesh1, "L", "x", cfg,
                                                 device=CPU),
                   trouting.make_multi_sharded_routing(
                       mesh1, (("B", "x"),), cfg, device=CPU)):
            _close(fn(u), want, rtol=1e-5, atol=1e-5)
        with mesh_utils.active(mesh1):
            for sh in (dict(sharded_dim="H", axis_name="x"),
                       dict(axes=(("B", "x"),))):
                got = trouting.dynamic_routing(
                    u, trouting.RoutingConfig(iterations=3, fused=fused,
                                              **sh))
                _close(got, want, rtol=1e-5, atol=1e-5)
    votes, a_in = _em_np()
    pose_ref, act_ref = jem.em_routing(jnp.asarray(votes), jnp.asarray(a_in))
    tv, ta = torch.from_numpy(votes), torch.from_numpy(a_in)
    for backend in ("torch", "cuda"):
        pose, act = tem.make_sharded_em_routing(mesh1, "L", "x",
                                                backend=backend,
                                                device=CPU)(tv, ta)
        _close(pose, pose_ref, **EM_GATE)
    with mesh_utils.active(mesh1):
        pose, act = tem.em_routing(tv, ta, tem.EMRoutingConfig(
            sharded_dim="L", axis_name="x"))
    _close(pose, pose_ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="outside a sharded call"):
        trouting.dynamic_routing(u, trouting.RoutingConfig(
            sharded_dim="L", axis_name="x"))


# ---------------------------------------------------------------------------
# the sharded error surface
# ---------------------------------------------------------------------------

def test_sharded_error_surface(mesh1):
    """The reference's refusals (tests/test_router.py:459-519): the
    procedure kernel, int8 and early exit are shard-local; EM cannot shard
    H; differentiable cuda routing is shard-local; the pipe axis cannot
    host a sharded dim; two_stage needs a pipe axis; axes need a mesh that
    has them."""
    sharded = ExecutionPlan(mesh=mesh1, axes=(("L", "x"),))
    cuda = RouterSpec(backend="cuda")
    for spec, match in ((cuda._replace(fusion="procedure"), "shard-local"),
                        (cuda._replace(stream_dtype="int8"), "shard-local"),
                        (cuda._replace(early_exit_eps=0.1), "shard-local"),
                        (cuda._replace(differentiable=True), "shard-local")):
        with pytest.raises(ValueError, match=match):
            build_router(spec, sharded, device=CPU)
    with pytest.raises(ValueError, match="shard-local"):
        build_router(cuda._replace(differentiable=True),
                     ExecutionPlan(pipeline="software"), device=CPU)
    with pytest.raises(ValueError, match="cannot shard dims"):
        build_router(RouterSpec(algorithm="em"),
                     ExecutionPlan(mesh=mesh1, axes=(("H", "x"),)),
                     device=CPU)
    with pytest.raises(ValueError, match="stage axis"):
        build_router(RouterSpec(), ExecutionPlan(
            mesh=mesh1, axes=(("B", "x"),), pipeline="software",
            pipeline_axis="x"), device=CPU)
    with pytest.raises(ValueError, match="needs a mesh containing axis"):
        build_router(RouterSpec(), ExecutionPlan(pipeline="two_stage"),
                     device=CPU)
    with pytest.raises(ValueError, match="needs a mesh containing axis"):
        build_router(RouterSpec(), ExecutionPlan(
            mesh=mesh1, pipeline="two_stage"), device=CPU)
    with pytest.raises(ValueError, match="needs a mesh"):
        ExecutionPlan(axes=(("B", "x"),))
    with pytest.raises(ValueError, match="not in mesh axes"):
        ExecutionPlan(mesh=mesh1, axes=(("B", "vault"),))
    with pytest.raises(ValueError, match="\\|pipe\\| == 2"):
        tpipeline.two_stage_pipeline(lambda x: x, lambda h: h, mesh_utils.
                                     make_mesh((1, 1), ("pipe", "v"),
                                               device=CPU), "pipe",
                                     tpipeline.TensorSpec((2,),
                                                          torch.float32))
    # int8 / early-exit auto plans resolve shard-local, as in the reference
    for spec in (cuda._replace(stream_dtype="int8"),
                 cuda._replace(early_exit_eps=0.0)):
        assert tuple(build_router(spec, "auto", device=CPU).resolve(
            torch.zeros(2, 96, 6, 8))) == ()


def test_sharded_training_is_a_later_slice(mesh1):
    """Sharded training (slice 8): a differentiable torch spec under a
    sharded plan builds, and autograd crosses the collectives — the
    gradient of each sharded plan's output equals the reference's
    ``jax.grad`` of its unsharded routing (several ranks:
    tests/test_torch_sharded_train.py)."""
    u_np = _np((2, 16, 4, 8), 1)
    w = _np((2, 4, 8), 2)
    want = jax.grad(lambda u: jnp.sum(jrouter.build_router(
        jrouter.RouterSpec())(u) * w))(jnp.asarray(u_np))
    for plan in ("auto", ExecutionPlan(mesh=mesh1, axes=(("B", "x"),)),
                 ExecutionPlan(mesh=mesh1, axes=(("L", "x"),)),
                 ExecutionPlan(mesh=mesh1, axes=(("H", "x"),))):
        router = build_router(RouterSpec(differentiable=True), plan,
                              device=CPU)
        u = torch.from_numpy(u_np).requires_grad_(True)
        (g,) = torch.autograd.grad((router(u) * torch.from_numpy(w)).sum(),
                                   u)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    # a collective on a tensor that requires grad passes its gradient
    x = torch.ones(3, requires_grad=True)
    with mesh_utils.active(mesh1):
        (g,) = torch.autograd.grad((mesh_utils.psum(x, "x") * 2).sum(), x)
    assert torch.equal(g, torch.full((3,), 2.0))


def test_shard_helper_divisibility_and_mesh_errors(mesh1):
    x = torch.zeros(6, 4)

    class Four(_TFake):
        def get_local_rank(self, axis):
            return 1

    with pytest.raises(ValueError, match="input dimension 0 \\(extent 6\\) "
                                         "is not divisible by \\|vault\\|=4"):
        mesh_utils.shard_block(x, mesh_utils.P("vault"), Four())
    blk = mesh_utils.shard_block(torch.arange(8.0).reshape(2, 4),
                                 mesh_utils.P(None, "vault"), Four())
    assert blk.tolist() == [[1.0], [5.0]]
    with pytest.raises(ValueError, match="differ in length"):
        mesh_utils.make_mesh((1, 1), ("x",), device=CPU)
    with pytest.raises(ValueError, match="holds 2 ranks"):
        mesh_utils.make_mesh((2,), ("x",), device=CPU)
    with pytest.raises(RuntimeError, match="outside a sharded call"):
        mesh_utils.psum(x, "x")
    assert mesh_utils.psum(x, None) is x
    with mesh_utils.active(mesh1):
        with pytest.raises(ValueError, match="not in mesh axes"):
            mesh_utils.psum(x, "vault")
        y = torch.arange(4.0)
        assert torch.equal(mesh_utils.psum(y, "x"), y)
        assert torch.equal(mesh_utils.pmax(y, "x"), y)
        assert torch.equal(mesh_utils.all_gather(y, "x", 0), y)
        assert torch.equal(mesh_utils.broadcast(y, "x", 0), y)
    assert mesh_utils.dp_axes(mesh1) == ("x",) and mesh_utils.dp_size(
        mesh1) == 1
    assert mesh_utils.default_mesh(CPU) is mesh_utils.default_mesh(CPU)
    assert mesh_utils.axis_names(mesh_utils.default_mesh(CPU)) == ("vault",)


# ---------------------------------------------------------------------------
# four gloo ranks on the CPU (FileStore, no network)
# ---------------------------------------------------------------------------

_RANKS = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, d):
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), 4), rank=rank, world_size=4)
    from repro_torch import convert
    from repro_torch.configs.caps_benchmarks import CapsConfig
    from repro_torch.core import pipeline
    from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
    from repro_torch.runtime import mesh_utils
    from repro_torch.runtime.caps_serve import (CapsServer, ServeConfig,
                                                make_wave_fn)
    inp = np.load(os.path.join(d, "inputs.npz"))
    out = {}
    u = torch.from_numpy(inp["u"])
    votes, a_in = torch.from_numpy(inp["votes"]), torch.from_numpy(inp["a_in"])
    mesh = mesh_utils.make_mesh((4,), ("x",), device="cpu")
    for be in ("torch", "cuda"):
        for dim in "BLH":
            out[f"dyn_{be}_{dim}"] = build_router(
                RouterSpec(backend=be), ExecutionPlan(
                    mesh=mesh, axes=((dim, "x"),)), device="cpu")(u)
        for dim in "BL":
            pose, act = build_router(
                RouterSpec(algorithm="em", backend=be), ExecutionPlan(
                    mesh=mesh, axes=((dim, "x"),)), device="cpu")(votes, a_in)
            out[f"em_{be}_{dim}_pose"], out[f"em_{be}_{dim}_act"] = pose, act
        auto = build_router(RouterSpec(backend=be), "auto", device="cpu")
        out[f"auto_{be}"] = auto(u)
        out[f"auto_{be}_axes"] = torch.tensor(
            [ord(d) for d, _ in auto.resolve(u)])
    mesh22 = mesh_utils.make_mesh((2, 2), ("data", "model"), device="cpu")
    out["torus"] = build_router(RouterSpec(backend="cuda"), ExecutionPlan(
        mesh=mesh22, axes=(("B", "data"), ("L", "model"))),
        device="cpu")(u)
    pipe = mesh_utils.make_mesh((2, 2), ("pipe", "x"), device="cpu")
    runner = pipeline.two_stage_pipeline(
        lambda x: x * 2.0 + 1.0, lambda h: h ** 2, pipe, "pipe",
        pipeline.TensorSpec((4,), torch.float32))
    out["pipeline"] = runner(torch.arange(24, dtype=torch.float32).reshape(
        6, 4))
    cfg = CapsConfig(**json.loads(str(inp["cfg"])))
    params = {k: inp[k] for k in inp.files if k.startswith("p/")}
    net = convert.capsnet_from_jax({k[2:]: v for k, v in params.items()},
                                   cfg, device="cpu")
    micro = {"images": torch.from_numpy(inp["images"]),
             "mask": torch.ones(inp["images"].shape[:2])}
    n_micro, mb = inp["images"].shape[:2]
    spec = RouterSpec(backend="cuda", iterations=cfg.routing_iters)
    for name, rp in (("none", None), ("auto", "auto"),
                     ("B", (("B", "x"),)), ("L", (("L", "x"),))):
        sc = ServeConfig(microbatch=mb, n_micro=n_micro,
                         pipeline="two_stage", mesh=pipe, routing_plan=rp)
        out[f"wave_{name}"] = make_wave_fn(net, spec, sc)(micro)
    server = CapsServer(net, spec, ServeConfig(
        microbatch=mb, n_micro=n_micro, pipeline="two_stage", mesh=pipe,
        routing_plan="auto"), device="cpu")
    server.submit(list(inp["extra"]))
    out["served"] = torch.tensor(len(server.drain()) + 100 * server.pending())
    np.savez(os.path.join(d, f"rank{rank}.npz"),
             **{k: v.numpy() for k, v in out.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(sys.argv[1],), nprocs=4)
'''


def test_four_gloo_ranks_match_reference(tmp_path):
    rng = np.random.default_rng(11)
    u = rng.standard_normal((8, 64, 8, 16)).astype(np.float32)
    votes = rng.standard_normal((8, 64, 4, 8)).astype(np.float32)
    a_in = (1.0 / (1.0 + np.exp(-rng.standard_normal((8, 64))))).astype(
        np.float32)
    cfg = CapsConfig("t", "synthetic", 8, 72, 8, 2, caps_channels=2,
                     conv_channels=16)
    params = jcapsnet.init_capsnet(jax.random.PRNGKey(0), cfg)
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                flat[f"p/{prefix}{k}"] = np.asarray(v)

    walk("", params)
    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    n_micro, mb = 2, 8
    images = ds.batch(0, n_micro * mb)["images"].reshape(
        (n_micro, mb, cfg.image_hw, cfg.image_hw, cfg.image_channels))
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    np.savez(tmp_path / "inputs.npz", u=u, votes=votes, a_in=a_in,
             images=images, extra=ds.batch(1, 11)["images"],
             cfg=json.dumps(fields), **flat)
    script = tmp_path / "ranks.py"
    script.write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for r in ranks[1:]:                      # every rank returns the same
        for k, v in r.items():
            np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)
    got = ranks[0]

    want = np.asarray(jrouting.dynamic_routing(
        jnp.asarray(u), jrouting.RoutingConfig(iterations=3)))
    for be in ("torch", "cuda"):
        for dim in "BLH":
            _close(got[f"dyn_{be}_{dim}"], want, **SHARDED_GATE)
        _close(got[f"auto_{be}"], want, **SHARDED_GATE)
        # the H100 model on 4 vaults picks among B, L and H by divisibility
        assert len(got[f"auto_{be}_axes"]) == 1
    _close(got["torus"], want, **SHARDED_GATE)
    pose_ref, act_ref = jem.em_routing(jnp.asarray(votes), jnp.asarray(a_in))
    for be in ("torch", "cuda"):
        for dim in "BL":
            _close(got[f"em_{be}_{dim}_pose"], pose_ref, **SHARDED_GATE)
            _close(got[f"em_{be}_{dim}_act"], act_ref, **SHARDED_GATE)
    micro = np.arange(24, dtype=np.float32).reshape(6, 4)
    _close(got["pipeline"], (micro * 2.0 + 1.0) ** 2, rtol=1e-6, atol=0)
    plain = jserve.make_wave_fn(
        params, cfg, None, jserve.ServeConfig(
            microbatch=mb, n_micro=n_micro, pipeline=None))(
        {"images": jnp.asarray(images), "mask": jnp.ones((n_micro, mb))})
    for name in ("none", "auto", "B", "L"):
        assert float(np.max(np.abs(got[f"wave_{name}"]
                                   - np.asarray(plain)))) <= 1e-5, name
    assert int(got["served"]) == 11
