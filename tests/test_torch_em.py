"""PyTorch port, EM routing against the JAX reference on the same numpy
inputs:

* ``core.em_routing.em_routing`` against ``repro.core.em_routing`` —
  ≤ 1e-5 at (4, 32, 5, 8) for 1–3 iterations;
* the plain versions of ``em_stage_stats`` / ``em_stage_estep`` against the
  Pallas kernels in interpret mode at several ``l_tile`` and H = 5, 11 —
  ≤ 1e-5 · max(1, max|want|) on each output; the wrappers' error surface;
* ``ops.em_routing_fused`` (CPU: the plain versions) against the reference's
  (interpret) — ≤ 1e-5 — and against the port's torch path (rtol 1e-4,
  atol 1e-5: the σ² of the streamed statistics cancels where the torch
  path's direct (v−μ)² does not);
* the "em" router: registry, the two-input call, ``resolve()``, the error
  surface, pipelined tuples and stacked pytree outputs;
* EM serving waves: pipelined == unpipelined, padding invariance, the wave
  scores ≤ 1e-5 of the JAX server's on JAX-initialised weights, and the
  serving CLI with ``--algorithm em``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import caps_benchmarks as jconfigs
from repro.core import em_routing as jem
from repro.core import router as jrouter
from repro.data.synthetic import SyntheticCapsDataset
from repro.kernels.routing import kernel as jkernel
from repro.kernels.routing import ops as jops
from repro.models import capsnet as jcapsnet
from repro.runtime import caps_serve as jserve
from repro_torch import convert
from repro_torch.configs import caps_benchmarks as tconfigs
from repro_torch.core import em_routing as tem
from repro_torch.core import pipeline as tpipeline
from repro_torch.core.router import (ExecutionPlan, RouterSpec, build_router,
                                     registered_algorithms)
from repro_torch.kernels.routing import kernel as tkernel
from repro_torch.kernels.routing import ops as tops
from repro_torch.launch import serve_caps as tcli
from repro_torch.runtime import caps_serve as tserve
from repro_torch.runtime import mesh_utils

TOL = 1e-5
CPU = "cpu"
SHAPE = (4, 32, 5, 8)          # B, L, H, C


def _inputs(shape=SHAPE, seed=0):
    """Votes at the encoder's scale and a sigmoid a_in, as numpy."""
    rng = np.random.default_rng(seed)
    B, L = shape[:2]
    votes = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    a_in = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, L))))).astype(
        np.float32)
    return votes, a_in


def _scaled_close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# core.em_routing — the eager oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_em_routing_matches_reference(iterations):
    votes, a_in = _inputs()
    jmu, ja = jem.em_routing(jnp.asarray(votes), jnp.asarray(a_in),
                             jem.EMRoutingConfig(iterations=iterations))
    tmu, ta = tem.em_routing(torch.from_numpy(votes), torch.from_numpy(a_in),
                             tem.EMRoutingConfig(iterations=iterations))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=TOL)


def test_sharded_em_is_the_distribution_slice():
    """The sharded forms that the distribution slice ported: the M-step's
    L-psums of ``em_routing`` and ``em_routing_fused`` under an active
    1-rank mesh, and the ``make_sharded_em_routing`` shim, all equal to the
    reference's unsharded EM."""
    votes, a_in = _inputs()
    jmu, ja = jem.em_routing(jnp.asarray(votes), jnp.asarray(a_in))
    tv, ta = torch.from_numpy(votes), torch.from_numpy(a_in)
    mesh = mesh_utils.make_mesh((1,), ("x",), device=CPU)
    with mesh_utils.active(mesh):
        mu, act = tem.em_routing(tv, ta, tem.EMRoutingConfig(sharded_dim="L",
                                                             axis_name="x"))
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0,
                                   atol=TOL)
        mu, act = tops.em_routing_fused(tv, ta, axes={"L": "x"})
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4,
                                   atol=TOL)
    mu, act = tem.make_sharded_em_routing(mesh, "B", "x", device=CPU)(tv, ta)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0, atol=TOL)
    np.testing.assert_allclose(act.numpy(), np.asarray(ja), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# the stage kernels' plain versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

def _stage_inputs(H: int, seed: int):
    rng = np.random.default_rng(seed)
    votes, a_in = _inputs((3, 64, H, 8), seed)
    r = rng.random((3, 64, H)).astype(np.float32)
    r /= r.sum(-1, keepdims=True)
    mu = (rng.standard_normal((3, H, 8)) * 0.1).astype(np.float32)
    inv_sigma2 = (1.0 / (rng.random((3, H, 8)) + 0.05)).astype(np.float32)
    bias = (rng.standard_normal((3, H)) * 4.0).astype(np.float32)
    return votes, a_in, r, mu, inv_sigma2, bias


@pytest.mark.parametrize("H", [5, 11])
@pytest.mark.parametrize("l_tile", [8, 16, 64])
def test_em_stage_stats_plain_matches_pallas(l_tile, H):
    votes, a_in, r, *_ = _stage_inputs(H, seed=l_tile + H)
    want = jkernel.em_stage_stats(jnp.asarray(votes), jnp.asarray(r),
                                  jnp.asarray(a_in), l_tile=l_tile)
    got = tkernel.em_stage_stats(torch.from_numpy(votes),
                                 torch.from_numpy(r),
                                 torch.from_numpy(a_in), l_tile=l_tile)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        _scaled_close(g, w)


@pytest.mark.parametrize("H", [5, 11])
@pytest.mark.parametrize("l_tile", [8, 16, 64])
def test_em_stage_estep_plain_matches_pallas(l_tile, H):
    votes, _, _, mu, inv_sigma2, bias = _stage_inputs(H, seed=2 * l_tile + H)
    want = jkernel.em_stage_estep(*map(jnp.asarray, (votes, mu, inv_sigma2,
                                                     bias)), l_tile=l_tile)
    got = tkernel.em_stage_estep(*map(torch.from_numpy, (votes, mu,
                                                         inv_sigma2, bias)),
                                 l_tile=l_tile)
    assert tuple(got.shape) == (3, 64, H)
    _scaled_close(got, want)
    torch.testing.assert_close(got.sum(-1), torch.ones((3, 64)), rtol=0,
                               atol=1e-6)


def _tree(x: np.ndarray, op) -> np.ndarray:
    """The E-step kernel's reduction of a row's H lanes (x: (rows, H)):
    shuffles down by P2/2, …, 1 within the row's lanes, a lane taking its
    partner only where the partner is in the row; where H > 32 a lane's
    own h (lane, lane + 32, …) in order, then a 32-lane xor butterfly."""
    n, H = x.shape
    if H <= 32:
        p2 = 1 << (H - 1).bit_length()
        off = p2 // 2
        while off:
            x = x.copy()
            x[:, :H - off] = op(x[:, :H - off], x[:, off:H])
            off //= 2
        return x[:, 0]
    nh = -(-H // 32)
    ident = -np.inf if op is np.maximum else 0.0
    lanes = np.full((n, 32), ident, np.float32)
    for j in range(nh):
        h = np.arange(32) + 32 * j
        ok = h < H
        lanes[:, ok] = op(lanes[:, ok], x[:, h[ok]]) if j else x[:, h[ok]]
    for o in (16, 8, 4, 2, 1):
        lanes = op(lanes, lanes[:, np.arange(32) ^ o])
    return lanes[:, 0]


def _estep_by_lanes(votes, mu, inv_sigma2, bias) -> np.ndarray:
    """The E-step as ``csrc/em_routing.cu`` computes it, in numpy fp32: the
    rows split over the warps of ``ops.estep_geometry``, Σ_c in c order with
    each product and sum rounded, the row max and the exp sum by the
    kernel's tree (``_tree``), IEEE division.  Rows no warp takes stay
    NaN; a row two warps take is counted."""
    B, L, H, C = votes.shape
    geo = tops.estep_geometry(B, L, H, C)
    v = votes.reshape(B * L, H, C)
    out = np.full((B * L, H), np.nan, np.float32)
    taken = np.zeros(B * L, np.int64)
    for w in range(geo.warps):
        span = geo.warp_rows(w, B * L)
        rows = np.arange(span.start, span.stop)
        if not len(rows):
            continue
        taken[rows] += 1
        b = rows // L
        d = v[rows] - mu[b]
        t = d * d * inv_sigma2[b]
        s = np.zeros((len(rows), H), np.float32)
        for c in range(C):
            s = s + t[..., c]
        lg = bias[b] - np.float32(0.5) * s
        m = _tree(lg, np.maximum)
        e = np.exp(lg - m[:, None]).astype(np.float32)
        out[rows] = e / _tree(e, np.add)[:, None]
    assert (taken == 1).all()
    return out.reshape(B, L, H)


@pytest.mark.parametrize("B,L,H,C", [(3, 64, 5, 8), (2, 45, 7, 5),
                                     (4, 40, 10, 16), (3, 31, 11, 16),
                                     (2, 13, 32, 4), (2, 9, 62, 16)])
def test_estep_lane_decomposition_matches_plain(B, L, H, C):
    """The kernel's decomposition — even row shares a warp, a lane a (row,
    h), the fixed shuffle trees over H — against the plain version within
    1e-5·max(1, max|plain|), rows summing to 1."""
    rng = np.random.default_rng(B * L + H)
    votes = (rng.standard_normal((B, L, H, C)) * 0.5).astype(np.float32)
    mu = (rng.standard_normal((B, H, C)) * 0.1).astype(np.float32)
    inv_sigma2 = (1.0 / (rng.random((B, H, C)) + 0.05)).astype(np.float32)
    bias = (rng.standard_normal((B, H)) * 4.0).astype(np.float32)
    got = _estep_by_lanes(votes, mu, inv_sigma2, bias)
    want = tkernel.em_stage_estep_plain(
        *map(torch.from_numpy, (votes, mu, inv_sigma2, bias)), l_tile=L)
    _scaled_close(torch.from_numpy(got), want.numpy())
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)


def test_em_stage_estep_plain_matches_pallas_above_256():
    """H = 300 capsules, past the 8 a lane of the narrow E-step kernel: the
    plain version against the reference's Pallas kernel in interpret
    mode."""
    votes, _, _, mu, inv_sigma2, bias = _stage_inputs(300, seed=300)
    want = jkernel.em_stage_estep(*map(jnp.asarray, (votes, mu, inv_sigma2,
                                                     bias)), l_tile=64)
    got = tkernel.em_stage_estep(*map(torch.from_numpy, (votes, mu,
                                                         inv_sigma2, bias)),
                                 l_tile=64)
    assert tuple(got.shape) == (3, 64, 300)
    _scaled_close(got, want)


def _estep_wide_by_lanes(votes, mu, inv_sigma2, bias) -> np.ndarray:
    """The wide E-step (H > 256) as ``csrc/em_routing.cu`` computes it, in
    numpy fp32: a row walked in h-passes of 256, lane l holding h = 256·p
    + 32·j + l; each pass folds its max into the running M and its exp sum
    (a lane's 8 in j order, then the 32-lane xor butterfly) into the
    running S, rescaled by exp(M_old − M_new); then r = exp(lg − M)/S."""
    B, L, H, C = votes.shape
    geo = tops.estep_geometry(B, L, H, C)
    assert geo.h_passes > 1 and geo.rows_per_pass == 1
    v = votes.reshape(B * L, H, C)
    b = np.arange(B * L) // L
    d = v - mu[b]
    t = d * d * inv_sigma2[b]
    s = np.zeros((B * L, H), np.float32)
    for c in range(C):
        s = s + t[..., c]
    lg = bias[b] - np.float32(0.5) * s
    M = np.full(B * L, -np.inf, np.float32)
    S = np.zeros(B * L, np.float32)
    for p in range(geo.h_passes):
        lanes_max = np.full((B * L, 32), -np.inf, np.float32)
        for j in range(geo.h_per_lane):
            h = 256 * p + 32 * j + np.arange(32)
            ok = h < H
            lanes_max[:, ok] = np.maximum(lanes_max[:, ok], lg[:, h[ok]])
        M1 = np.maximum(M, lanes_max.max(axis=1))
        lanes = np.zeros((B * L, 32), np.float32)
        for j in range(geo.h_per_lane):
            h = 256 * p + 32 * j + np.arange(32)
            ok = h < H
            lanes[:, ok] = lanes[:, ok] + np.exp(lg[:, h[ok]] - M1[:, None])
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ o]
        S = (S * np.exp(M - M1)).astype(np.float32) + lanes[:, 0]
        M = M1
    out = np.exp(lg - M[:, None]).astype(np.float32) / S[:, None]
    return out.reshape(B, L, H)


@pytest.mark.parametrize("B,L,H,C", [(2, 5, 257, 5), (2, 4, 300, 16),
                                     (1, 3, 513, 8)])
def test_estep_wide_decomposition_matches_plain(B, L, H, C):
    """The wide kernel's online softmax over h-passes against the plain
    version within 1e-5·max(1, max|plain|), rows summing to 1; the bias
    puts the row's max in a later pass, so the running sum is rescaled."""
    rng = np.random.default_rng(B * L + H)
    votes = (rng.standard_normal((B, L, H, C)) * 0.5).astype(np.float32)
    mu = (rng.standard_normal((B, H, C)) * 0.1).astype(np.float32)
    inv_sigma2 = (1.0 / (rng.random((B, H, C)) + 0.05)).astype(np.float32)
    bias = (rng.standard_normal((B, H)) * 4.0).astype(np.float32)
    bias[:, -1] += 30.0
    got = _estep_wide_by_lanes(votes, mu, inv_sigma2, bias)
    want = tkernel.em_stage_estep_plain(
        *map(torch.from_numpy, (votes, mu, inv_sigma2, bias)), l_tile=L)
    _scaled_close(torch.from_numpy(got), want.numpy())
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)


def test_em_stage_wrappers_error_surface():
    votes, a_in, r, mu, inv_sigma2, bias = (
        torch.from_numpy(x) for x in _stage_inputs(5, seed=0))
    for fn, args in ((tkernel.em_stage_stats, (votes, r, a_in)),
                     (tkernel.em_stage_estep, (votes, mu, inv_sigma2,
                                               bias))):
        with pytest.raises(ValueError, match="not divisible by l_tile=48"):
            fn(*args, l_tile=48)
        for i in range(len(args)):
            grad_args = list(args)
            grad_args[i] = args[i].clone().requires_grad_()
            with pytest.raises(ValueError, match="no autograd formula"):
                fn(*grad_args, l_tile=16)
            with torch.no_grad():
                fn(*grad_args, l_tile=16)
    # the reference raises the same error for the same shapes
    with pytest.raises(ValueError, match="not divisible by l_tile=48"):
        jkernel.em_stage_stats(jnp.asarray(votes.numpy()),
                               jnp.asarray(r.numpy()),
                               jnp.asarray(a_in.numpy()), l_tile=48)


@pytest.mark.parametrize("B,L", [(100, 1152), (100, 4608), (8, 1152),
                                 (3, 64), (300, 576), (1, 7)])
def test_em_stats_chunks_cover_L_once(B, L):
    """The kernel's grid: every L row in exactly one chunk, no empty chunk,
    and about 8 blocks per SM where L allows it."""
    rows, chunks = tkernel.em_stats_chunks(B, L)
    assert rows >= 1 and (chunks - 1) * rows < L <= chunks * rows
    assert B * chunks >= 0.9 * min(B * L, tkernel._EM_TARGET_BLOCKS)


# ---------------------------------------------------------------------------
# ops.em_routing_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iterations,broadcast_a", [(1, False), (3, False),
                                                    (3, True)])
def test_em_routing_fused_matches_reference(iterations, broadcast_a):
    votes, a_in = _inputs(seed=iterations)
    if broadcast_a:            # the serving hand-off: a lane mask over L
        a_in = np.broadcast_to(np.array([1.0, 1.0, 0.0, 1.0], np.float32
                                        )[:, None], a_in.shape).copy()
    ta = torch.from_numpy(a_in)
    if broadcast_a:
        ta = ta[:, :1].expand(a_in.shape)
        assert ta.stride(1) == 0
    kw = dict(iterations=iterations, beta_a=0.5, beta_u=0.8, inv_temp=2.0)
    jmu, jact = jops.em_routing_fused(jnp.asarray(votes), jnp.asarray(a_in),
                                      axes={}, **kw)
    tmu, tact = tops.em_routing_fused(torch.from_numpy(votes), ta, axes={},
                                      **kw)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tact.numpy(), np.asarray(jact), rtol=0,
                               atol=TOL)
    emu, eact = tem.em_routing(torch.from_numpy(votes), ta,
                               tem.EMRoutingConfig(**kw))
    torch.testing.assert_close(tmu, emu, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(tact, eact, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the "em" router
# ---------------------------------------------------------------------------

def test_registry_and_resolve():
    assert registered_algorithms() == ("dynamic", "em", "moe")
    votes, a_in = (torch.from_numpy(x) for x in _inputs())
    cuda = build_router(RouterSpec(algorithm="em", backend="cuda"),
                        device=CPU)
    jres = jrouter.build_router(jrouter.RouterSpec(
        algorithm="em", backend="pallas")).resolve(
            *map(jnp.asarray, _inputs()))
    for res in (cuda.resolve(), cuda.resolve(votes, a_in)):
        assert (res.fusion, res.stream_dtype, res.differentiable,
                res.early_exit_eps) == ("stage_split", "fp32", False, None)
        assert (res.fusion, res.stream_dtype) == (jres.fusion,
                                                  jres.stream_dtype)
    eager = build_router(RouterSpec(algorithm="em"), device=CPU).resolve()
    assert eager.fusion is None and eager.stream_dtype is None
    with pytest.raises(TypeError, match="takes 2 input"):
        cuda(votes)


@pytest.mark.parametrize("backend,jbackend", [("torch", "jnp"),
                                              ("cuda", "pallas")])
def test_two_input_router_matches_reference(backend, jbackend):
    votes, a_in = _inputs(seed=5)
    opts = dict(beta_a=0.5, beta_u=0.9, inv_temp=1.5, eps=1e-8)
    jr = jrouter.build_router(jrouter.RouterSpec(
        algorithm="em", backend=jbackend, iterations=3).with_options(**opts))
    tr = build_router(RouterSpec(algorithm="em", backend=backend,
                                 iterations=3).with_options(**opts),
                      device=CPU)
    assert tr.spec.option("inv_temp") == 1.5
    assert tr.spec.option("missing", 7) == 7
    jmu, ja = jr(jnp.asarray(votes), jnp.asarray(a_in))
    tmu, ta = tr(torch.from_numpy(votes), torch.from_numpy(a_in))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=TOL)


def test_em_error_surface():
    em = RouterSpec(algorithm="em", backend="cuda")
    with pytest.raises(ValueError, match="EM and the torch backend"):
        build_router(em._replace(fusion="procedure"), device=CPU)
    with pytest.raises(ValueError, match="the EM kernels stream fp32"):
        build_router(em._replace(stream_dtype="bf16"), device=CPU)
    with pytest.raises(ValueError, match="knob of the 'dynamic'"):
        build_router(em._replace(early_exit_eps=0.1), device=CPU)
    with pytest.raises(ValueError, match="requires the 'dynamic' algorithm"):
        build_router(em._replace(differentiable=True), device=CPU)
    mesh = mesh_utils.make_mesh((1,), ("x",), device=CPU)
    with pytest.raises(ValueError, match="cannot shard dims"):
        build_router(em, ExecutionPlan(mesh=mesh, axes=(("H", "x"),)),
                     device=CPU)
    # the B- and L-sharded plans and auto run (the stage kernels with the
    # M-step's L-psums), each resolving to the stage-split form
    for plan in (ExecutionPlan(mesh=mesh, axes=(("L", "x"),)),
                 ExecutionPlan(mesh=mesh, axes=(("B", "x"),)), "auto"):
        resolved = build_router(em, plan, device=CPU).resolve(
            torch.zeros(2, 8, 5, 4), torch.ones(2, 8))
        assert len(resolved) == 1 and resolved[0][0] in ("B", "L")
        assert resolved.fusion == "stage_split"
    # the torch backend is differentiable by construction
    build_router(RouterSpec(algorithm="em", differentiable=True), device=CPU)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_pipelined_router_hands_em_a_tuple(backend):
    rng = np.random.default_rng(6)
    micro = {"x": torch.from_numpy((rng.standard_normal((3, 2, 32, 5, 8))
                                    * 0.5).astype(np.float32)),
             "mask": torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])}

    def stage_a(m):
        votes = m["x"] * m["mask"][:, None, None, None]
        return votes, m["mask"][:, None].expand(votes.shape[:2])

    spec = RouterSpec(algorithm="em", backend=backend, iterations=2)
    piped = build_router(spec, ExecutionPlan(pipeline="software",
                                             stage_a=stage_a), device=CPU)
    core = build_router(spec, device=CPU)
    pose, act = piped(micro)
    assert tuple(pose.shape) == (3, 2, 5, 8) and tuple(act.shape) == (3, 2, 5)
    for t in range(3):
        want_pose, want_act = core(*stage_a({k: v[t]
                                             for k, v in micro.items()}))
        torch.testing.assert_close(pose[t], want_pose, rtol=0, atol=0)
        torch.testing.assert_close(act[t], want_act, rtol=0, atol=0)
    assert piped.resolve(micro).fusion == (None if backend == "torch"
                                           else "stage_split")


def test_software_pipeline_stacks_pytree_outputs():
    micro = torch.arange(6.0).reshape(3, 2)
    out = tpipeline.software_pipeline_scan(
        lambda x: x * 2.0,
        lambda h: {"sum": h.sum(), "pair": (h, h + 1.0)}, micro)
    torch.testing.assert_close(out["sum"], torch.tensor([2.0, 10.0, 18.0]))
    torch.testing.assert_close(out["pair"][0], micro * 2.0)
    torch.testing.assert_close(out["pair"][1], micro * 2.0 + 1.0)


# ---------------------------------------------------------------------------
# EM serving waves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.smoke_caps()
    params = jcapsnet.init_capsnet(jax.random.PRNGKey(0), cfg)
    # non-zero conv biases: a zero-image pad lane has non-zero votes, so
    # padding invariance genuinely depends on the lane mask
    params["primary"]["conv1"]["b"] = params["primary"]["conv1"]["b"] + 0.1
    params["primary"]["caps_conv"]["b"] = (
        params["primary"]["caps_conv"]["b"] + 0.05)
    tcfg = tconfigs.smoke_caps()
    net = convert.capsnet_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                   device=CPU)
    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    return cfg, params, net, ds


def _micro(cfg, images, mask, n_micro, microbatch):
    return {"images": torch.from_numpy(np.asarray(images, np.float32)
                                       .reshape(n_micro, microbatch,
                                                cfg.image_hw, cfg.image_hw,
                                                cfg.image_channels)),
            "mask": torch.from_numpy(np.asarray(mask, np.float32)
                                     .reshape(n_micro, microbatch))}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_em_wave_pipelined_matches_unpipelined(setup, backend):
    """The reference's test of the same name against the port: pipelined
    == unpipelined ≤ 1e-5, and the server completes over it."""
    cfg, params, net, ds = setup
    spec = RouterSpec(algorithm="em", backend=backend, iterations=2)
    n_micro, microbatch = 2, 4
    images = ds.batch(3, n_micro * microbatch)["images"]
    mask = np.ones((n_micro * microbatch,), np.float32)
    mask[-1] = 0.0
    micro = _micro(cfg, images, mask, n_micro, microbatch)
    scores = {}
    for arm, pipeline in (("piped", "software"), ("plain", None)):
        wave = tserve.make_wave_fn(net, spec, tserve.ServeConfig(
            microbatch=microbatch, n_micro=n_micro, pipeline=pipeline))
        scores[arm] = wave(micro)
    assert tuple(scores["piped"].shape) == (n_micro, microbatch,
                                            cfg.num_h_caps)
    assert float((scores["piped"] - scores["plain"]).abs().max()) <= TOL

    server = tserve.CapsServer(net, spec, tserve.ServeConfig(
        microbatch=microbatch, n_micro=n_micro, pipeline="software"),
        device=CPU)
    server.submit(ds.batch(4, 6)["images"])
    assert len(server.drain()) == 6


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_em_padding_invariance(setup, backend):
    """Padded lanes never change real EM outputs: against an unpadded
    wave, as the reference's test of the same name holds it."""
    cfg, params, net, ds = setup
    spec = RouterSpec(algorithm="em", backend=backend, iterations=2)
    microbatch = 8
    real = ds.batch(5, 3)["images"]
    padded = np.zeros((microbatch, cfg.image_hw, cfg.image_hw,
                       cfg.image_channels), np.float32)
    padded[:3] = real
    mask = np.zeros((microbatch,), np.float32)
    mask[:3] = 1.0
    wave = tserve.make_wave_fn(net, spec, tserve.ServeConfig(
        microbatch=microbatch, n_micro=1, pipeline="software"))
    got = wave(_micro(cfg, padded, mask, 1, microbatch))[0, :3]
    ref_wave = tserve.make_wave_fn(net, spec, tserve.ServeConfig(
        microbatch=3, n_micro=1, pipeline="software"))
    want = ref_wave(_micro(cfg, real, np.ones(3), 1, 3))[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend,jbackend", [("torch", "jnp"),
                                              ("cuda", "pallas")])
def test_em_wave_scores_match_reference_server(setup, backend, jbackend):
    cfg, params, net, ds = setup
    serve_cfg = tserve.ServeConfig(microbatch=4, n_micro=2)
    jwave = jserve.make_wave_fn(params, cfg, jrouter.RouterSpec(
        algorithm="em", backend=jbackend, iterations=cfg.routing_iters),
        serve_cfg)
    adapter = tserve.CapsAdapter(net, RouterSpec(
        algorithm="em", backend=backend, iterations=cfg.routing_iters))
    packed = adapter.pack(list(ds.batch(7, 6)["images"]), serve_cfg)
    got = adapter.make_wave_fn(serve_cfg)(packed)
    want = jwave({k: jnp.asarray(v.numpy()) for k, v in packed.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_em_wave_needs_a_recipe(setup):
    cfg, params, net, ds = setup
    from repro_torch.core import router as trouter
    trouter.register_algorithm(trouter.Algorithm(
        name="_three_inputs", run=lambda args, spec, axes: args[0],
        num_inputs=3))
    try:
        with pytest.raises(ValueError, match="no serving wave recipe"):
            tserve.make_wave_fn(net, RouterSpec(algorithm="_three_inputs"),
                                tserve.ServeConfig(microbatch=2, n_micro=1))
    finally:
        del trouter._REGISTRY["_three_inputs"]


@pytest.mark.parametrize("extra", [[], ["--async"], ["--backend", "torch"],
                                   ["--pipeline", "none"]],
                         ids=["sync-cuda", "async-cuda", "sync-torch",
                              "unpipelined-cuda"])
def test_serve_cli_em_on_cpu(extra, capsys):
    s = tcli.main(["--smoke", "--device", "cpu", "--algorithm", "em",
                   "--requests", "12", *extra])
    assert s["completed"] == 12 and s["failed"] == 0
    out = capsys.readouterr().out
    assert "algorithm=em" in out and "served 12 requests" in out
