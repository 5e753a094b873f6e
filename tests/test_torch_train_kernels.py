"""PyTorch port, the training kernels against the JAX reference on the same
numpy inputs:

* ``routing_procedure_bwd`` (its plain version on the CPU) against the
  reference's backward kernel run in interpret mode — ≤ 1e-5 fp32 and
  ``GRAD_ATOL`` bf16, over iterations × stream dtype × L (one, four and two
  L-tiles);
* the closed-form squash vjp that ``csrc/routing_bwd.cu`` writes out,
  against autograd of the exact squash;
* the autograd Function ``dynamic_routing_procedure_train`` against
  ``jax.vjp`` of the reference's and against autograd of the port's own
  ``core.routing.dynamic_routing``, a finite-difference probe, the
  saves-only-û claim, exactly-zero padding gradients, bitwise determinism
  and the int8 refusal;
* the kernel wrappers refuse a û that requires grad (they would cut
  autograd), on the plain path as on the card;
* ``procedure_train_l_tile`` and ``dma_bytes_per_call(backward=True)``
  equal to the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _gradcheck import GRAD_ATOL
from repro.kernels.routing import kernel as jkernel
from repro.kernels.routing import ops as jops
from repro_torch.core import routing as trouting
from repro_torch.core.router import RouterSpec, build_router
from repro_torch.kernels.routing import kernel as tkernel
from repro_torch.kernels.routing import ops as tops
from repro_torch.kernels.routing import ref as tref

FP32_TOL = 1e-5
CPU = "cpu"


def _rand(shape, seed, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 and back, the same in both packages."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# the backward kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("stream_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("L,l_tile", [(64, 64), (64, 16), (136, 68)])
def test_backward_matches_reference(iters, stream_dtype, L, l_tile):
    u = _rand((2, L, 6, 8), seed=L + iters)
    g = _rand((2, 6, 8), seed=7)
    if stream_dtype == "bf16":
        u = _bf16(u)
    dt_j = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[stream_dtype]
    dt_t = {"fp32": torch.float32, "bf16": torch.bfloat16}[stream_dtype]
    want = jkernel.routing_procedure_bwd(
        jnp.asarray(u, dt_j), jnp.asarray(g), iterations=iters,
        l_tile=l_tile, interpret=True)
    got = tkernel.routing_procedure_bwd(
        torch.from_numpy(u).to(dt_t), torch.from_numpy(g),
        iterations=iters, l_tile=l_tile)
    assert got.dtype == dt_t and tuple(got.shape) == u.shape
    tol = FP32_TOL if stream_dtype == "fp32" else GRAD_ATOL["bf16"]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def test_backward_approx_mode_matches_reference():
    """use_approx replays the approx forward and differentiates the exact
    squash, as the reference's kernel does."""
    u = _rand((3, 64, 5, 8), seed=3, scale=0.5)
    g = _rand((3, 5, 8), seed=4)
    want = jkernel.routing_procedure_bwd(
        jnp.asarray(u), jnp.asarray(g), iterations=3, l_tile=16,
        use_approx=True, interpret=True)
    got = tkernel.routing_procedure_bwd(
        torch.from_numpy(u), torch.from_numpy(g), iterations=3, l_tile=16,
        use_approx=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FP32_TOL)


def _squash_vjp_closed_form(s: np.ndarray, gv: np.ndarray) -> np.ndarray:
    """The derivative routing_bwd.cu writes out: v = s·f(n2),
    ∂s = f·∂v + 2·f'(n2)·<s,∂v>·s, f' = a·r·(a − n2·r²/2)."""
    n2 = np.sum(s * s, axis=-1, keepdims=True)
    dot = np.sum(s * gv, axis=-1, keepdims=True)
    a = np.float32(1.0) / (np.float32(1.0) + n2)
    r = np.float32(1.0) / np.sqrt(n2 + np.float32(1e-9))
    f = n2 * a * r
    fp = a * r * (a - np.float32(0.5) * n2 * r * r)
    return f * gv + np.float32(2.0) * fp * dot * s


@pytest.mark.parametrize("scale", [1e-3, 0.3, 1.0, 30.0])
def test_squash_vjp_closed_form_matches_autograd(scale):
    s = _rand((4, 6, 16), seed=5, scale=scale)
    s[0, 0] = 0.0                       # a padding lane: exactly zero
    gv = _rand((4, 6, 16), seed=6)
    want = tkernel._squash_vjp(torch.from_numpy(s),
                               torch.from_numpy(gv)).numpy()
    got = _squash_vjp_closed_form(s, gv)
    assert not got[0, 0].any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_backward_argument_contract():
    u = torch.from_numpy(_rand((2, 64, 5, 8), seed=8))
    g = torch.from_numpy(_rand((2, 5, 8), seed=9))
    with pytest.raises(ValueError, match="not divisible"):
        tkernel.routing_procedure_bwd(u, g, l_tile=24)
    tkernel.reset_launch_counts()
    tkernel.routing_procedure_bwd(u, g, l_tile=16)
    assert tkernel.launch_counts()["routing_procedure_bwd"] == 0


# ---------------------------------------------------------------------------
# the reverse sweep's decomposition (csrc/routing.cu, reverse_tile_kernel)
# ---------------------------------------------------------------------------

def _backward_by_cells(u, g, iters, l_tile, geo, mutate=None):
    """∂û with the reverse sweep summed as the kernels decompose it on the
    forward's geometry ``geo``: a row group's gc as the cluster ranks'
    parts over their batch chunks, added in rank order; the Eq.5 vjp into
    ∂b; the ∂v carry of slot y over its row groups y, y + slots, …, the
    slots then added in order, and the exact squash vjp.  The replay and
    the ∂û sum are the plain version's.  ``mutate`` ("skip" or "double")
    drops or repeats one row group's carry, the fault a wrong walk makes."""
    B, L, H, C = u.shape
    T, r, kb = iters, geo.rows, geo.batch_chunk
    f32 = dict(dtype=torch.float32)
    b = torch.zeros((L, H), **f32)
    v = torch.zeros((B, H, C), **f32)
    c_all, s_all, vp_all = (torch.empty((T, *x), **f32) for x in
                            ((L, H), (B, H, C), (B, H, C)))
    for t in range(T):
        vp_all[t] = v
        s = None
        for j in range(L // l_tile):
            rows = slice(j * l_tile, (j + 1) * l_tile)
            b[rows] = b[rows] + torch.sum(u[:, rows] * v[:, None], dim=(0, 3))
            coup = tkernel._softmax_h(b[rows], False)
            c_all[t, rows] = coup
            part = torch.sum(u[:, rows] * coup[None, :, :, None], dim=1)
            s = part if s is None else s + part
        s_all[t] = s
        v = tref.squash(s, False)
    gv = g
    gb = torch.zeros((L, H), **f32)
    gs_all = torch.empty((T, B, H, C), **f32)
    gb_all = torch.zeros((T, L, H), **f32)
    for t in range(T - 1, 0, -1):
        gs = tkernel._squash_vjp(s_all[t], gv)
        gs_all[t] = gs
        partial = torch.zeros((geo.slots, B, H, C), **f32)
        for y in range(geo.slots):
            for grp in range(y, geo.groups, geo.slots):
                rows = slice(grp * r, (grp + 1) * r)
                gc = None
                for q in range(geo.cluster):
                    ks = slice(q * kb, min(B, (q + 1) * kb))
                    part = torch.sum(u[ks, rows] * gs[ks, None], dim=(0, 3))
                    gc = part if gc is None else gc + part
                ct = c_all[t, rows]
                gbt = gb[rows] + ct * (gc - torch.sum(ct * gc, -1, keepdim=True))
                gb[rows] = gbt
                gb_all[t, rows] = gbt
                carry = torch.sum(u[:, rows] * gbt[None, :, :, None], dim=1)
                last = grp + geo.slots >= geo.groups
                if mutate == "skip" and y == 0 and last:
                    continue
                if mutate == "double" and y == 0 and last:
                    partial[y] += carry
                partial[y] += carry
        gv = partial[0]
        for y in range(1, geo.slots):
            gv = gv + partial[y]
    gs_all[0] = tkernel._squash_vjp(s_all[0], gv)
    du = c_all[0][None, :, :, None] * gs_all[0][:, None]
    for t in range(1, T):
        du += c_all[t][None, :, :, None] * gs_all[t][:, None]
        du += gb_all[t][None, :, :, None] * vp_all[t][:, None]
    return du


def _backward_f64(u, g, iters):
    """∂û by float64 autograd of the textbook routing loop: how far fp32
    round-off alone moves the plain version on this shape."""
    u64 = u.double().requires_grad_()
    B, L, H, C = u.shape
    b = torch.zeros((L, H), dtype=torch.float64)
    v = torch.zeros((B, H, C), dtype=torch.float64)
    for _ in range(iters):
        b = b + torch.einsum("blhc,bhc->lh", u64, v)
        c = torch.softmax(b, dim=-1)
        s = torch.einsum("blhc,lh->bhc", u64, c)
        n2 = torch.sum(s * s, dim=-1, keepdim=True)
        v = s * (n2 / (1.0 + n2)) / torch.sqrt(n2 + 1e-9)
    (du,) = torch.autograd.grad(v, u64, g.double())
    return du


def _cells(B, L, H, C, iters, cluster):
    """The training tile and its geometry: ``tile_geometry``'s own, or one
    with B split over ``cluster`` ranks and slots that do not divide the
    row groups (an uneven walk)."""
    l_tile = tops.procedure_train_l_tile(B, L, H, C, iters, "fp32")
    geo = tops.tile_geometry(B, L, H, C, l_tile, "fp32")
    if cluster:
        kb = -(-B // cluster)
        rows = geo.rows
        groups = L // rows
        geo = tops.TileGeometry(rows=rows, batch_chunk=kb,
                                cluster=-(-B // kb), staged=True,
                                smem_bytes=0, groups=groups,
                                slots=max(1, groups // 3 - 1))
    return l_tile, geo


# the smoke config's routing shape and Caps-SV3's L, H, C (9 iterations)
# at small B, each at tile_geometry's cells and at a split over ranks
REVERSE_CASES = [((16, 288, 10, 16), 3, 0), ((16, 288, 10, 16), 3, 8),
                 ((4, 576, 10, 16), 9, 0), ((5, 576, 10, 16), 9, 3)]


@pytest.mark.parametrize("shape,iters,cluster", REVERSE_CASES)
def test_reverse_sweep_cells_match_plain(shape, iters, cluster):
    """The reverse sweep summed over the kernel's cells — batch chunks by
    cluster rank, row groups by slot — within the fp32 gate of
    chip_smoke.py (max(1e-5·max(1, max|plain|), 2·ε64), ε64 the plain
    version's own distance to float64) of ``routing_procedure_bwd_plain``,
    which keeps the reference's tile-by-tile order."""
    B, L, H, C = shape
    u = torch.from_numpy(_rand(shape, seed=L + iters, scale=0.05))
    g = torch.from_numpy(_rand((B, H, C), seed=3))
    l_tile, geo = _cells(B, L, H, C, iters, cluster)
    assert geo.cluster * geo.batch_chunk >= B and L % geo.rows == 0
    if cluster:
        assert geo.cluster == cluster and geo.groups % geo.slots != 0
    want = tkernel.routing_procedure_bwd_plain(u, g, iterations=iters,
                                               l_tile=l_tile)
    got = _backward_by_cells(u, g, iters, l_tile, geo)
    eps64 = float((want.double() - _backward_f64(u, g, iters)).abs().max())
    tol = max(FP32_TOL * max(1.0, float(want.abs().max())), 2 * eps64)
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("mutate", ["skip", "double"])
def test_reverse_sweep_cells_notice_a_wrong_walk(mutate):
    """A row group whose ∂v carry is dropped or added twice fails the same
    gate."""
    shape, iters, cluster = REVERSE_CASES[1]
    B, L, H, C = shape
    u = torch.from_numpy(_rand(shape, seed=L + iters, scale=0.05))
    g = torch.from_numpy(_rand((B, H, C), seed=3))
    l_tile, geo = _cells(B, L, H, C, iters, cluster)
    want = tkernel.routing_procedure_bwd_plain(u, g, iterations=iters,
                                               l_tile=l_tile)
    got = _backward_by_cells(u, g, iters, l_tile, geo, mutate=mutate)
    eps64 = float((want.double() - _backward_f64(u, g, iters)).abs().max())
    tol = max(FP32_TOL * max(1.0, float(want.abs().max())), 2 * eps64)
    assert float((got - want).abs().max()) > tol


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _port_grad(f, u: np.ndarray, ct: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(u).requires_grad_()
    (g,) = torch.autograd.grad(f(x), x, torch.from_numpy(ct))
    return g.numpy()


@pytest.mark.parametrize("stream_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("L", [64, 136])
def test_train_function_matches_reference_vjp(stream_dtype, L):
    u = _rand((2, L, 6, 8), seed=11)
    ct = _rand((2, 6, 8), seed=12)
    jf = functools.partial(jops.dynamic_routing_procedure_train,
                           iterations=3, stream_dtype=stream_dtype)
    _, jvjp = jax.vjp(jf, jnp.asarray(u))
    want = np.asarray(jvjp(jnp.asarray(ct))[0])
    tf = functools.partial(tops.dynamic_routing_procedure_train,
                           iterations=3, stream_dtype=stream_dtype)
    got = _port_grad(tf, u, ct)
    assert got.dtype == np.float32       # autograd casts a bf16 ∂û back
    tol = GRAD_ATOL[stream_dtype]
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # and against autograd of the port's own eager routing
    eager = _port_grad(lambda x: trouting.dynamic_routing(
        x, trouting.RoutingConfig(iterations=3)), u, ct)
    np.testing.assert_allclose(got, eager, rtol=0, atol=tol)


def test_train_function_finite_difference():
    """Central differences of <f(x), w> along random unit directions
    against the analytic directional derivative (as
    ``_gradcheck.check_grad_finite_difference``)."""
    u = torch.from_numpy(_rand((2, 64, 5, 8), seed=13))
    w = torch.from_numpy(_rand((2, 5, 8), seed=14))
    f = functools.partial(tops.dynamic_routing_procedure_train, iterations=3)

    def loss(x):
        return torch.sum(f(x) * w)

    x = u.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss(x), x)
    rng = np.random.default_rng(15)
    eps = 1e-2
    for i in range(3):
        d = torch.from_numpy(rng.standard_normal(u.shape).astype(np.float32))
        d = d / torch.sqrt(torch.sum(d * d))
        with torch.no_grad():
            fd = (loss(u + eps * d) - loss(u - eps * d)) / (2 * eps)
        np.testing.assert_allclose(float(fd), float(torch.sum(g * d)),
                                   rtol=5e-2, atol=5e-3,
                                   err_msg=f"FD probe {i}")


@pytest.mark.parametrize("stream_dtype", ["fp32", "bf16"])
def test_train_function_saves_only_u_hat(stream_dtype):
    """Recompute-b: nothing larger than B·H·C other than û is saved for
    the backward (autograd of the eager loop, by contrast, keeps
    per-iteration û-sized tensors)."""
    B, L, H, C = 2, 64, 6, 8
    u = torch.from_numpy(_rand((B, L, H, C), seed=16)).requires_grad_()
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        v = tops.dynamic_routing_procedure_train(
            u, iterations=3, stream_dtype=stream_dtype)
    big = [s for s in saved if int(np.prod(s)) > B * H * C]
    assert big == [(B, L, H, C)], saved
    v.sum().backward()
    assert u.grad is not None and u.grad.dtype == torch.float32
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        trouting.dynamic_routing(u, trouting.RoutingConfig(iterations=3))
    assert sum(int(np.prod(s)) > B * H * C for s in saved) > 1


@pytest.mark.parametrize("n_pad,iters,stream_dtype",
                         [(1, 3, "fp32"), (2, 2, "bf16"), (3, 1, "fp32")])
def test_train_function_padding_and_determinism(n_pad, iters, stream_dtype):
    """Zero (padding) lanes with a zero cotangent get exactly zero
    gradient, and two backward passes are bitwise equal."""
    B = 4
    u = _rand((B, 64, 5, 8), seed=20 + n_pad)
    u[B - n_pad:] = 0.0
    ct = _rand((B, 5, 8), seed=21)
    ct[B - n_pad:] = 0.0
    f = functools.partial(tops.dynamic_routing_procedure_train,
                          iterations=iters, stream_dtype=stream_dtype)
    g1, g2 = _port_grad(f, u, ct), _port_grad(f, u, ct)
    assert not g1[B - n_pad:].any(), "padding lanes leaked gradient"
    assert g1[:B - n_pad].any()
    np.testing.assert_array_equal(g1, g2)


def test_train_function_rejects_int8():
    u = torch.zeros((2, 64, 5, 8))
    with pytest.raises(ValueError, match="no custom VJP"):
        tops.dynamic_routing_procedure_train(u, stream_dtype="int8")
    with pytest.raises(ValueError, match="no int8 form"):
        tops.dma_bytes_per_call(2, 64, 5, 8, form="procedure",
                                stream_dtype="int8", backward=True)


# ---------------------------------------------------------------------------
# forward-only kernels refuse a û that requires grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion,stream_dtype",
                         [("procedure", "fp32"), ("iteration", "fp32"),
                          ("auto", "bf16"), ("auto", "int8")])
def test_forward_kernels_refuse_autograd(fusion, stream_dtype):
    spec = RouterSpec(backend="cuda", fusion=fusion,
                      stream_dtype=stream_dtype)
    router = build_router(spec, device=CPU)
    u = torch.from_numpy(_rand((2, 64, 5, 8), seed=30)).requires_grad_()
    with pytest.raises(ValueError, match=r"RouterSpec\(differentiable=True\)"):
        router(u)
    with torch.no_grad():
        assert router(u).grad_fn is None
    # the differentiable twin trains through the same kernels
    if stream_dtype != "int8" and fusion != "iteration":
        twin = build_router(spec._replace(differentiable=True), device=CPU)
        twin(u).sum().backward()
        assert u.grad is not None and bool(torch.isfinite(u.grad).all())


def test_kernel_wrappers_refuse_autograd():
    u = torch.from_numpy(_rand((2, 64, 5, 8), seed=31)).requires_grad_()
    B, L, H, C = u.shape
    g = torch.zeros((B, H, C))
    calls = [
        lambda: tkernel.routing_procedure_fused(u, l_tile=16),
        lambda: tkernel.routing_iteration_fused(
            u, torch.zeros(L, H), torch.zeros(B, H, C), l_tile=16),
        lambda: tkernel.routing_procedure_bwd(u, g, l_tile=16),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="no autograd formula"):
            call()
        with torch.no_grad():
            call()


# ---------------------------------------------------------------------------
# the training tile rule and the backward byte model
# ---------------------------------------------------------------------------

def _grid():
    from repro.configs.caps_benchmarks import CAPS_BENCHMARKS
    shapes = set()
    for c in CAPS_BENCHMARKS.values():
        for b in (1, 8, 100):
            shapes.add((b, c.num_l_caps, c.num_h_caps, c.h_caps_dim,
                        c.routing_iters))
    shapes |= {(2, 64, 6, 8, 3), (2, 136, 6, 8, 2), (512, 4608, 62, 16, 9)}
    return sorted(shapes)


def test_train_tile_rule_matches_reference():
    for B, L, H, C, T in _grid():
        for sd in ("fp32", "bf16"):
            lt = tops.procedure_train_l_tile(B, L, H, C, T, sd)
            assert lt == jops.procedure_train_l_tile(B, L, H, C, T, sd)
            assert tops.procedure_bwd_vmem_bytes(B, L, H, C, lt, T, sd) == \
                jops.procedure_bwd_vmem_bytes(B, L, H, C, lt, T, sd)
    # the worked examples: Caps-MN1 fp32 / bf16, EN3, CF3, SV3 at B=100
    assert tops.procedure_train_l_tile(100, 1152, 10, 16) == 48
    assert tops.procedure_train_l_tile(100, 1152, 10, 16, 3, "bf16") == 96
    assert tops.procedure_train_l_tile(100, 1152, 62, 16) == 4
    assert tops.procedure_train_l_tile(100, 4608, 11, 16) == 36
    assert tops.procedure_train_l_tile(100, 576, 10, 16, 9) == 48


def test_backward_byte_model_matches_reference():
    for B, L, H, C, T in _grid():
        for sd in ("fp32", "bf16"):
            want = jops.dma_bytes_per_call(B, L, H, C, T, form="procedure",
                                           stream_dtype=sd, backward=True)
            got = tops.dma_bytes_per_call(B, L, H, C, T, form="procedure",
                                          stream_dtype=sd, backward=True)
            for key in ("u_hat_stream_bytes", "du_stream_bytes",
                        "roundtrip_bytes", "total_bytes", "u_hat_bytes",
                        "naive_bytes", "backward"):
                assert got[key] == want[key], (B, L, H, C, T, sd, key)
    # the bound worked out for Caps-MN1 fp32 at B=100: 516 MB
    mn1 = tops.dma_bytes_per_call(100, 1152, 10, 16, 3, form="procedure",
                                  backward=True)
    assert mn1["total_bytes"] == 516_160_000
    assert tops.dma_bytes_per_call(4, 64, 5, 8)["backward"] is False
    for kw in (dict(form="iteration", backward=True),
               dict(form="procedure", backward=True,
                    early_exit_work_fraction=0.5)):
        with pytest.raises(ValueError) as got:
            tops.dma_bytes_per_call(4, 64, 5, 8, **kw)
        with pytest.raises(ValueError) as want:
            jops.dma_bytes_per_call(4, 64, 5, 8, **kw)
        assert str(got.value) == str(want.value)
