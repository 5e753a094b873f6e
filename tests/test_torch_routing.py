"""PyTorch port, dynamic routing and the routing kernels' plain versions
against the JAX reference on the same numpy inputs:

* ``core.routing.dynamic_routing`` (exact and approx) against
  ``repro.core.routing`` — ≤ 1e-5;
* the plain versions of ``routing_procedure_fused`` (fp32, bf16, int8,
  early exit) and ``routing_iteration_fused`` (fp32, bf16) against the
  Pallas kernels run in interpret mode — ≤ 1e-5 on the same stream, with
  equal early-exit work counters;
* ``quantize_u_stream`` bit-equal; the tile pickers, ``resolve_fusion`` and
  the analytic byte model equal to the reference over a grid holding all
  12 Table-1 shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.caps_benchmarks import CAPS_BENCHMARKS
from repro.core import routing as jrouting
from repro.kernels.routing import kernel as jkernel
from repro.kernels.routing import ops as jops
from repro.kernels.routing import ref as jref
from repro_torch.core import routing as trouting
from repro_torch.kernels.routing import kernel as tkernel
from repro_torch.kernels.routing import ops as tops
from repro_torch.kernels.routing import ref as tref

TOL = 1e-5
SHAPE = (3, 64, 5, 8)          # B, L, H, C
L_TILE = 16


def _votes(shape=SHAPE, seed=0, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# core.routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_approx", [False, True])
@pytest.mark.parametrize("iterations", [1, 3])
def test_dynamic_routing_matches_reference(use_approx, iterations):
    u = _votes()
    want = jrouting.dynamic_routing(
        jnp.asarray(u), jrouting.RoutingConfig(iterations=iterations,
                                               use_approx=use_approx))
    got = trouting.dynamic_routing(
        torch.from_numpy(u), trouting.RoutingConfig(iterations=iterations,
                                                    use_approx=use_approx))
    _close(got, want)


def test_dynamic_routing_with_stats_matches_reference():
    u = _votes(seed=1)
    jv, jb, jc = jrouting.dynamic_routing_with_stats(
        jnp.asarray(u), jrouting.RoutingConfig())
    tv, tb, tc = trouting.dynamic_routing_with_stats(
        torch.from_numpy(u), trouting.RoutingConfig())
    _close(tv, jv)
    _close(tb, jb, tol=1e-4 * max(1.0, float(np.abs(jb).max())))
    _close(tc, jc)


@pytest.mark.parametrize("use_approx", [False, True])
def test_lazy_update_oracle_matches_reference(use_approx):
    u = _votes(seed=2)
    want = jref.dynamic_routing_ref(jnp.asarray(u), 3, use_approx)
    got = tref.dynamic_routing_ref(torch.from_numpy(u), 3, use_approx)
    _close(got, want)


def test_sharded_routing_is_a_later_slice():
    """The sharded RoutingConfig forms, once the distribution slice's,
    now run: under an active 1-rank mesh they equal the reference's
    unsharded routing (eager and fused), and outside one the collective
    says so."""
    from repro_torch.runtime import mesh_utils
    u = _votes()
    want = jrouting.dynamic_routing(jnp.asarray(u), jrouting.RoutingConfig())
    mesh = mesh_utils.make_mesh((1,), ("x",), device="cpu")
    for fused in (False, True):
        for cfg in (trouting.RoutingConfig(sharded_dim="L", axis_name="x",
                                           fused=fused),
                    trouting.RoutingConfig(axes=(("B", "x"),),
                                           fused=fused)):
            with mesh_utils.active(mesh):
                _close(trouting.dynamic_routing(torch.from_numpy(u), cfg),
                       want)
            with pytest.raises(RuntimeError, match="outside a sharded"):
                trouting.dynamic_routing(torch.from_numpy(u), cfg)


def test_fused_config_routes_through_kernel_plain_on_cpu():
    u = _votes(seed=3)
    want = jrouting.dynamic_routing(jnp.asarray(u), jrouting.RoutingConfig())
    got = trouting.dynamic_routing(torch.from_numpy(u),
                                   trouting.RoutingConfig(fused=True))
    _close(got, want)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _stream(u: np.ndarray, stream_dtype: str):
    """The same û stream for both packages: bf16 by round-to-nearest-even
    in both, int8 through each package's own quantize_u_stream."""
    if stream_dtype == "int8":
        jq, js = jops.quantize_u_stream(jnp.asarray(u), L_TILE)
        tq, ts = tops.quantize_u_stream(torch.from_numpy(u), L_TILE)
        return (jq, js), (tq, ts)
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[stream_dtype]
    tdt = tops.STREAM_DTYPES[stream_dtype]
    return (jnp.asarray(u).astype(jdt), None), \
        (torch.from_numpy(u).to(tdt), None)


@pytest.mark.parametrize("stream_dtype,use_approx",
                         [("fp32", False), ("fp32", True), ("bf16", False),
                          ("int8", False), ("int8", True)])
def test_procedure_plain_matches_pallas(stream_dtype, use_approx):
    u = _votes(seed=4)
    (ju, js), (tu, ts) = _stream(u, stream_dtype)
    want = jkernel.routing_procedure_fused(
        ju, js, iterations=3, l_tile=L_TILE, use_approx=use_approx,
        interpret=True)
    got = tkernel.routing_procedure_fused_plain(
        tu, ts, iterations=3, l_tile=L_TILE, use_approx=use_approx)
    _close(got, want)


@pytest.mark.parametrize("eps", [0.0, 2.0, 1e6])
def test_procedure_plain_early_exit_matches_pallas(eps):
    u = _votes(seed=5, scale=0.3)
    jv, jcnt = jkernel.routing_procedure_fused(
        jnp.asarray(u), iterations=4, l_tile=L_TILE, interpret=True,
        early_exit_eps=eps)
    tv, tcnt = tkernel.routing_procedure_fused_plain(
        torch.from_numpy(u), iterations=4, l_tile=L_TILE,
        early_exit_eps=eps)
    _close(tv, jv)
    assert int(tcnt) == int(jcnt)
    n = SHAPE[1] // L_TILE
    if eps == 0.0:
        assert int(tcnt) == 4 * n
    if eps == 1e6:
        assert int(tcnt) == 2 * n      # every tile freezes at iteration 1


def test_procedure_plain_int8_early_exit_matches_pallas():
    u = _votes(seed=6, scale=0.3)
    (jq, js), (tq, ts) = _stream(u, "int8")
    jv, jcnt = jkernel.routing_procedure_fused(
        jq, js, iterations=3, l_tile=L_TILE, interpret=True,
        early_exit_eps=1e6)
    tv, tcnt = tkernel.routing_procedure_fused_plain(
        tq, ts, iterations=3, l_tile=L_TILE, early_exit_eps=1e6)
    _close(tv, jv)
    assert int(tcnt) == int(jcnt)


@pytest.mark.parametrize("stream_dtype,use_approx",
                         [("fp32", False), ("fp32", True), ("bf16", False)])
def test_iteration_plain_matches_pallas(stream_dtype, use_approx):
    u = _votes(seed=7)
    rng = np.random.default_rng(8)
    B, L, H, C = SHAPE
    b = rng.standard_normal((L, H)).astype(np.float32)
    v = (0.1 * rng.standard_normal((B, H, C))).astype(np.float32)
    (ju, _), (tu, _) = _stream(u, stream_dtype)
    js, jb = jkernel.routing_iteration_fused(
        ju, jnp.asarray(b), jnp.asarray(v), l_tile=L_TILE,
        use_approx=use_approx, interpret=True)
    ts, tb = tkernel.routing_iteration_fused_plain(
        tu, torch.from_numpy(b), torch.from_numpy(v), l_tile=L_TILE,
        use_approx=use_approx)
    _close(ts, js)
    _close(tb, jb)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    u = torch.from_numpy(_votes(seed=9))
    tkernel.reset_launch_counts()
    v = tkernel.routing_procedure_fused(u, l_tile=L_TILE)
    B, L, H, C = SHAPE
    s, b = tkernel.routing_iteration_fused(
        u, torch.zeros(L, H), torch.zeros(B, H, C), l_tile=L_TILE)
    torch.testing.assert_close(
        v, tkernel.routing_procedure_fused_plain(u, l_tile=L_TILE),
        rtol=0, atol=0)
    r = torch.full((B, L, H), 1.0 / H)
    rsum, rv, _ = tkernel.em_stage_stats(u, r, torch.ones(B, L),
                                         l_tile=L_TILE)
    tkernel.em_stage_estep(u, rv, torch.ones(B, H, C), torch.zeros(B, H),
                           l_tile=L_TILE)
    assert tkernel.launch_counts() == {"routing_procedure_fused": 0,
                                       "routing_iteration_fused": 0,
                                       "routing_procedure_bwd": 0,
                                       "routing_stage_votes": 0,
                                       "routing_stage_update": 0,
                                       "routing_stage_update_fold": 0,
                                       "em_stage_stats": 0,
                                       "em_stage_estep": 0}


def test_procedure_argument_contract():
    u = torch.from_numpy(_votes())
    q, s = tops.quantize_u_stream(u, L_TILE)
    with pytest.raises(ValueError, match="needs per-tile scales"):
        tkernel.routing_procedure_fused(q, l_tile=L_TILE)
    with pytest.raises(ValueError, match="expected int8 codes"):
        tkernel.routing_procedure_fused(u, s, l_tile=L_TILE)
    with pytest.raises(ValueError, match="scales shape"):
        tkernel.routing_procedure_fused(q, s[:2], l_tile=L_TILE)
    with pytest.raises(ValueError, match="not divisible"):
        tkernel.routing_procedure_fused(u, l_tile=24)
    with pytest.raises(ValueError, match="must be >= 0"):
        tkernel.routing_procedure_fused(u, l_tile=L_TILE,
                                        early_exit_eps=-1.0)


# ---------------------------------------------------------------------------
# ops: the public entry points, quantisation and the tile rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream_dtype,eps",
                         [("fp32", None), ("bf16", None), ("int8", 1e6),
                          ("fp32", 0.0)])
def test_procedure_stats_match_reference(stream_dtype, eps):
    u = _votes(seed=10, scale=0.3)
    jv, jcnt = jops.dynamic_routing_procedure_stats(
        jnp.asarray(u), iterations=3, l_tile=L_TILE,
        stream_dtype=stream_dtype, early_exit_eps=eps, interpret=True)
    tv, tcnt = tops.dynamic_routing_procedure_stats(
        torch.from_numpy(u), iterations=3, l_tile=L_TILE,
        stream_dtype=stream_dtype, early_exit_eps=eps)
    _close(tv, jv)
    assert int(tcnt) == int(jcnt)


@pytest.mark.parametrize("stream_dtype", ["fp32", "bf16"])
def test_dynamic_routing_fused_matches_reference(stream_dtype):
    u = _votes(seed=11)
    want = jops.dynamic_routing_fused(jnp.asarray(u), iterations=3,
                                      l_tile=L_TILE,
                                      stream_dtype=stream_dtype,
                                      interpret=True)
    got = tops.dynamic_routing_fused(torch.from_numpy(u), iterations=3,
                                     l_tile=L_TILE,
                                     stream_dtype=stream_dtype)
    _close(got, want)


def test_quantize_u_stream_bit_equal():
    u = _votes(seed=12)
    u[:, :L_TILE] = 0.0                    # an all-zero tile: the 1/127 floor
    u[0, 20, 1, 2] = 1e-3 * 127 * 2.5      # a round-half-even tie candidate
    jq, js = jops.quantize_u_stream(jnp.asarray(u), L_TILE)
    tq, ts = tops.quantize_u_stream(torch.from_numpy(u), L_TILE)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


def test_quantize_u_stream_gives_contiguous_codes_for_strided_votes():
    """Eq.1's einsum hands the router a strided û; the int8 codes the
    procedure kernel reads must still be contiguous, and equal to those of
    the same values laid out contiguously."""
    u = torch.from_numpy(_votes(seed=13))
    strided = u.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not strided.is_contiguous()
    q, s = tops.quantize_u_stream(strided, L_TILE)
    want_q, want_s = tops.quantize_u_stream(u, L_TILE)
    assert q.is_contiguous()
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


def _shape_grid():
    shapes = {(c.batch_size, c.num_l_caps, c.num_h_caps, c.h_caps_dim)
              for c in CAPS_BENCHMARKS.values()}
    for c in CAPS_BENCHMARKS.values():
        for b in (1, 8, 32, 100):
            shapes.add((b, c.num_l_caps, c.num_h_caps, c.h_caps_dim))
    shapes |= {(4, 64, 6, 8), (2, 96, 6, 8), (512, 4608, 62, 16),
               (3000, 1152, 62, 16), (7, 97, 3, 5)}
    return sorted(shapes)


def test_tile_rules_match_reference_on_table1_grid():
    grid = _shape_grid()
    assert len(grid) > 12
    for (B, L, H, C) in grid:
        for sd in ("fp32", "bf16", "int8"):
            for ee in (False, True):
                assert tops.procedure_l_tile(B, L, H, C, sd, early_exit=ee) \
                    == jops.procedure_l_tile(B, L, H, C, sd, early_exit=ee)
            assert tops.auto_l_tile(B, L, H, C, sd) == \
                jops.auto_l_tile(B, L, H, C, sd)
            lt = tops.procedure_l_tile(B, L, H, C, sd)
            assert tops.procedure_vmem_bytes(B, L, H, C, lt, sd) == \
                jops.procedure_vmem_bytes(B, L, H, C, lt, sd)
        for budget in (1, 2 ** 16, 2 ** 23):
            assert tops.pick_l_tile(L, budget, B * H * C * 4) == \
                jops.pick_l_tile(L, budget, B * H * C * 4)


def test_resolve_fusion_matches_reference_on_table1_grid():
    for shape in _shape_grid():
        for fusion in ("auto", "iteration", "procedure"):
            for sd in ("fp32", "bf16", "int8"):
                for ee in (False, True):
                    try:
                        want = jops.resolve_fusion(fusion, shape, sd,
                                                   early_exit=ee)
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            tops.resolve_fusion(fusion, shape, sd,
                                                early_exit=ee)
                        assert str(got.value) == str(e)
                        continue
                    assert tops.resolve_fusion(fusion, shape, sd,
                                               early_exit=ee) == want
    # the issue's worked examples: Caps-MN1 and Caps-EN3 at B=100
    assert tops.procedure_l_tile(100, 1152, 10, 16) == 96
    assert tops.procedure_l_tile(100, 1152, 62, 16) == 16
    assert tops.auto_l_tile(8, 1152, 10, 16, "fp32") == 128
    assert tops.resolve_fusion("auto", (4, 64, 6, 8),
                               sharded=True) == "stage_split"


def test_dma_model_matches_reference():
    for (B, L, H, C) in _shape_grid()[:20]:
        for form, sd in (("iteration", "fp32"), ("iteration", "bf16"),
                         ("procedure", "fp32"), ("procedure", "int8")):
            want = jops.dma_bytes_per_call(B, L, H, C, 3, form=form,
                                           stream_dtype=sd)
            got = tops.dma_bytes_per_call(B, L, H, C, 3, form=form,
                                          stream_dtype=sd)
            for key in ("u_hat_stream_bytes", "roundtrip_bytes",
                        "total_bytes", "u_hat_bytes", "naive_bytes"):
                assert got[key] == want[key], (form, sd, key)
        got = tops.dma_bytes_per_call(B, L, H, C, 3, form="procedure",
                                      early_exit_work_fraction=2 / 3)
        want = jops.dma_bytes_per_call(B, L, H, C, 3, form="procedure",
                                       early_exit_work_fraction=2 / 3)
        assert got["total_bytes"] == want["total_bytes"]
