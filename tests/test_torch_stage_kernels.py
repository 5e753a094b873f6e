"""PyTorch port, the stage-split kernels of sharded routing against the JAX
reference on the same numpy inputs:

* the plain versions of ``routing_stage_votes`` / ``routing_stage_update`` /
  ``routing_stage_update_fold`` against the Pallas kernels in interpret
  mode — fp32 and bf16 streams, exact and approx, ``l_tile`` below L —
  within ``FWD_ATOL`` (fp32 1e-5, bf16 5e-2) scaled by max(1, max|want|);
* the reference's error surface (``L % l_tile``), its fold == update + host
  softmax case (``tests/test_kernels.py:444``), the autograd refusal and
  the launch counters (CPU tensors take the plain versions, uncounted);
* ``resolve_fusion(sharded=True)`` and ``dma_bytes_per_call`` for the
  stage-split form and its fold, against the reference's;
* ``dynamic_routing_fused_sharded`` with no sharded axis (the collectives
  are the identity) against the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.routing import kernel as jkernel
from repro.kernels.routing import ops as jops
from repro_torch.kernels.routing import kernel as tkernel
from repro_torch.kernels.routing import ops as tops

FWD_ATOL = {"fp32": 1e-5, "bf16": 5e-2}     # tests/_gradcheck.py
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _inputs(shape, seed):
    """û at the encoder's scale, couplings c = softmax of seeded logits, a
    vote sum s at the scale Eq.2 gives, and logits b, as numpy fp32."""
    B, L, H, C = shape
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    logits = rng.standard_normal((L, H)).astype(np.float32)
    c = np.exp(logits - logits.max(-1, keepdims=True))
    c = (c / c.sum(-1, keepdims=True)).astype(np.float32)
    s = (rng.standard_normal((B, H, C)) * 2.0).astype(np.float32)
    b = rng.standard_normal((L, H)).astype(np.float32)
    return u, c, s, b


def _stream(u, sd):
    """The same bf16-rounded û for both packages."""
    t = torch.from_numpy(u).to(TDT[sd])
    return t, jnp.asarray(t.float().numpy()).astype(JDT[sd])


def _close(got: torch.Tensor, want, tol):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)


CASES = [((2, 64, 5, 8), 16), ((3, 48, 11, 8), 48), ((2, 96, 4, 16), 32)]


@pytest.mark.parametrize("sd", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,l_tile", CASES)
def test_stage_votes_plain_matches_pallas(shape, l_tile, sd):
    u, c, _, _ = _inputs(shape, seed=l_tile)
    tu, ju = _stream(u, sd)
    want = jkernel.routing_stage_votes(ju, jnp.asarray(c), l_tile=l_tile)
    got = tkernel.routing_stage_votes(tu, torch.from_numpy(c), l_tile=l_tile)
    _close(got, want, FWD_ATOL[sd])


@pytest.mark.parametrize("use_approx", [False, True])
@pytest.mark.parametrize("sd", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,l_tile", CASES)
def test_stage_update_plain_matches_pallas(shape, l_tile, sd, use_approx):
    u, _, s, _ = _inputs(shape, seed=2 * l_tile)
    tu, ju = _stream(u, sd)
    jv, jdb = jkernel.routing_stage_update(ju, jnp.asarray(s), l_tile=l_tile,
                                           use_approx=use_approx)
    tv, tdb = tkernel.routing_stage_update(tu, torch.from_numpy(s),
                                           l_tile=l_tile,
                                           use_approx=use_approx)
    _close(tv, jv, FWD_ATOL["fp32"])          # v comes from s alone
    _close(tdb, jdb, FWD_ATOL[sd])


@pytest.mark.parametrize("use_approx", [False, True])
@pytest.mark.parametrize("sd", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,l_tile", CASES)
def test_stage_update_fold_plain_matches_pallas(shape, l_tile, sd,
                                                use_approx):
    u, _, s, b = _inputs(shape, seed=3 * l_tile)
    tu, ju = _stream(u, sd)
    want = jkernel.routing_stage_update_fold(
        ju, jnp.asarray(s), jnp.asarray(b), l_tile=l_tile,
        use_approx=use_approx)
    got = tkernel.routing_stage_update_fold(
        tu, torch.from_numpy(s), torch.from_numpy(b), l_tile=l_tile,
        use_approx=use_approx)
    assert len(got) == 3
    _close(got[0], want[0], FWD_ATOL["fp32"])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, FWD_ATOL[sd])


def test_stage_update_fold_matches_split():
    """The reference's ``test_stage_update_fold_matches_split``: the fold
    equals the update stage plus the host softmax."""
    u, _, s, b = _inputs((2, 64, 5, 8), seed=1)
    tu, ts, tb = map(torch.from_numpy, (u, s, b))
    v_f, b_f, c_f = tkernel.routing_stage_update_fold(tu, ts, tb, l_tile=32)
    v_u, db = tkernel.routing_stage_update(tu, ts, l_tile=32)
    torch.testing.assert_close(v_f, v_u, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(b_f, tb + db, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c_f, torch.softmax(tb + db, dim=-1),
                               rtol=1e-5, atol=1e-6)


def test_stage_wrappers_error_surface():
    u, c, s, b = map(torch.from_numpy, _inputs((2, 64, 5, 8), seed=0))
    for fn, args in ((tkernel.routing_stage_votes, (u, c)),
                     (tkernel.routing_stage_update, (u, s)),
                     (tkernel.routing_stage_update_fold, (u, s, b))):
        with pytest.raises(ValueError, match="not divisible by l_tile"):
            fn(*args, l_tile=48)
        with pytest.raises(ValueError, match="must be \\(B, L, H, C\\)"):
            fn(u[0], *args[1:], l_tile=16)
        # the reference's wrappers raise the same for L % l_tile
        with pytest.raises(ValueError, match="not divisible by l_tile"):
            getattr(jkernel, fn.__name__)(
                *map(lambda t: jnp.asarray(t.numpy()), args), l_tile=48)
        grad_u = u.clone().requires_grad_(True)
        with pytest.raises(ValueError, match="no autograd formula"):
            fn(grad_u, *args[1:], l_tile=16)
        with torch.no_grad():
            fn(grad_u, *args[1:], l_tile=16)


def test_stage_wrappers_take_plain_version_on_cpu_without_counting():
    u, c, s, b = map(torch.from_numpy, _inputs((2, 64, 5, 8), seed=4))
    tkernel.reset_launch_counts()
    got = (tkernel.routing_stage_votes(u, c, l_tile=16),
           *tkernel.routing_stage_update(u, s, l_tile=16),
           *tkernel.routing_stage_update_fold(u, s, b, l_tile=16))
    want = (tkernel.routing_stage_votes_plain(u, c, l_tile=16),
            *tkernel.routing_stage_update_plain(u, s, l_tile=16),
            *tkernel.routing_stage_update_fold_plain(u, s, b, l_tile=16))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    counts = tkernel.launch_counts()
    for name in ("routing_stage_votes", "routing_stage_update",
                 "routing_stage_update_fold"):
        assert counts[name] == 0


def test_resolve_fusion_sharded_matches_reference():
    """Under a sharded plan "auto"/"iteration" resolve to "stage_split";
    the reference's three refusals (procedure, int8, early exit) raise the
    same messages."""
    for fusion in ("auto", "iteration", "procedure"):
        for sd in ("fp32", "bf16", "int8"):
            for ee in (False, True):
                try:
                    want = jops.resolve_fusion(fusion, (4, 64, 6, 8), sd,
                                               sharded=True, early_exit=ee)
                except ValueError as e:
                    with pytest.raises(ValueError) as got:
                        tops.resolve_fusion(fusion, (4, 64, 6, 8), sd,
                                            sharded=True, early_exit=ee)
                    assert str(got.value) == str(e)
                    continue
                assert tops.resolve_fusion(fusion, (4, 64, 6, 8), sd,
                                           sharded=True,
                                           early_exit=ee) == want


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("sd", ["fp32", "bf16"])
def test_dma_model_stage_split_matches_reference(sd, fold):
    """The reference's stage-split traffic model, and its fold variant
    (``tests/test_kernels.py:243-265``)."""
    for (B, L, H, C, iters) in ((4, 128, 10, 16, 3), (100, 1152, 10, 16, 3),
                                (8, 2048, 62, 16, 2)):
        want = jops.dma_bytes_per_call(B, L, H, C, iters, form="stage_split",
                                       stream_dtype=sd, fold=fold)
        got = tops.dma_bytes_per_call(B, L, H, C, iters, form="stage_split",
                                      stream_dtype=sd, fold=fold)
        assert got == want
    B, L, H, C, iters = 4, 128, 10, 16, 3
    f = tops.dma_bytes_per_call(B, L, H, C, iters, form="stage_split",
                                fold=True)
    p = tops.dma_bytes_per_call(B, L, H, C, iters, form="stage_split")
    assert f["roundtrip_bytes"] == iters * (4 * L * H + 3 * B * H * C) * 4
    assert p["total_bytes"] - f["total_bytes"] == iters * 2 * L * H * 4
    it = tops.dma_bytes_per_call(B, L, H, C, iters, form="iteration")
    assert p["u_hat_stream_bytes"] == 2 * it["u_hat_stream_bytes"]
    with pytest.raises(ValueError, match="fold=True"):
        tops.dma_bytes_per_call(B, L, H, C, form="procedure", fold=True)
    with pytest.raises(ValueError, match="unknown form"):
        tops.dma_bytes_per_call(B, L, H, C, form="fused")


@pytest.mark.parametrize("sd", ["fp32", "bf16"])
@pytest.mark.parametrize("use_approx", [False, True])
def test_fused_sharded_without_axes_matches_reference(use_approx, sd):
    """With no sharded axis every collective is the identity and the fold
    path runs: the port's loop against the reference's, û cast once."""
    u, *_ = _inputs((2, 64, 6, 8), seed=7)
    want = jops.dynamic_routing_fused_sharded(
        jnp.asarray(u), axes={}, iterations=3, use_approx=use_approx,
        l_tile=16, stream_dtype=sd)
    got = tops.dynamic_routing_fused_sharded(
        torch.from_numpy(u), axes={}, iterations=3, use_approx=use_approx,
        l_tile=16, stream_dtype=sd)
    _close(got, want, FWD_ATOL[sd])
