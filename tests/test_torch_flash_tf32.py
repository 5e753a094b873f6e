"""PyTorch port, the fp32 flash-attention kernels' split-TF32 arithmetic and
fragment maps, on the CPU.

Up to D = 256 the fp32 kernels (``csrc/flash_attention.cu::
flash_fwd_f32_kernel``, ``csrc/flash_attention_bwd.cu::
flash_bwd_dq_f32_kernel`` and ``flash_bwd_dkv_f32_kernel``) run every
product on the tensor cores in split TF32 (``csrc/flash_tc.cuh``): an fp32
operand x becomes big = x rounded to TF32 (10 mantissa bits, to nearest,
ties away from zero) and small = x − big rounded the same way, and a·b runs
as a_big·b_small + a_small·b_big + a_big·b_big, each product of TF32
values exact in fp32 and summed in fp32.  These tests

* model that arithmetic in torch (the products of the plain versions
  replaced by the model) and hold the model's o, lse, dq, dk and dv to
  ``chip_smoke.py``'s fp32 gate against the plain versions, 1e-5·max(1,
  max|plain|), at D = 64, 128 and 256, causal, windowed and with Sk ≠ Sq,
  while one TF32 product (a_big·b_big alone) fails it; the causal
  forward's model also within that gate of the JAX package's dense oracle
  ``mha_ref``;
* model the kernels' fragment maps (``mma.sync.m16n8k8`` with tf32
  operands, the key and column relabellings, the 16-byte stores) warp by
  warp and hold them to the products they stand for, every row, key and
  column once, at every head dim of ``HEAD_DIMS``, and their shared-memory
  loads to 32 distinct banks;
* hold ``kernel.f32_geometry`` to the card's shared memory and to the
  numbers the sources assert.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels import cudalib
from repro_torch.kernels.flash_attention import kernel as fk

TOL = 1e-5                    # chip_smoke.TOL: the fp32 kernels' gate
HEAD_DIMS = fk.HEAD_DIMS
# (B, Hq, Hkv, Sq, Sk, causal, window): causal, windowed, cross attention
MODEL_CASES = {"causal": (1, 4, 2, 80, 80, True, None),
               "window": (1, 4, 2, 96, 96, True, 24),
               "cross": (1, 4, 2, 40, 72, False, None)}


# ---------------------------------------------------------------------------
# the arithmetic: split TF32 against the plain fp32 versions
# ---------------------------------------------------------------------------

def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: half of the 13 dropped bits' range added to the bit pattern,
    then cleared (the kernels' ``split_tf32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple:
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def split_matmul(matmul):
    """A model of an fp32 product in split TF32: the three products of
    TF32 parts, each exact in fp32, summed in fp32."""
    def product(a, b):
        (ab, as_), (bb, bs) = split(a.float()), split(b.float())
        return matmul(ab, bs) + matmul(as_, bb) + matmul(ab, bb)
    return product


def single_matmul(matmul):
    """One TF32 product: both operands rounded to TF32."""
    def product(a, b):
        return matmul(tf32_rna(a.float()), tf32_rna(b.float()))
    return product


def _inputs(B, Hq, Hkv, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                           (B, Hq, Sq, D)))


def _run(case, D, product=None, monkeypatch=None):
    """o, lse, dq, dk, dv of the plain versions, their products replaced
    by ``product(torch.matmul)`` where given."""
    B, Hq, Hkv, Sq, Sk, causal, window = case
    q, k, v, do = _inputs(B, Hq, Hkv, Sq, Sk, D, seed=D + Sq)
    if product is not None:
        monkeypatch.setattr(torch, "matmul", product(torch.matmul))
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    o, lse = fk.flash_attention_fwd_lse_plain(q, k, v, **kw)
    # the backward of the reference forward's o and lse, as the kernels
    # are called in training
    if product is not None:
        monkeypatch.undo()
    o_ref, lse_ref = fk.flash_attention_fwd_lse_plain(q, k, v, **kw)
    if product is not None:
        monkeypatch.setattr(torch, "matmul", product(torch.matmul))
    grads = fk.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, **kw)
    if product is not None:
        monkeypatch.undo()
    return {"o": o, "lse": lse, "dq": grads[0], "dk": grads[1],
            "dv": grads[2]}


def _excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|Δ| over ``chip_smoke.lm_close``'s fp32 gate (≤ 0 passes)."""
    gate = TOL * max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) - gate


@pytest.mark.parametrize("D", (64, 128, 256))
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_split_tf32_model_passes_the_fp32_gate(name, D, monkeypatch):
    case = MODEL_CASES[name]
    plain = _run(case, D)
    model = _run(case, D, split_matmul, monkeypatch)
    assert not torch.equal(model["o"], plain["o"])    # the model ran
    for out in plain:
        assert _excess(model[out], plain[out]) <= 0.0, out


@pytest.mark.parametrize("D", (64, 128, 256))
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_single_tf32_model_fails_the_fp32_gate(name, D, monkeypatch):
    """One TF32 product keeps 11 significant bits of each operand: o, dq,
    dk and dv land over the gate."""
    case = MODEL_CASES[name]
    plain = _run(case, D)
    model = _run(case, D, single_matmul, monkeypatch)
    for out in ("o", "dq", "dk", "dv"):
        assert _excess(model[out], plain[out]) > 0.0, out


@pytest.mark.parametrize("D", (64, 128, 256))
def test_split_tf32_forward_within_the_gate_of_the_reference_oracle(
        D, monkeypatch):
    B, Hq, Hkv, Sq, _, causal, _ = MODEL_CASES["causal"]
    q, k, v, _ = _inputs(B, Hq, Hkv, Sq, Sq, D, seed=D + Sq)
    monkeypatch.setattr(torch, "matmul", split_matmul(torch.matmul))
    o = fk.flash_attention_plain(q, k, v, causal=causal, block_q=64,
                                 block_k=64)
    monkeypatch.undo()
    want = torch.from_numpy(np.array(jfa_ref.mha_ref(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal)))
    assert _excess(o, want) <= 0.0


def test_tf32_rounding_is_to_nearest_ties_away_from_zero():
    one = 1.0 + 2.0 ** -10                   # a TF32 neighbour of 1
    x = torch.tensor([1.0 + 2.0 ** -11,      # the tie: up, away from 0
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23,   # below: down
                      one + 2.0 ** -11,      # a tie above an odd last bit
                      3.0], dtype=torch.float32)
    got = tf32_rna(x).tolist()
    assert got == [one, -one, 1.0, 1.0 + 2.0 ** -9, 3.0]
    big, small = split(torch.tensor([np.float32(np.pi)]))
    assert float(big + small) == pytest.approx(np.pi, rel=2.0 ** -22)


# ---------------------------------------------------------------------------
# the fragment maps, warp by warp
# ---------------------------------------------------------------------------

LANES = [(lane >> 2, lane & 3) for lane in range(32)]   # (g, t)


def mma_m16n8k8(a, b, c):
    """``mma.sync.m16n8k8.row.col`` with tf32 operands on a warp's
    registers: a [32][4], b [32][2], c [32][4] (float64 here: the maps,
    not the rounding, are under test)."""
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    for lane, (g, t) in enumerate(LANES):
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        B[t, g], B[t + 4, g] = b[lane]
    C = _c_matrix(c) + A @ B
    return [[C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
             C[g + 8, 2 * t + 1]] for g, t in LANES]


def _c_matrix(c) -> np.ndarray:
    C = np.zeros((16, 8))
    for lane, (g, t) in enumerate(LANES):
        C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1] = \
            c[lane]
    return C


def lda(tile, r, c):
    """``lda_f32``: A (k = head dim) of rows r.., cols c.. of a tile."""
    return [[tile[r + g, c + t], tile[r + g + 8, c + t],
             tile[r + g, c + t + 4], tile[r + g + 8, c + t + 4]]
            for g, t in LANES]


def ldb(tile, n, c):
    """``ldb_f32``: B (k = head dim) of rows n..n+7 as its n."""
    return [[tile[n + g, c + t], tile[n + g, c + t + 4]] for g, t in LANES]


def ldb_pair(tile, k0, c0):
    """``ldb_pair_f32``: B (k = rows) of n-tiles 2j, 2j+1 from two 8-byte
    loads a lane, rows k0 + 2t and k0 + 2t + 1 at columns c0 + 2g, + 1."""
    lo = [[tile[k0 + 2 * t, c0 + 2 * g], tile[k0 + 2 * t + 1, c0 + 2 * g]]
          for g, t in LANES]
    hi = [[tile[k0 + 2 * t, c0 + 2 * g + 1],
           tile[k0 + 2 * t + 1, c0 + 2 * g + 1]] for g, t in LANES]
    return lo, hi


def a_from_c(c):
    """``a_from_c_f32``: the A fragment of an 8-key step from the scores'
    C fragment (c0, c2, c1, c3)."""
    return [[x[0], x[2], x[1], x[3]] for x in c]


def warp_scores(x, y, D):
    """x (16, D) against y (n, D), n a multiple of 8: the score product of
    the kernels' k-steps over the head dim; returns the C fragments of
    each 8-column n-tile."""
    acc = [[[0.0] * 4 for _ in range(32)] for _ in range(y.shape[0] // 8)]
    for kk in range(D // 8):
        a = lda(x, 0, 8 * kk)
        for n in range(len(acc)):
            acc[n] = mma_m16n8k8(a, ldb(y, 8 * n, 8 * kk), acc[n])
    return acc


def warp_accumulate(s, z, D):
    """The accumulating product of the kernels (P·V, dS·K, Pᵀ·dO, dSᵀ·Q):
    the scores' C fragments ``s`` (one a 8-key n-tile) as A, z (keys, D)
    as B through the pair loads; returns what each lane stores, as
    {(row, column): value} with a count of writes."""
    acc = [[[0.0] * 4 for _ in range(32)] for _ in range(D // 8)]
    for kk in range(len(s)):
        a = a_from_c(s[kk])
        for dp in range(D // 16):
            lo, hi = ldb_pair(z, 8 * kk, 16 * dp)
            acc[2 * dp] = mma_m16n8k8(a, lo, acc[2 * dp])
            acc[2 * dp + 1] = mma_m16n8k8(a, hi, acc[2 * dp + 1])
    out, writes = np.zeros((16, D)), np.zeros((16, D), np.int64)
    for lane, (g, t) in enumerate(LANES):
        for r in range(2):
            for dp in range(D // 16):
                col = 16 * dp + 4 * t        # one 16-byte store
                vals = (acc[2 * dp][lane][2 * r], acc[2 * dp + 1][lane][2 * r],
                        acc[2 * dp][lane][2 * r + 1],
                        acc[2 * dp + 1][lane][2 * r + 1])
                out[g + 8 * r, col:col + 4] = vals
                writes[g + 8 * r, col:col + 4] += 1
    return out, writes


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_score_fragments_cover_each_row_key_and_column_once(D):
    """The score product's fragments (q·kᵀ, dO·vᵀ, k·qᵀ, v·dOᵀ) at head
    dim D: integer inputs, so any element read twice, missed or misplaced
    shows; the C fragment of n-tile n holds keys 8n + 2t, 8n + 2t + 1."""
    rng = np.random.default_rng(D)
    x = rng.integers(-4, 5, (16, D)).astype(float)
    y = rng.integers(-4, 5, (32, D)).astype(float)
    acc = warp_scores(x, y, D)
    s = np.concatenate([_c_matrix(c) for c in acc], axis=1)
    np.testing.assert_array_equal(s, x @ y.T)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_accumulating_fragments_cover_each_key_and_column_once(D):
    """The accumulating products at head dim D: the key relabelling turns
    the scores' C fragments into A with no shuffle, the column
    relabelling gives each lane 16-byte runs, and every (row, column) of
    the output is written once with the product's value."""
    rng = np.random.default_rng(D + 1)
    x = rng.integers(-3, 4, (16, D)).astype(float)
    y = rng.integers(-3, 4, (32, D)).astype(float)
    z = rng.integers(-3, 4, (32, D)).astype(float)
    s = warp_scores(x, y, D)
    out, writes = warp_accumulate(s, z, D)
    np.testing.assert_array_equal(writes, np.ones((16, D), np.int64))
    np.testing.assert_array_equal(out, (x @ y.T) @ z)


def _banks(words) -> list:
    return [w % 32 for w in words]


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_fragment_loads_are_free_of_bank_conflicts(D):
    """Rows of D + 4 floats: a 4-byte A or B load (rows g, g + 8 at
    columns t, t + 4) puts the warp's 32 lanes in 32 banks; an 8-byte pair
    load (rows 2t and 2t + 1 at columns 2g, 2g + 1) puts each half-warp's
    16 lanes' 32 words in 32 banks, at every column offset of a step."""
    LD = D + 4
    assert (LD * 4) % 16 == 0                  # rows 16-byte aligned
    for r0, c0 in ((0, 0), (8, 0), (0, 4), (0, D - 8)):
        words = [(r0 + g) * LD + c0 + t for g, t in LANES]
        assert len(set(_banks(words))) == 32
    for k0 in (0, 8, 16):
        for c0 in range(0, D, 16):
            for half in (LANES[:16], LANES[16:]):
                for row in (0, 1):
                    words = [(k0 + 2 * t + row) * LD + c0 + 2 * g + e
                             for g, t in half for e in (0, 1)]
                    assert len(set(_banks(words))) == 32


# ---------------------------------------------------------------------------
# the geometry
# ---------------------------------------------------------------------------

FLASH_CU = (cudalib._CSRC / "flash_attention.cu").read_text()
FLASH_BWD_CU = (cudalib._CSRC / "flash_attention_bwd.cu").read_text()
FLASH_TC = (cudalib._CSRC / "flash_tc.cuh").read_text()


@pytest.mark.parametrize("kind", ("fwd", "dq", "dkv"))
def test_f32_geometry_fits_a_block_and_tiles_its_rows(kind):
    for D in HEAD_DIMS:
        geo = fk.f32_geometry(kind, D)
        assert geo.smem_bytes <= fk.SMEM_OPT_IN
        assert geo.rows == 16 * geo.warps and geo.rows % geo.step == 0
        assert geo.step in (16, 32, 64) and geo.warps in (4, 8)
        # a larger step would not fit, or pass the dk/dv kernel's cap
        cap = fk.F32_DKV_STEP_CAP if kind == "dkv" else 64
        if geo.step < cap:
            res, stats = {"fwd": (1, 0), "dq": (2, 0), "dkv": (2, 2)}[kind]
            assert fk._f32_tile_smem(D, res, geo.warps, 2 * geo.step,
                                     stats) > fk.SMEM_OPT_IN
        assert (D // geo.splits) % 16 == 0


def test_f32_geometry_matches_the_sources():
    """The numbers the sources' static_asserts pin, from the model."""
    fwd = {D: fk.f32_geometry("fwd", D) for D in HEAD_DIMS}
    dq = {D: fk.f32_geometry("dq", D) for D in HEAD_DIMS}
    dkv = {D: fk.f32_geometry("dkv", D) for D in HEAD_DIMS}
    assert (f"fwd_warps<256>() == {fwd[256].warps}" in FLASH_CU and
            f"fwd_step<128>() == {fwd[128].step}" in FLASH_CU and
            f"fwd_step<160>() == {fwd[160].step}" in FLASH_CU and
            f"fwd_step<256>() == {fwd[256].step}" in FLASH_CU and
            f"fwd_f32_smem<128>() == {fwd[128].smem_bytes}" in FLASH_CU and
            f"fwd_f32_smem<256>() == {fwd[256].smem_bytes}" in FLASH_CU)
    assert (f"dq_warps<128>() == {dq[128].warps}" in FLASH_BWD_CU and
            f"dq_step<128>() == {dq[128].step}" in FLASH_BWD_CU and
            f"dq_step<160>() == {dq[160].step}" in FLASH_BWD_CU and
            f"dq_warps<256>() == {dq[256].warps}" in FLASH_BWD_CU and
            f"dq_step<256>() == {dq[256].step}" in FLASH_BWD_CU and
            f"dq_f32_smem<128>() == {dq[128].smem_bytes}" in FLASH_BWD_CU and
            f"dkv_f32_smem<128>() == {dkv[128].smem_bytes}" in FLASH_BWD_CU
            and f"dkv_f32_smem<256>() == {dkv[256].smem_bytes}"
            in FLASH_BWD_CU)
    assert f"return D > {fk.F32_DKV_SPLIT_ABOVE} ? 2 : 1;" in FLASH_BWD_CU
    cap = fk.F32_DKV_STEP_CAP
    assert (f"return tc::f32_step<D>(2, 2) < {cap} ? tc::f32_step<D>(2, 2) "
            f": {cap};") in FLASH_BWD_CU
    assert f"constexpr size_t kSmemOptIn = {fk.SMEM_OPT_IN};" in FLASH_TC
    assert "return D + 4;" in FLASH_TC                 # ld_f32


def test_retired_cuda_core_kernels_are_gone():
    """No fp32 CUDA-core product kernel at D ≤ 256 remains: the fp32 paths
    launch only the split-TF32 kernels."""
    for src in (FLASH_CU, FLASH_BWD_CU):
        assert not re.search(r"\bflash_fwd_kernel\b|\bflash_bwd_dq_kernel\b|"
                             r"\bflash_bwd_dkv_kernel\b|\bacc_col\b|"
                             r"\bkLean\b|\bouter4\b", src)
        assert "mma3(" in src and "launch_f32_dim(" in src
