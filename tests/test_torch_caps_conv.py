"""PyTorch port, the PrimaryCaps convolution kernel (``kernels/caps_conv``,
``csrc/caps_conv.cu``): its geometry, fragment maps, wrapper routes and
arithmetic on the CPU, and the kernel itself on the card.

On the CPU these tests

* hold ``caps_conv_geometry`` at every Table-1 caps conv and the smoke
  config's, at B = 1, 37 and 100, to the card's shared memory, and model
  its grid: every output element written once (the ragged last row block
  masked), every K term summed once across the split of K;
* model the kernel's loads and ``ldmatrix`` fragment maps (the 16-byte
  swizzle, the m16n8k8 TF32 A and B fragments) warp by warp, every
  element of a stage read where its product needs it and each ldmatrix
  phase on 32 distinct banks;
* hold the C entry's checks, as the source writes them, to accept the
  geometry the function gives and refuse any other, and the wrapper to
  pass that geometry to the library and count the launch (the library
  replaced by a recorder);
* hold the wrapper to its plain version on a CPU tensor and to raising
  on a shape the kernel does not take, and the encoder's entry point to
  the kernel with or without a gradient (its backward ``F.conv2d``'s bit
  for bit), to ``F.conv2d`` where the caller asks for the library, and a
  CapsNet training step to the library;
* model the kernel's arithmetic (split TF32, three products, sums of 32
  K terms added in fp32, the split's partial sums in order) at Caps-MN1's
  caps conv, B = 2, within 4x a plain fp32 convolution's error against
  float64, while one TF32 product fails the same check.

On the card (the ``card`` fixture skips without one; run with
``python -m pytest -q --noconftest tests/test_torch_caps_conv.py``, which
imports no JAX) the kernel is held to cuDNN's fp32 call at every Table-1
caps conv at B = 100, two launches give equal outputs, and the autograd
Function's gradients are ``F.conv2d``'s bit for bit under deterministic
cuDNN.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS, smoke_caps
from repro_torch.kernels import cudalib
from repro_torch.kernels.caps_conv import kernel as ck
from repro_torch.kernels.caps_conv import ops as cops
from repro_torch.kernels.caps_conv import ref as cref

CU = (cudalib._CSRC / "caps_conv.cu").read_text()
SMEM_OPT_IN = 232448
K_SIZE, STRIDE = 9, 2


def _shapes() -> dict:
    """(H_in, C_in, C_out) of each distinct caps conv: Table 1's and the
    smoke config's, named by the first config with it."""
    out = {}
    for name, cfg in [*CAPS_BENCHMARKS.items(), ("smoke", smoke_caps())]:
        key = (cfg.image_hw - 8, cfg.conv_channels,
               cfg.caps_channels * cfg.l_caps_dim)
        if key not in out.values():
            out[name] = key
    return out


SHAPES = _shapes()
BATCHES = (1, 37, 100)


def test_shapes_cover_table_1():
    """C_out 128, 256, 384 and 512 at H_in 20 and 24, C_in 256, and the
    smoke config's 64 → 64."""
    assert {(h, c) for h, c, _ in SHAPES.values()} == {(20, 256), (24, 256),
                                                       (20, 64)}
    assert {n for *_, n in SHAPES.values()} == {64, 128, 256, 384, 512}


def _geo(name: str, B: int):
    H, C, N = SHAPES[name]
    return ck.caps_conv_geometry(B, H, H, C, N, K_SIZE, STRIDE)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_geometry_fits_and_covers_once(name, B):
    H, C, N = SHAPES[name]
    g = _geo(name, B)
    ho = (H - K_SIZE) // STRIDE + 1
    assert (g.out_h, g.out_w) == (ho, ho)
    assert (g.m, g.n, g.k_terms) == (B * ho * ho, N, K_SIZE ** 2 * C)
    assert g.n_tiles == (8 if N % 128 == 0 else 4)
    assert g.block_n == 16 * g.n_tiles and N % g.block_n == 0
    assert g.smem_bytes == 4 * 4 * 32 * (128 + 2 * g.block_n) <= SMEM_OPT_IN
    stages = g.k_terms // 32
    assert g.splits * g.stages_per_split == stages
    assert g.stages_per_split >= ck.MIN_STAGES_PER_SPLIT
    assert g.grid == (-(-g.m // 128), N // g.block_n, g.splits)
    # every output element written once: the blocks' rows, masked past M,
    # by their columns
    written = np.zeros((g.grid[0] * 128, N), np.int64)
    for bx in range(g.grid[0]):
        for by in range(g.grid[1]):
            written[bx * 128:(bx + 1) * 128,
                    by * g.block_n:(by + 1) * g.block_n] += 1
    assert (written[:g.m] == 1).all()
    if B == 37:
        assert g.m % 128, "a ragged last row block"
    # every K term once across the split: split z sums stages
    # z·sps .. (z+1)·sps − 1, stage s the 32 terms from 32·s
    terms = np.zeros(g.k_terms, np.int64)
    for z in range(g.splits):
        for s in range(z * g.stages_per_split, (z + 1) * g.stages_per_split):
            terms[32 * s:32 * s + 32] += 1
    assert (terms == 1).all()


def test_geometry_splits_k_to_fill_the_card():
    """At Caps-MN1, B = 100, the 58 output tiles alone fill fewer than half
    of the 132 SMs: K is split nine ways (a kh row each), 522 blocks, 98.9 %
    of four waves.  At B = 100 every shape's blocks fill their waves to
    95 %; at every shape the blocks fill at least half the card where the
    split's floor of 8 stages allows it."""
    g = _geo("Caps-MN1", 100)
    assert g.grid == (29, 2, 9) and g.stages_per_split == 72
    assert {name: _geo(name, 100).splits for name in SHAPES} == {
        "Caps-MN1": 9, "Caps-CF1": 9, "Caps-CF2": 6, "Caps-CF3": 9,
        "Caps-SV1": 18, "smoke": 9}
    for name in SHAPES:
        g = _geo(name, 100)
        blocks = g.grid[0] * g.grid[1] * g.splits
        assert blocks / (-(-blocks // ck.SMS) * ck.SMS) >= ck.WAVE_FILL
    for name in SHAPES:
        for B in BATCHES:
            g = _geo(name, B)
            stages = g.k_terms // 32
            most = max(s for s in range(1, stages + 1)
                       if stages % s == 0 and stages // s >= 8)
            tiles = g.grid[0] * g.grid[1]
            assert tiles * g.splits >= min(66, tiles * most)


@pytest.mark.parametrize("args", [
    (2, 20, 20, 48, 256, 9, 2),      # C_in not a multiple of 32
    (2, 20, 20, 256, 96, 9, 2),      # C_out not a multiple of 64
    (2, 8, 8, 256, 256, 9, 2),       # kernel larger than the image
    (2, 40, 40, 32, 64, 17, 1),      # 289 taps
    (0, 20, 20, 256, 256, 9, 2)])
def test_geometry_refuses_other_shapes(args):
    with pytest.raises(ValueError, match="caps_conv"):
        ck.caps_conv_geometry(*args)


# ---------------------------------------------------------------------------
# the fragment maps, warp by warp
# ---------------------------------------------------------------------------

def _stage_smem(rows: int):
    """A stage tile of ``rows`` × 32 floats as the loader stores it: chunk
    c of row r at chunk c ^ (r & 7); values encode (row, col)."""
    tile = np.arange(rows * 32).reshape(rows, 32)
    smem = np.empty_like(tile)
    for tid in range(256):                 # lc = tid & 7, lr = tid >> 3
        lc, lr = tid & 7, tid >> 3
        for r in range(lr, rows, 32):
            place = 4 * (lc ^ (lr & 7))
            smem[r, place:place + 4] = tile[r, 4 * lc:4 * lc + 4]
    return tile, smem


def _ldsm_x4(smem, rows_of_lane, chunk_of_lane):
    """ldmatrix.x4 over fp32 data: lane L's register i is element L & 3
    of the 16 bytes that lane 8i + (L >> 2) addresses; also the banks of
    each of the four phases."""
    regs = np.empty((32, 4), np.int64)
    banks = []
    for i in range(4):
        phase = []
        for j in range(8):
            lane = 8 * i + j
            r, c = rows_of_lane[lane], chunk_of_lane[lane]
            phase += [(r * 32 + 4 * c + e) % 32 for e in range(4)]
        banks.append(phase)
        for L in range(32):
            lane = 8 * i + (L >> 2)
            r, c = rows_of_lane[lane], chunk_of_lane[lane]
            regs[L, i] = smem[r, 4 * c + (L & 3)]
    return regs, banks


@pytest.mark.parametrize("nt", (4, 8))
def test_fragment_maps_read_each_product_operand(nt):
    """Each warp's A fragments (rows wm·32 + 16·mi .. +15) and B fragments
    (n-tiles 2p, 2p+1 from wn·8·nt) of every k-step are the mma.m16n8k8
    TF32 layouts of the stage's rows and columns, every ldmatrix phase on
    32 distinct banks, and the warps' C fragments cover the block's
    128 × 16·nt outputs once."""
    bn = 16 * nt
    a_tile, a_smem = _stage_smem(128)
    b_tile, b_smem = _stage_smem(bn)
    covered = np.zeros((128, bn), np.int64)
    for warp in range(8):
        wm, wn = warp % 4, warp // 4
        lanes = np.arange(32)
        mat, sw = lanes >> 3, lanes & 7
        g, t = lanes >> 2, lanes & 3
        a_row = wm * 32 + sw + 8 * (mat & 1)
        b_row = wn * 8 * nt + 8 * (mat >> 1) + sw
        for ks in range(4):
            for mi in range(2):
                regs, banks = _ldsm_x4(a_smem, a_row + 16 * mi,
                                       (2 * ks + (mat >> 1)) ^ sw)
                r0 = wm * 32 + 16 * mi
                want = np.stack([a_tile[r0 + g, 8 * ks + t],
                                 a_tile[r0 + g + 8, 8 * ks + t],
                                 a_tile[r0 + g, 8 * ks + t + 4],
                                 a_tile[r0 + g + 8, 8 * ks + t + 4]], 1)
                np.testing.assert_array_equal(regs, want)
                assert all(len(set(p)) == 32 for p in banks)
            for p in range(nt // 2):
                regs, banks = _ldsm_x4(b_smem, b_row + 16 * p,
                                       (2 * ks + (mat & 1)) ^ sw)
                n0 = wn * 8 * nt + 16 * p
                want = np.stack([b_tile[n0 + g, 8 * ks + t],
                                 b_tile[n0 + g, 8 * ks + t + 4],
                                 b_tile[n0 + 8 + g, 8 * ks + t],
                                 b_tile[n0 + 8 + g, 8 * ks + t + 4]], 1)
                np.testing.assert_array_equal(regs, want)
                assert all(len(set(p)) == 32 for p in banks)
        for mi in range(2):
            for nj in range(nt):
                for h in range(2):
                    rows = wm * 32 + 16 * mi + g + 8 * h
                    cols = wn * 8 * nt + 8 * nj + 2 * t
                    np.add.at(covered, (rows, cols), 1)
                    np.add.at(covered, (rows, cols + 1), 1)
    assert (covered == 1).all()


def test_source_takes_the_model():
    """The source's loads, fragment addresses, stores and constants are the
    ones the models above follow, and it adds nothing atomically."""
    for line in (
            "constexpr int kThreads = 256;",
            "constexpr int kBM = 128;",
            "constexpr int kBK = 32;",
            "constexpr int kStages = 4;",
            f"constexpr int kMinStagesPerSplit = "
            f"{ck.MIN_STAGES_PER_SPLIT};",
            f"constexpr int kMaxTaps = {ck.MAX_TAPS};",
            "const int lc = tid & 7, lr = tid >> 3;",
            "const int lsw = 4 * (lc ^ (lr & 7));",
            "const int wm = warp % kWarpsM, wn = warp / kWarpsM;",
            "const int a_row = wm * 32 + sw + 8 * (mat & 1), "
            "a_half = mat >> 1;",
            "const int b_row = wn * 8 * NT + 8 * (mat >> 1) + sw, "
            "b_half = mat & 1;",
            "4 * ((2 * ks + a_half) ^ sw)",
            "4 * ((2 * ks + b_half) ^ sw)",
            "const int row = m0 + wm * 32 + 16 * mi + g + 8 * h;",
            "const int col = n0 + wn * 8 * NT + 8 * nj + 2 * t;",
            "const int g0 = blockIdx.z * sps;",
            "const size_t boff = (size_t)stage * kBK;"):
        assert line in CU, line
    assert "atomicAdd" not in CU and "atom." not in CU


def _entry_accepts(B, H, W, Cin, Cout, k, stride, nt, splits, smem) -> bool:
    """caps_conv_forward's checks of its arguments, as the source writes
    them (test_entry_checks_are_the_sources' holds the text)."""
    if (B < 1 or k < 1 or k * k > 256 or stride < 1 or H < k or W < k
            or Cin < 32 or Cin % 32 != 0 or Cout < 64 or Cout % 64 != 0
            or nt != (8 if Cout % 128 == 0 else 4) or splits < 1):
        return False
    stages = k * k * Cin // 32
    return (stages % splits == 0 and stages // splits >= 8
            and smem == 4 * 4 * 32 * (128 + 2 * 16 * nt))


def test_entry_checks_are_the_sources():
    for cond in (
            "if (B < 1 || k < 1 || k * k > kMaxTaps || stride < 1 || H < k "
            "|| W < k ||\n      Cin < kBK || Cin % kBK != 0 || Cout < 64 || "
            "Cout % 64 != 0 ||\n      nt != (Cout % 128 == 0 ? 8 : 4) || "
            "splits < 1)",
            "if (stages % splits != 0 || stages / splits < "
            "kMinStagesPerSplit ||\n      smem < 0 || (size_t)smem != "
            "conv_smem(nt))"):
        assert cond in CU, cond


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_entry_refuses_a_geometry_other_than_the_functions(name, B):
    H, C, N = SHAPES[name]
    g = _geo(name, B)
    args = (B, H, H, C, N, K_SIZE, STRIDE)
    assert _entry_accepts(*args, g.n_tiles, g.splits, g.smem_bytes)
    other_nt = 12 - g.n_tiles
    stages = g.k_terms // 32
    assert not _entry_accepts(*args, other_nt, g.splits, g.smem_bytes)
    assert not _entry_accepts(*args, other_nt, g.splits,
                              4 * 4 * 32 * (128 + 32 * other_nt))
    assert not _entry_accepts(*args, g.n_tiles, g.splits, g.smem_bytes + 16)
    assert not _entry_accepts(*args, g.n_tiles, stages, g.smem_bytes)
    assert not _entry_accepts(*args, g.n_tiles, 7, g.smem_bytes)
    assert not _entry_accepts(*args, g.n_tiles, 0, g.smem_bytes)


# ---------------------------------------------------------------------------
# the wrapper's routes
# ---------------------------------------------------------------------------

def _inputs(B, H, C, N, seed=0, bias=True):
    gen = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(B, H, H, C, generator=gen))
    w = torch.randn(N, C, K_SIZE, K_SIZE, generator=gen) / (
        K_SIZE * np.sqrt(C))
    b = (0.1 * torch.randn(N, generator=gen) if bias else torch.zeros(N))
    return x, w, b


def test_wrapper_runs_the_plain_version_on_the_cpu():
    x, w, b = _inputs(3, 20, 64, 64)
    before = ck.caps_conv.launches
    out = ck.caps_conv(x, w, b, STRIDE)
    want = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=STRIDE)
    assert torch.equal(out, want.permute(0, 2, 3, 1))
    assert torch.equal(out, ck.caps_conv_plain(x, w, b, STRIDE))
    assert ck.caps_conv.launches == before
    # the plain version takes any shape, as F.conv2d does
    x, w, b = _inputs(1, 12, 3, 5)
    assert ck.caps_conv(x, w, b, 1).shape == (1, 4, 4, 5)


def test_wrapper_refuses_grad():
    x, w, b = _inputs(1, 20, 64, 64)
    with pytest.raises(RuntimeError, match="forward-only"):
        ck.caps_conv(x, w.requires_grad_(), b, STRIDE)


@pytest.mark.parametrize("needs_grad", ["x", "w", "b"])
def test_entry_trains_on_conv2d_bitwise(needs_grad, kernel_route):
    """With a gradient recorded the entry point launches the kernel and its
    backward is F.conv2d's, bit for bit; asked for the library it is
    F.conv2d, values and gradients bit for bit, and launches nothing."""
    x, w, b = _inputs(2, 20, 64, 64)
    ins = {"x": x, "w": w, "b": b}
    ins[needs_grad].requires_grad_()
    y2 = F.conv2d(ins["x"].permute(0, 3, 1, 2), ins["w"], ins["b"],
                  stride=STRIDE).permute(0, 2, 3, 1)
    g = torch.randn(y2.shape, generator=torch.Generator().manual_seed(3))
    (want,) = torch.autograd.grad(y2, (ins[needs_grad],), g)
    y = cops.caps_conv(ins["x"], ins["w"], ins["b"], STRIDE)
    assert len(kernel_route.calls) == 1 and y.grad_fn is not None
    (got,) = torch.autograd.grad(y, (ins[needs_grad],), g)
    assert torch.equal(got, want)
    y = cops.caps_conv(ins["x"], ins["w"], ins["b"], STRIDE, "library")
    assert torch.equal(y, y2)
    (got,) = torch.autograd.grad(y, (ins[needs_grad],), g)
    assert torch.equal(got, want)
    assert len(kernel_route.calls) == 1


def test_entry_serves_on_the_kernel(kernel_route):
    """Without a gradient (no_grad, inference_mode, or inputs that need
    none) the entry point launches the kernel."""
    x, w, b = _inputs(2, 20, 64, 64)
    w.requires_grad_()
    with torch.no_grad():
        cops.caps_conv(x, w, b, STRIDE)
    with torch.inference_mode():
        cops.caps_conv(x, w.detach(), b, STRIDE)
    cops.caps_conv(x, w.detach(), b, STRIDE)
    assert len(kernel_route.calls) == 3
    with pytest.raises(ValueError, match="impl"):
        cops.caps_conv(x, w, b, STRIDE, "cudnn")


def test_train_step_takes_the_library(kernel_route):
    """A CapsNet training step (and the training CLI's loop) runs the caps
    conv on the library (``train_loop.TRAIN_CAPS_CONV``); the serving
    encoder on the kernel."""
    from repro_torch.models import capsnet
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import train_loop
    assert train_loop.TRAIN_CAPS_CONV == "library"
    cfg = smoke_caps()
    net = capsnet.CapsNet(cfg, device="cpu", seed=0)
    images = torch.rand(2, cfg.image_hw, cfg.image_hw, cfg.image_channels)
    labels = torch.tensor([1, 3], dtype=torch.int32)
    step = train_loop.make_capsnet_train_step(cfg, device="cpu")
    opt = adamw_init(dict(net.named_parameters()))
    step(net, opt, images, labels)
    assert kernel_route.calls == []
    with torch.inference_mode():
        capsnet.encode_votes(net, images)
    assert len(kernel_route.calls) == 1


class _Recorder:
    """A stand-in library: records caps_conv_forward's arguments."""

    def __init__(self):
        self.calls = []

    def caps_conv_forward(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def kernel_route(monkeypatch):
    """The wrapper's kernel route on CPU tensors: plain_mode answers False
    and the library is a recorder."""
    rec = _Recorder()
    monkeypatch.setattr(ck, "plain_mode", lambda t: False)
    monkeypatch.setattr(cops, "plain_mode", lambda t: False)
    monkeypatch.setattr(cudalib, "build", lambda: rec)
    monkeypatch.setattr(cudalib, "stream", lambda device: 0)
    return rec


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_wrapper_launches_at_the_functions_geometry(name, kernel_route):
    H, C, N = SHAPES[name]
    x, w, b = _inputs(2, H, C, N)
    before = ck.caps_conv.launches
    out = ck.caps_conv(x, w, b, STRIDE)
    assert ck.caps_conv.launches == before + 1
    g = ck.caps_conv_geometry(2, H, H, C, N, K_SIZE, STRIDE)
    (args,) = kernel_route.calls
    assert args[6:16] == (2, H, H, C, N, K_SIZE, STRIDE, g.n_tiles,
                          g.splits, g.smem_bytes)
    assert args[0] == x.data_ptr() and args[5] == out.data_ptr()
    assert (args[4] is None) == (g.splits == 1)
    assert out.shape == (2, g.out_h, g.out_w, N) and out.is_contiguous()


@pytest.mark.parametrize("bad", ["c_in", "dtype", "layout", "kernel"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad, kernel_route):
    x, w, b = _inputs(2, 20, 64, 64)
    if bad == "c_in":
        x, w, b = _inputs(2, 20, 48, 64)
    elif bad == "dtype":
        x = x.double()
    elif bad == "layout":
        x = x.permute(0, 2, 1, 3)
    else:
        w = w[:, :, :7, :7].contiguous()
        x = x[:, :6, :6]
    with pytest.raises(ValueError, match="caps_conv"):
        ck.caps_conv(x, w, b, STRIDE)
    assert kernel_route.calls == []


def test_fake_route_allocates_and_reports():
    """On fake tensors (the dry run's) the wrapper launches nothing, returns
    the kernel's output shape and reports its operations and bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import kernels

    class Seen:
        def __init__(self):
            self.calls = []

        def kernel(self, name, flops, bytes_moved):
            self.calls.append((name, flops, bytes_moved))

    seen = Seen()
    kernels.ANALYSES.append(seen)
    try:
        with FakeTensorMode():
            x = torch.empty(100, 20, 20, 256)
            w = torch.empty(256, 256, 9, 9)
            b = torch.empty(256)
            before = ck.caps_conv.launches
            out = ck.caps_conv(x, w, b, STRIDE)
    finally:
        kernels.ANALYSES.remove(seen)
    assert out.shape == (100, 6, 6, 256)
    assert ck.caps_conv.launches == before
    assert seen.calls == [("caps_conv", 2.0 * 3600 * 256 * 20736,
                           4.0 * (100 * 400 * 256 + 256 * 20736 + 256
                                  + 3600 * 256))]


# ---------------------------------------------------------------------------
# the arithmetic: split TF32 summed in stages of 32, against float64
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 to nearest, ties away from zero, as
    flash_tc.cuh's split_tf32 rounds (the tensor cores read the upper 19
    bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (M, K) with K ordered (kh, kw, c), the kernel's."""
    B, H, W, C = x.shape
    ho, wo = (H - k) // stride + 1, (W - k) // stride + 1
    cols = torch.empty(B, ho, wo, k, k, C)
    for kh in range(k):
        for kw in range(k):
            cols[:, :, :, kh, kw] = x[:, kh:kh + stride * (ho - 1) + 1:stride,
                                      kw:kw + stride * (wo - 1) + 1:stride]
    return cols.reshape(B * ho * wo, k * k * C)


def _model(x, w, b, split: bool) -> torch.Tensor:
    """The kernel's arithmetic in torch: A and B in big and small TF32
    parts (or big alone), each stage of 32 K terms a fresh fp32 sum of its
    products, the stages of a split added in order in fp32, the splits'
    partial sums in order, then the bias."""
    B, H, _, C = x.shape
    N = w.shape[0]
    g = ck.caps_conv_geometry(B, H, H, C, N, K_SIZE, STRIDE)
    a = _im2col(x, K_SIZE, STRIDE)
    wk = w.permute(0, 2, 3, 1).reshape(N, -1)
    stages = g.k_terms // 32
    a3 = a.reshape(g.m, stages, 32).transpose(0, 1)        # (S, M, 32)
    w3 = wk.reshape(N, stages, 32).permute(1, 2, 0)       # (S, 32, N)
    ab, wb = _tf32(a3), _tf32(w3)
    if split:
        as_, ws = _tf32(a3 - ab), _tf32(w3 - wb)
        parts = (torch.bmm(as_, wb) + torch.bmm(ab, ws)) + torch.bmm(ab, wb)
    else:
        parts = torch.bmm(ab, wb)
    out = None
    for z in range(g.splits):
        acc = torch.zeros(g.m, N)
        for s in range(z * g.stages_per_split, (z + 1) * g.stages_per_split):
            acc = acc + parts[s]
        out = acc if out is None else out + acc
    return (out + b).reshape(B, g.out_h, g.out_w, N)


def _rel_err(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def test_split_tf32_model_keeps_fp32_error():
    """At Caps-MN1's caps conv, B = 2: the model's largest error against
    float64 within 4x that of a plain fp32 convolution; one TF32 product,
    summed the same way, outside it."""
    H, C, N = SHAPES["Caps-MN1"]
    x, w, b = _inputs(2, H, C, N, seed=5)
    want = cref.caps_conv_ref(x, w, b, STRIDE)
    plain = _rel_err(ck.caps_conv_plain(x, w, b, STRIDE), want)
    split = _rel_err(_model(x, w, b, split=True), want)
    single = _rel_err(_model(x, w, b, split=False), want)
    assert split <= 4 * plain, (split, plain)
    assert single > 4 * plain, (single, plain)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """The card, with cuDNN and matmul in fp32 (TF32 off) and cuDNN's
    algorithms deterministic, for this test alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel launches only on a CUDA "
                    "tensor")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_kernel_against_cudnn(name, card):
    H, C, N = SHAPES[name]
    x, w, b = (t.to(card) for t in _inputs(100, H, C, N, seed=7))
    want = cref.caps_conv_ref(x, w, b, STRIDE)
    before = ck.caps_conv.launches
    with torch.no_grad():
        out = ck.caps_conv(x, w, b, STRIDE)
        out2 = ck.caps_conv(x, w, b, STRIDE)
        lib = ck.caps_conv_plain(x, w, b, STRIDE)
    assert ck.caps_conv.launches == before + 2
    assert torch.equal(out, out2)
    err = float((out.double() - want).abs().max())
    lib_err = float((lib.double() - want).abs().max())
    assert err <= 4 * lib_err, (err, lib_err)
    assert float((out - lib).abs().max()) <= 1e-5 * max(
        1.0, float(lib.abs().max()))
    # training through the autograd Function: the kernel's forward, and
    # F.conv2d's gradients bit for bit for the same upstream gradient
    ins = [t.clone().requires_grad_() for t in (x, w, b)]
    y = cops.caps_conv(*ins, STRIDE)
    assert ck.caps_conv.launches == before + 3
    assert torch.equal(y, out)
    g = torch.randn(y.shape, device=card,
                    generator=torch.Generator(card).manual_seed(3))
    got = torch.autograd.grad(y, ins, g)
    want = torch.autograd.grad(ck.caps_conv_plain(*ins, STRIDE), ins, g)
    for a, e in zip(got, want):
        assert torch.equal(a, e)


def test_encoder_hands_the_kernel_a_contiguous_activation(card):
    """conv1 and its ReLU leave the activation NHWC contiguous on the card,
    so the kernel reads it without a copy."""
    from repro_torch.core import capsule_layers as CL
    cfg = CAPS_BENCHMARKS["Caps-MN1"]
    pc = CL.PrimaryCaps(cfg.image_channels, CL.PrimaryCapsConfig(),
                        device=card)
    images = torch.rand(8, 28, 28, 1, device=card)
    with torch.no_grad():
        h = F.relu(CL.conv2d(images, pc.conv1.w, pc.conv1.b))
        before = ck.caps_conv.launches
        u = CL.primary_caps_forward(pc, images, CL.PrimaryCapsConfig())
    assert h.is_contiguous()
    assert ck.caps_conv.launches == before + 1
    assert u.shape == (8, 1152, 8)


def test_the_kernel_source_note():
    """The source says which TPU kernel it replaces (none), what bounds it
    and what its design does about it."""
    head = CU.split("#include", 1)[0]
    assert "Replaces no TPU kernel" in head
    assert "What bounds it: operations." in head
    assert "What the design does about it" in head
    assert re.search(r"mma\.sync and not wgmma", head)
