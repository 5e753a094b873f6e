"""Launch geometry of the routing tile kernel, the EM E-step and the
selective scan, in plain Python on the CPU.

The routing wrappers cut each reference tile (``l_tile``: int8 scale rows,
early-exit flags, the work counter) into smaller row groups and split B
over a thread-block cluster (``ops.tile_geometry``), and the backward's
reverse sweep runs on the same geometry; the E-step gives a lane one (row,
h) and a warp an even share of the rows (``ops.estep_geometry``); the scan
splits each channel's states over a group of lanes
(``ssm_scan.kernel.scan_geometry``).  These tests hold each to the card's
limits at every shape the serving and training paths hand them, and check
that the routing and E-step wrappers allocate their scratch and pass the
geometry the kernel is launched with (the library is replaced by a
recorder; no card is needed).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS
from repro_torch.kernels import cudalib
from repro_torch.kernels.routing import kernel, ops
from repro_torch.kernels.ssm_scan import kernel as scan_kernel

SHAPES = ("Caps-MN1", "Caps-EN3", "Caps-CF3", "Caps-SV3")
BATCHES = (1, 8, 100)
STREAMS = ("fp32", "bf16", "int8")
TILE_STATIC_SMEM = 2176    # routing.cu's static shared memory, rounded up


def _dims(name: str) -> tuple:
    cfg = CAPS_BENCHMARKS[name]
    return (cfg.num_l_caps, cfg.num_h_caps, cfg.h_caps_dim,
            cfg.routing_iters)


def _wrapper_l_tiles(B: int, L: int, H: int, C: int, iters: int,
                     sd: str) -> list:
    """Every l_tile a wrapper picks: the procedure with and without early
    exit, and for fp32/bf16 the training procedure and the iteration."""
    tiles = {ops.procedure_l_tile(B, L, H, C, sd),
             ops.procedure_l_tile(B, L, H, C, sd, early_exit=True)}
    if sd != "int8":
        tiles |= {ops.procedure_train_l_tile(B, L, H, C, iters, sd),
                  ops.auto_l_tile(B, L, H, C, sd)}
    return sorted(tiles)


@pytest.mark.parametrize("sd", STREAMS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("name", SHAPES)
def test_routing_tile_geometry_fits_the_card(name, B, sd):
    L, H, C, iters = _dims(name)
    item = {"fp32": 4, "bf16": 2, "int8": 1}[sd]
    for l_tile in _wrapper_l_tiles(B, L, H, C, iters, sd):
        geo = ops.tile_geometry(B, L, H, C, l_tile, sd)
        # row groups never straddle a reference tile; a row a thread at most
        assert l_tile % geo.rows == 0 and geo.rows <= ops.TILE_THREADS
        assert geo.groups * geo.rows == L
        starts = np.arange(geo.groups) * geo.rows
        assert np.array_equal(starts // l_tile,
                              (starts + geo.rows - 1) // l_tile)
        # the cluster's batch chunks cover B exactly, none empty
        assert 1 <= geo.cluster <= ops.MAX_CLUSTER
        chunks = [range(q * geo.batch_chunk,
                        min(B, (q + 1) * geo.batch_chunk))
                  for q in range(geo.cluster)]
        assert all(len(c) > 0 for c in chunks)
        assert [k for c in chunks for k in c] == list(range(B))
        # shared memory within one block's limit, as the kernel lays it out
        assert geo.smem_bytes + TILE_STATIC_SMEM <= ops.MAX_BLOCK_SMEM
        assert geo.smem_bytes == ops.tile_smem_bytes(
            geo.rows, geo.batch_chunk, H, C, item, geo.staged)
        assert geo.staged   # every Table-1 shape stages its û sub-block
        assert geo.groups <= ops.MAX_GRID_Y
        # at most the clusters the card holds at once, at most one a group
        per_sm = ops.tile_blocks_per_sm(geo.smem_bytes)
        assert per_sm >= 1
        assert 1 <= geo.slots <= min(geo.groups,
                                     ops.SM_COUNT * per_sm // geo.cluster
                                     or 1)
        assert geo.partial_shape(B, H, C) == (geo.slots, B, H, C)
        if name == "Caps-MN1" and B == 100:
            assert geo.blocks >= ops.SM_COUNT


def test_routing_geometry_serving_shape_spreads_over_the_card():
    """Caps-MN1, B=100, fp32 at the serving l_tile: two blocks on every SM
    where the one-block-per-tile grid had 12 blocks, and every cluster
    walks at least two row groups, so a copy is in flight while a group is
    worked on."""
    L, H, C, _ = _dims("Caps-MN1")
    l_tile = ops.procedure_l_tile(100, L, H, C, "fp32")
    geo = ops.tile_geometry(100, L, H, C, l_tile, "fp32")
    assert L // l_tile == 12
    assert geo.cluster == 8 and geo.batch_chunk == 13 and geo.staged
    assert 2 * (geo.smem_bytes + ops.BLOCK_RESERVED_SMEM
                + TILE_STATIC_SMEM) <= ops.SM_SMEM_BYTES
    assert geo.blocks >= 2 * ops.SM_COUNT - geo.cluster
    assert geo.groups >= 2 * geo.slots


def test_routing_geometry_unstaged_and_refused_shapes():
    """A batch row of one L-row too wide to stage runs unstaged; a shape
    whose column sums alone do not fit one block raises."""
    L, H, C, _ = _dims("Caps-EN3")
    geo = ops.tile_geometry(1000, L, H, C, 2, "fp32")
    assert not geo.staged and geo.cluster == 8 and geo.batch_chunk == 125
    assert geo.smem_bytes == ops.tile_smem_bytes(geo.rows, 125, H, C, 4,
                                                 False)
    with pytest.raises(ValueError, match="shared memory"):
        ops.tile_geometry(2, 4, 10, 6000, 4, "fp32")
    with pytest.raises(ValueError, match="l_tile"):
        ops.tile_geometry(2, 12, 10, 16, 5, "fp32")


class _Recorder:
    """Stands in for the CUDA library: records each routing entry point's
    arguments, with the tensors behind the pointers the wrapper passed."""

    def __init__(self):
        self.tensors = {}
        self.calls = []

    def ptr(self, t):
        if t is None:
            return None
        self.tensors[t.data_ptr()] = t
        return t.data_ptr()

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(kernel, "plain_mode", lambda t: False)
    monkeypatch.setattr(kernel, "_ptr", rec.ptr)
    monkeypatch.setattr(kernel, "_stream", lambda device: 0)
    monkeypatch.setattr(cudalib, "build", lambda: rec)
    return rec


# (entry point, index of the partial pointer, index of l_tile) in the C
# signatures of csrc/routing.cu and csrc/routing_bwd.cu
_ENTRY = {"procedure": ("routing_procedure", 5, 14),
          "iteration": ("routing_iteration", 6, 11),
          "backward": ("routing_procedure_backward", 6, 16)}


@pytest.mark.parametrize("form", ["procedure", "procedure-early-exit",
                                  "procedure-int8", "iteration", "backward"])
@pytest.mark.parametrize("name,B", [("Caps-MN1", 8), ("Caps-SV3", 8),
                                    ("Caps-EN3", 1)])
def test_wrappers_allocate_partials_of_the_geometry(recorder, name, B, form):
    L, H, C, iters = _dims(name)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal((B, L, H, C),
                                             dtype=np.float32))
    sd = "int8" if form == "procedure-int8" else "fp32"
    with torch.no_grad():
        if form.startswith("procedure"):
            early = form == "procedure-early-exit"
            l_tile = ops.procedure_l_tile(B, L, H, C, sd, early_exit=early)
            args = (ops.quantize_u_stream(u, l_tile) if sd == "int8"
                    else (u, None))
            kernel.routing_procedure_fused(
                *args, iterations=iters, l_tile=l_tile,
                early_exit_eps=8.0 if early else None)
        elif form == "iteration":
            l_tile = ops.auto_l_tile(B, L, H, C, sd)
            kernel.routing_iteration_fused(
                u, torch.zeros(L, H), torch.zeros(B, H, C), l_tile=l_tile)
        else:
            l_tile = ops.procedure_train_l_tile(B, L, H, C, iters, sd)
            kernel.routing_procedure_bwd(u, torch.zeros(B, H, C),
                                         iterations=iters, l_tile=l_tile)
    entry, i_partial, i_tile = _ENTRY[form.split("-")[0]]
    (called, args), = recorder.calls
    assert called == entry
    geo = ops.tile_geometry(B, L, H, C, l_tile, sd)
    partial = recorder.tensors[args[i_partial]]
    # one (B, H, C) slice a slot, the backward's reverse sweep included
    assert tuple(partial.shape) == geo.partial_shape(B, H, C) == (
        geo.slots, B, H, C)
    assert partial.dtype == torch.float32
    assert args[i_tile:i_tile + 6] == (l_tile, geo.rows, geo.batch_chunk,
                                       geo.cluster, int(geo.staged),
                                       geo.slots)
    if form == "procedure-early-exit":
        gmax = recorder.tensors[args[6]]
        conv = recorder.tensors[args[7]]
        assert tuple(gmax.shape) == (geo.groups,)
        assert tuple(conv.shape) == (L // l_tile,)


# (B, L, H, C): the Table-1 shapes at the batches the EM path hands the
# E-step, chip_smoke.py's odd shape, and shapes at the lane layout's edges
ESTEP_SHAPES = ([(B, *_dims(name)[:3]) for name in SHAPES for B in BATCHES]
                + [(20, 90, 7, 5), (3, 17, 1, 3), (2, 33, 32, 8),
                   (4, 9, 33, 4), (2, 5, 100, 16), (1, 7, 256, 2),
                   (5, 11, 3, 20)])


@pytest.mark.parametrize("shape", ESTEP_SHAPES)
def test_estep_geometry_covers_every_row_once(shape):
    B, L, H, C = shape
    geo = ops.estep_geometry(B, L, H, C)
    n = B * L
    seen = np.zeros(n, dtype=np.int64)
    for w in range(geo.warps):
        rows = geo.warp_rows(w, n)
        # an even share: at most one pass more than any other warp's
        assert len(rows) <= -(-geo.passes // geo.warps) * geo.rows_per_pass
        seen[rows.start:rows.stop] += 1
    assert (seen == 1).all()
    # a lane a (row, h): R rows of H lanes a pass, or h_per_lane h a lane
    assert geo.rows_per_pass * min(H, 32) <= 32
    assert geo.h_per_lane * 32 >= H and (geo.h_per_lane - 1) * 32 < H
    assert geo.passes * geo.rows_per_pass >= n
    assert (geo.passes - 1) * geo.rows_per_pass < n
    assert 1 <= geo.warps <= geo.passes
    wpb = ops.ESTEP_THREADS // 32
    assert (geo.blocks - 1) * wpb < geo.warps <= geo.blocks * wpb
    assert geo.blocks <= ops.SM_COUNT * ops.ESTEP_BLOCKS_PER_SM
    # 16-byte loads exactly where C splits into fours (up to 16) and a
    # lane holds at most two capsules' μ and 1/σ² in registers
    assert geo.vector == (4 if C % 4 == 0 and C <= 16 and H <= 64 else 1)


def test_estep_geometry_at_the_serving_shapes():
    """The vector path at every Table-1 shape; two blocks on every SM at
    Caps-MN1, B=100 (3 rows of 10 lanes a pass, 30 of 32 lanes busy) and
    still a full grid at the CLI's microbatch of 8; H above 256 refused."""
    for name in SHAPES:
        L, H, C, _ = _dims(name)
        assert ops.estep_geometry(100, L, H, C).vector == 4
    L, H, C, _ = _dims("Caps-MN1")
    geo = ops.estep_geometry(100, L, H, C)
    assert geo.rows_per_pass == 3 and geo.h_per_lane == 1
    assert geo.blocks >= ops.SM_COUNT
    assert geo.blocks == ops.SM_COUNT * ops.ESTEP_BLOCKS_PER_SM
    small = ops.estep_geometry(8, L, H, C)
    assert small.blocks == ops.SM_COUNT * ops.ESTEP_BLOCKS_PER_SM
    en3 = ops.estep_geometry(100, *_dims("Caps-EN3")[:3])
    assert en3.rows_per_pass == 1 and en3.h_per_lane == 2
    assert ops.estep_geometry(20, 90, 7, 5).vector == 1
    with pytest.raises(ValueError, match="H <= 256"):
        ops.estep_geometry(2, 4, 257, 4)


@pytest.mark.parametrize("shape,offset", [((100, 1152, 10, 16), 0),
                                          ((8, 1152, 62, 16), 0),
                                          ((20, 90, 7, 5), 0),
                                          ((4, 16, 10, 16), 1)])
def test_estep_wrapper_passes_its_geometry(recorder, shape, offset):
    """The E-step wrapper hands the kernel ``estep_geometry``'s values; a
    votes view that is not 16-byte aligned takes the scalar path."""
    B, L, H, C = shape
    rng = np.random.default_rng(1)
    flat = torch.from_numpy(rng.standard_normal(B * L * H * C + offset,
                                                dtype=np.float32))
    votes = flat[offset:].view(B, L, H, C)
    mu = torch.zeros(B, H, C)
    with torch.no_grad():
        r = kernel.em_stage_estep(votes, mu, torch.ones(B, H, C),
                                  torch.zeros(B, H), l_tile=L)
    (called, args), = recorder.calls
    assert called == "em_stage_estep"
    geo = ops.estep_geometry(B, L, H, C)
    assert args[5:9] == (B, L, H, C)
    vector = geo.vector if offset == 0 else 1
    assert args[9:14] == (geo.rows_per_pass, geo.h_per_lane, vector,
                          geo.warps, geo.blocks)
    assert recorder.tensors[args[4]] is r and tuple(r.shape) == (B, L, H)


# (Bt, T, Din, N, dtype): falcon-mamba-7b's prefill, the reference's
# SSM_CASES, and the odd shapes chip_smoke.py runs
SCAN_SHAPES = [(4, 1024, 8192, 16, torch.bfloat16),
               (1, 64, 16, 8, torch.float32), (2, 128, 32, 16, torch.float32),
               (2, 64, 8, 4, torch.float32), (1, 96, 16, 8, torch.float32),
               (2, 37, 64, 16, torch.bfloat16),
               (2, 37, 75, 32, torch.bfloat16),
               (1, 40, 100, 16, torch.float32)]


@pytest.mark.parametrize("case", SCAN_SHAPES)
def test_scan_geometry_fits_the_card(case):
    Bt, T, Din, N, dtype = case
    geo = scan_kernel.scan_geometry(Bt, Din, N, dtype)
    assert geo.lanes_per_channel * min(
        N, scan_kernel.SCAN_STATES_PER_LANE) == N
    assert 32 % geo.lanes_per_channel == 0      # a group within one warp
    assert geo.threads % 32 == 0 and geo.threads <= 1024
    assert geo.smem_bytes <= ops.MAX_BLOCK_SMEM
    per_batch = geo.blocks // Bt
    assert per_batch * scan_kernel.SCAN_CHANNELS >= Din
    assert (per_batch - 1) * scan_kernel.SCAN_CHANNELS < Din
    assert geo.vector_rows == (Din % 64 == 0)


def test_scan_geometry_at_falcon_prefill_fills_the_sms():
    """At falcon-mamba-7b's prefill the lane groups give twice the warps of
    one thread per channel (Bt·Din/32), all resident at once."""
    geo = scan_kernel.scan_geometry(4, 8192, 16, torch.bfloat16)
    warps = geo.blocks * geo.threads // 32
    assert geo.lanes_per_channel == 2
    assert warps >= 2 * (4 * 8192 // 32)
    assert warps <= ops.SM_COUNT * 64      # 64 resident warps an SM
    assert geo.vector_rows
    # several blocks share an SM: registers and shared memory allow it
    assert 4 * geo.smem_bytes <= ops.SM_SMEM_BYTES
    with pytest.raises(ValueError, match="state sizes"):
        scan_kernel.scan_geometry(1, 64, 12, torch.float32)
