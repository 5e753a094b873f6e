"""Launch geometry of the routing tile kernel, the EM E-step, the routing
update stage and the selective scan, in plain Python on the CPU.

The routing wrappers cut each reference tile (``l_tile``: int8 scale rows,
early-exit flags, the work counter) into smaller row groups and split B
over a thread-block cluster (``ops.tile_geometry``), and the backward's
reverse sweep runs on the same geometry; the E-step gives a lane one (row,
h) and a warp an even share of the rows (``ops.estep_geometry``); the
update stage gives a thread a 16-byte run of votes for one batch slice
(``ops.stage_update_geometry``), and its sums run slice by slice, then
over C, which a numpy emulation holds to the plain version; the scan
splits each channel's states over a group of lanes
(``ssm_scan.kernel.scan_geometry``); the three attention kernels' tiles at
Sk ≠ Sq (cross attention), bf16 and fp32 (the fp32 ones at
``kernel.f32_geometry``'s rows and steps; their fragment maps are
modelled in ``tests/test_torch_flash_tf32.py``): a model of their loops
visits every unmasked (row, key) pair once, the sources count rows by Sq
and keys by Sk, and the wrappers pass both; the bf16 wide forward
(``kernel.wide_fwd_geometry``, head dims above 256) fits a block at every
D from 257 to 1024, runs the score product once per tile pair up to D =
512, and covers every column of D once in its score halves and its
output pieces; so does the bf16 wide backward (``kernel.wide_bwd_geometry``:
the dq kernel one piece up to D = 512, the dk/dv kernel at most ceil(D /
256) pieces).  These tests hold each to the card's
limits at every shape the serving and training paths hand them, and check
that the routing, E-step and update wrappers allocate their scratch and
pass the geometry the kernel is launched with (the library is replaced by
a recorder; no card is needed).
"""
from __future__ import annotations

import re

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
    still a full grid at the CLI's microbatch of 8; H above 256 on the wide
    kernel in h-passes."""
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
    wide = ops.estep_geometry(2, 4, 257, 4)
    assert (wide.h_per_lane, wide.h_passes, wide.vector) == (8, 2, 4)
    assert ops.estep_geometry(2, 4, 256, 4).h_passes == 1


@pytest.mark.parametrize("shape", [(2, 4, 257, 4), (4, 128, 300, 16),
                                   (2, 64, 257, 5), (3, 5, 513, 16),
                                   (1, 3, 300, 20)])
def test_estep_geometry_covers_every_row_and_h_once_above_256(shape):
    """Above 256 capsules a warp takes one row and walks H in passes of 256
    (8 h a lane): every (row, h) falls to exactly one warp and lane, and
    each h to one pass slot."""
    B, L, H, C = shape
    geo = ops.estep_geometry(B, L, H, C)
    assert geo.rows_per_pass == 1 and geo.h_per_lane == 8
    assert geo.h_passes == -(-H // 256) and (geo.h_passes - 1) * 256 < H
    n = B * L
    rows = np.zeros(n, dtype=np.int64)
    for w in range(geo.warps):
        span = geo.warp_rows(w, n)
        rows[span.start:span.stop] += 1
    assert (rows == 1).all()
    # lane l of pass p takes h = 256·p + 32·j + l for j < h_per_lane
    hs = np.zeros(H, dtype=np.int64)
    for p in range(geo.h_passes):
        for j in range(geo.h_per_lane):
            h = 256 * p + 32 * j + np.arange(32)
            hs[h[h < H]] += 1
    assert (hs == 1).all()
    assert geo.vector == (4 if C % 4 == 0 and C <= 16 else 1)
    wpb = ops.ESTEP_THREADS // 32
    assert (geo.blocks - 1) * wpb < geo.warps <= geo.blocks * wpb <= (
        ops.SM_COUNT * ops.ESTEP_BLOCKS_PER_SM * wpb)


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


# (B, L, H, C): the four phase-7 shapes of chip_smoke.py (Caps-MN1,
# Caps-EN3, Caps-CF3 at B=100, Caps-MN1 at B=8) and its odd shape
STAGE_SHAPES = [(100, *_dims("Caps-MN1")[:3]), (100, *_dims("Caps-EN3")[:3]),
                (100, *_dims("Caps-CF3")[:3]), (8, *_dims("Caps-MN1")[:3]),
                (20, 90, 7, 5)]


def _stage_runs(geo, L: int, H: int, C: int):
    """(block, slice, first element (l, hc)) of every run the update
    kernel's threads own in every pass, as ``stage_update_kernel`` maps
    them."""
    HC = H * C
    pruns = geo.cols // geo.vector
    for k in range(geo.blocks):
        l0 = k * geo.rows
        rows = min(geo.rows, L - l0)
        for p in range(geo.passes):
            width = min(geo.cols, HC - p * geo.cols)
            for t in range(geo.threads):
                sl, o = divmod(t, geo.rows * pruns)
                row, col = divmod(o, pruns)
                if sl < geo.slices and row < rows and col * geo.vector < width:
                    yield k, sl, l0 + row, p * geo.cols + col * geo.vector


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sd", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", STAGE_SHAPES)
def test_stage_update_geometry_covers_every_vote_once(shape, sd, aligned):
    B, L, H, C = shape
    geo = ops.stage_update_geometry(B, L, H, C, sd, aligned=aligned)
    HC = H * C
    item = 4 if sd == "fp32" else 2
    # 16-byte runs exactly where H·C splits into them and û allows it
    assert geo.vector == (16 // item if aligned and HC % (16 // item) == 0
                          else 1)
    assert geo.blocks == -(-L // geo.rows)
    # one pass where a row's runs fit a block, else one row a block and
    # the fewest passes of whole runs, none of them empty
    runs = HC // geo.vector
    assert geo.passes == -(-runs // ops.STAGE_UPDATE_THREADS)
    assert geo.cols % geo.vector == 0
    assert geo.passes * geo.cols >= HC > (geo.passes - 1) * geo.cols
    assert geo.passes == 1 or geo.rows == 1
    seen = np.zeros((geo.slices, L, HC), dtype=np.int64)
    for _, sl, l, hc in _stage_runs(geo, L, H, C):
        # a run stays in one row: it never straddles l
        assert hc + geo.vector <= HC
        seen[sl, l, hc:hc + geo.vector] += 1
    assert (seen == 1).all()   # every (l, h, c) once in every slice
    rows = [b for s in range(geo.slices) for b in geo.slice_rows(s, B)]
    assert rows == list(range(B))   # every b in exactly one slice
    assert all(len(geo.slice_rows(s, B)) >= 1 for s in range(geo.slices))
    # the stagings of v cover each slice's rows, the last one not empty
    most = max(len(geo.slice_rows(s, B)) for s in range(geo.slices))
    assert (geo.chunks - 1) * geo.chunk_rows < most
    assert geo.chunks * geo.chunk_rows >= most
    # several stagings hold whole rings of in-flight rows each
    assert geo.chunks == 1 or geo.chunk_rows % geo.unroll == 0
    assert geo.unroll == ops.STAGE_UPDATE_RING[geo.smem_ring]
    assert geo.smem_ring == (max(len(geo.slice_rows(s, B)) for s in range(
        geo.slices)) >= ops.STAGE_UPDATE_SHARED_RING_ROWS)
    # the card's limits, as the kernel lays out its shared memory
    assert geo.threads % 32 == 0
    assert geo.threads <= ops.STAGE_UPDATE_THREADS <= 1024
    assert (geo.threads - 32 < geo.slices * geo.rows * geo.cols
            // geo.vector <= geo.threads)
    assert geo.smem_bytes == ops.stage_update_smem_bytes(
        geo.rows, geo.slices, geo.chunk_rows, geo.cols, H, geo.passes,
        geo.threads, geo.smem_ring)
    assert geo.smem_bytes <= ops.MAX_BLOCK_SMEM <= 227 * 1024
    assert geo.blocks_per_sm == ops.stage_update_blocks_per_sm(
        geo.threads, geo.smem_bytes) >= 1


@pytest.mark.parametrize("sd", ["fp32", "bf16"])
def test_stage_update_geometry_fills_the_card_at_the_serving_shape(sd):
    """Caps-MN1, B=100: B split over slices long enough for the ring in
    shared memory, all blocks resident in one wave, at least as many
    16-byte û loads in flight as 132·1024 threads issuing one each, v
    staged in pieces of at most ``STAGE_UPDATE_STAGING_BYTES``; an
    unaligned û takes one-element runs; a row of more runs than a block's
    threads takes several passes (Caps-EN3 unaligned, a wide row); only a
    shape whose (rows, H) sums outgrow a block's shared memory is
    refused."""
    L, H, C, _ = _dims("Caps-MN1")
    geo = ops.stage_update_geometry(100, L, H, C, sd)
    runs = H * C // geo.vector
    in_flight = geo.blocks * geo.slices * geo.rows * runs * geo.unroll
    assert in_flight >= ops.SM_COUNT * 1024
    assert geo.blocks <= ops.SM_COUNT * geo.blocks_per_sm
    assert geo.slices > 1 and geo.chunks > 1 and geo.smem_ring
    assert (4 * geo.slices * geo.chunk_rows * H * C
            <= ops.STAGE_UPDATE_STAGING_BYTES)
    assert ops.stage_update_geometry(100, L, H, C, sd,
                                     aligned=False).vector == 1
    assert geo.passes == 1
    L3, H3, C3, _ = _dims("Caps-EN3")
    wide = ops.stage_update_geometry(100, L3, H3, C3, sd, aligned=False)
    assert (wide.vector, wide.passes, wide.rows) == (1, 2, 1)
    assert ops.stage_update_geometry(2, 4, 257 * 16, 16, sd).passes > 1
    with pytest.raises(ValueError, match="shared memory"):
        ops.stage_update_geometry(2, 4, 30000, 16, sd)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.stage_update_geometry(2, 4, 10, 16, "int8")


def _emulated_db(u: np.ndarray, v: np.ndarray, geo, slices=None):
    """db (L, H) in the update kernel's order, fp32, each product and sum
    rounded on its own: per slice Σ_b in row order, the slices' sums added
    in slice order, then Σ_c in c order.  ``slices`` replaces the list of
    slices summed (to show a skipped or doubled slice fails)."""
    B, L, H, C = u.shape
    parts = []
    for s in (range(geo.slices) if slices is None else slices):
        acc = np.zeros((L, H, C), dtype=np.float32)
        for b in geo.slice_rows(s, B):
            acc = acc + u[b] * v[b][None]
        parts.append(acc)
    term = parts[0]
    for p in parts[1:]:
        term = term + p
    d = np.zeros((L, H), dtype=np.float32)
    for c in range(C):
        d = d + term[..., c]
    return d


@pytest.mark.parametrize("sd", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(100, 16, 10, 16), (40, 24, 62, 16),
                                   (20, 90, 7, 5), (100, 12, 11, 16)])
def test_stage_update_sum_order_matches_the_plain_version(shape, sd):
    B, L, H, C = shape
    rng = np.random.default_rng(B * L + H)
    u = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        ops.STREAM_DTYPES[sd])
    s = torch.from_numpy(rng.standard_normal((B, H, C), dtype=np.float32))
    v, db = kernel.routing_stage_update_plain(u, s, l_tile=L)
    geo = ops.stage_update_geometry(B, L, H, C, sd)
    assert geo.slices >= 2
    un, vn = u.float().numpy(), v.numpy()
    tol = 1e-5 * max(1.0, float(db.abs().max()))
    got = _emulated_db(un, vn, geo)
    assert float(np.abs(got - db.numpy()).max()) <= tol
    skipped = [s for s in range(geo.slices) if s != 1]
    doubled = [*range(geo.slices), 1]
    for wrong in (skipped, doubled):
        bad = _emulated_db(un, vn, geo, wrong)
        assert float(np.abs(bad - db.numpy()).max()) > tol


def _emulated_db_passes(u: np.ndarray, v: np.ndarray, geo):
    """db (L, H) as the update kernel sums it pass by pass: each pass's
    columns [c0, c0 + width) summed over the slices in order, then each
    capsule's c terms of the pass added in c order to its sum so far,
    which a capsule cut by the pass boundary carries to the next pass."""
    B, L, H, C = u.shape
    HC = H * C
    un, vn = u.reshape(B, L, HC), v.reshape(B, HC)
    db = np.zeros((L, H), dtype=np.float32)
    sums = np.zeros((L, H), dtype=np.float32)
    for p in range(geo.passes):
        c0 = p * geo.cols
        width = min(geo.cols, HC - c0)
        term = None
        for s in range(geo.slices):
            acc = np.zeros((L, width), dtype=np.float32)
            for b in geo.slice_rows(s, B):
                acc = acc + un[b, :, c0:c0 + width] * vn[b, c0:c0 + width]
            term = acc if term is None else term + acc
        for h in range(c0 // C, (c0 + width - 1) // C + 1):
            lo, hi = max(h * C, c0), min((h + 1) * C, c0 + width)
            d = (np.zeros(L, dtype=np.float32) if h * C >= c0
                 else sums[:, h])
            for k in range(lo, hi):
                d = d + term[:, k - c0]
            if hi < (h + 1) * C:
                sums[:, h] = d
            else:
                db[:, h] = d
    return db


@pytest.mark.parametrize("shape,sd,aligned", [
    ((6, 5, 47, 16), "fp32", False), ((5, 3, 301, 7), "fp32", True),
    ((6, 4, 62, 16), "bf16", False), ((100, 16, 10, 16), "fp32", True)])
def test_stage_update_passes_carry_the_sum_over_c(shape, sd, aligned):
    """Rows of more runs than a block's threads (Caps-EN2's and EN3's H·C
    unaligned, capsules cut by a pass boundary at H·C = 752 and 2107) sum
    as one pass would, bit for bit, and within the gate of the plain
    version."""
    B, L, H, C = shape
    geo = ops.stage_update_geometry(B, L, H, C, sd, aligned=aligned)
    assert geo.passes == (1 if shape[0] == 100 else
                          -(-H * C // geo.vector // ops.STAGE_UPDATE_THREADS))
    rng = np.random.default_rng(H * C)
    u = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        ops.STREAM_DTYPES[sd])
    s = torch.from_numpy(rng.standard_normal((B, H, C), dtype=np.float32))
    v, db = kernel.routing_stage_update_plain(u, s, l_tile=L)
    un, vn = u.float().numpy(), v.numpy()
    got = _emulated_db_passes(un, vn, geo)
    assert np.array_equal(got, _emulated_db(un, vn, geo))
    tol = 1e-5 * max(1.0, float(db.abs().max()))
    assert float(np.abs(got - db.numpy()).max()) <= tol


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("shape,sd,offset", [
    ((100, 1152, 10, 16), "fp32", 0), ((100, 1152, 10, 16), "bf16", 0),
    ((8, 64, 62, 16), "bf16", 0), ((20, 90, 7, 5), "fp32", 0),
    ((4, 16, 10, 16), "fp32", 1), ((4, 8, 62, 16), "fp32", 1),
    ((4, 8, 62, 16), "bf16", 1)])
def test_stage_update_wrapper_passes_its_geometry(recorder, shape, sd,
                                                  offset, fold):
    """Both update wrappers hand the kernel ``stage_update_geometry``'s
    values in one call; a û view that is not 16-byte aligned gets the
    geometry of one-element runs (at Caps-EN3's H·C = 992, in two
    passes)."""
    B, L, H, C = shape
    rng = np.random.default_rng(2)
    flat = torch.from_numpy(rng.standard_normal(B * L * H * C + offset,
                                                dtype=np.float32)).to(
        ops.STREAM_DTYPES[sd])
    u = flat[offset:].view(B, L, H, C)
    s = torch.zeros(B, H, C)
    with torch.no_grad():
        if fold:
            out = kernel.routing_stage_update_fold(u, s, torch.zeros(L, H),
                                                   l_tile=L)
        else:
            out = kernel.routing_stage_update(u, s, l_tile=L)
    (called, args), = recorder.calls
    assert called == "routing_stage_update"
    geo = ops.stage_update_geometry(B, L, H, C, sd, aligned=offset == 0)
    assert args[8:14] == (B, L, H, C, 0, int(fold))
    assert args[14:24] == (geo.rows, geo.slices, geo.passes, geo.vector,
                           int(geo.smem_ring), geo.chunk_rows, geo.chunks,
                           geo.threads, geo.blocks, geo.smem_bytes)
    wide = 16 // flat.element_size()
    assert geo.vector == (1 if offset or H * C % wide else wide)
    assert geo.passes == (2 if (offset, H * C) == (1, 992) else 1)
    assert recorder.tensors[args[3]] is out[0]       # v
    if fold:
        assert recorder.tensors[args[6]] is out[1]   # b_new
        assert recorder.tensors[args[7]] is out[2]   # c
    else:
        assert recorder.tensors[args[4]] is out[1]   # db


# ---------------------------------------------------------------------------
# the flash-attention kernels' tiles at Sk ≠ Sq (cross attention)
# ---------------------------------------------------------------------------

FLASH_CU = (cudalib._CSRC / "flash_attention.cu").read_text()
FLASH_BWD_CU = (cudalib._CSRC / "flash_attention_bwd.cu").read_text()


def _m_tiles(D: int) -> int:
    """``flash_tc::m_tiles<D>()``: 16-row tiles a warp of the bf16 kernels
    owns."""
    return 2 if D <= 64 else 1


def _visits(Sq: int, Sk: int, rows: int, keys: int, causal: bool,
            window, by_keys: bool, step: int = 64) -> np.ndarray:
    """How often the kernels' loops visit each (row, key) pair, as written
    in the CUDA sources.  ``by_keys`` False: the forward and dq kernels, a
    block for each tile of ``rows`` query rows (a grid of ceil(Sq/rows))
    looping over the ``step``-key steps from ``it0`` to ``n_kt`` (the step
    count from Sk, cut at the diagonal when causal); True: the dk/dv
    kernels, a block for each tile of ``keys`` keys (a grid of
    ceil(Sk/keys)) looping over the ``step``-row q-steps from the diagonal
    (when causal) to ``n_qt`` (from Sq).  A pair counts where it is inside
    both lengths and unmasked."""
    seen = np.zeros((Sq, Sk), np.int64)
    r = np.arange(Sq)[:, None]
    c = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= c <= r
    if window:
        keep &= c > r - window
    if not by_keys:
        n_kt_all = -(-Sk // step)
        for q0 in range(0, -(-Sq // rows) * rows, rows):
            n_kt = min(n_kt_all, (q0 + rows - 1) // step + 1) if causal \
                else n_kt_all
            it0 = max(0, q0 - window + 1) // step if window else 0
            for it in range(it0, n_kt):
                seen[q0:q0 + rows, it * step:it * step + step] += \
                    keep[q0:q0 + rows, it * step:it * step + step]
    else:
        for k0 in range(0, -(-Sk // keys) * keys, keys):
            n_qt = -(-Sq // step)
            if window:
                n_qt = min(n_qt, (k0 + keys - 1 + window - 1) // step + 1)
            for qi in range(k0 // step if causal else 0, n_qt):
                seen[qi * step:qi * step + step, k0:k0 + keys] += \
                    keep[qi * step:qi * step + step, k0:k0 + keys]
    return seen, keep


@pytest.mark.parametrize("D", (64, 112))
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (1024, 4096, False, None), (37, 200, False, None),
    (333, 129, False, None), (1, 65, False, None), (200, 1, False, None),
    (333, 333, True, None), (333, 333, True, 100), (130, 130, False, None)])
def test_flash_tiles_visit_each_row_key_pair_once(Sq, Sk, causal, window, D):
    """Every kernel's loops (the bf16 ones on 64·m_tiles rows or keys a
    block and 64-row steps, the fp32 ones on ``f32_geometry``'s rows and
    steps) visit every unmasked (row, key) pair once and nothing else,
    cross attention's Sk ≠ Sq included."""
    from repro_torch.kernels.flash_attention.kernel import f32_geometry
    bq = 64 * _m_tiles(D)
    fwd, dq, dkv = (f32_geometry(kind, D) for kind in ("fwd", "dq", "dkv"))
    for rows, keys, by_keys, step in (
            (bq, 64, False, 64), (64, bq, True, 64),
            (fwd.rows, None, False, fwd.step), (dq.rows, None, False, dq.step),
            (None, dkv.rows, True, dkv.step)):
        seen, keep = _visits(Sq, Sk, rows, keys, causal, window, by_keys,
                             step)
        np.testing.assert_array_equal(seen, keep.astype(np.int64))


def test_flash_sources_count_query_rows_by_sq_and_keys_by_sk():
    """The grids, loops, loads and masks of the sources use the length
    of their own axis: q-tiles and row masks Sq, k-tiles and key masks
    Sk (the model above follows them)."""
    for src in (FLASH_CU, FLASH_BWD_CU):
        assert not re.search(r"int Hkv, int S\b|Hkv, S,", src)
        assert "(causal && Sk != Sq)" in src
    assert FLASH_CU.count("const dim3 grid((Sq + ") == 2
    assert FLASH_CU.count("const int n_kt_all = (Sk + ") == 2
    assert FLASH_CU.count("if (col >= Sk || (causal && col > row)") == 2
    assert FLASH_BWD_CU.count("grid_q((Sq + ") == 2
    assert FLASH_BWD_CU.count("grid_k((Sk + ") == 2
    assert FLASH_BWD_CU.count("const int n_kt_all = (Sk + ") == 2
    assert FLASH_BWD_CU.count("? min((Sq + ") == 2       # the n_qt loops
    assert FLASH_BWD_CU.count("(size_t)(b * Hq + h) * Sk;") == 2   # dk_h


class _FlashRecorder:
    """Stands in for the CUDA library: records each flash-attention entry
    point's arguments and the tensors behind its pointers."""

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


def test_flash_wrappers_pass_sq_and_sk(monkeypatch):
    """The three wrappers at Sq = 37 rows over Sk = 200 keys (GQA 4:2):
    the C interface gets (B, Hq, Hkv, Sq, Sk, D), lse is (B, Hq, Sq), the
    per-query-head dk/dv scratch (2, B, Hq, Sk, D), and dk, dv come back
    (B, Hkv, Sk, D)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    rec = _FlashRecorder()
    monkeypatch.setattr(fk, "plain_mode", lambda t: False)
    monkeypatch.setattr(cudalib, "ptr", rec.ptr)
    monkeypatch.setattr(cudalib, "stream", lambda device: 0)
    monkeypatch.setattr(cudalib, "build", lambda: rec)
    monkeypatch.setattr(cudalib, "check", lambda err: None)
    B, Hq, Hkv, Sq, Sk, D = 2, 4, 2, 37, 200, 64
    q = torch.zeros(B, Hq, Sq, D)
    k = torch.zeros(B, Hkv, Sk, D)
    o = fk.flash_attention(q, k, k, causal=False)
    o2, lse = fk.flash_attention_fwd_lse(q, k, k, causal=False)
    dq, dk, dv = fk.flash_attention_bwd(q, k, k, o2, lse, q, causal=False)
    (f1, a1), (f2, a2), (f3, a3) = rec.calls
    assert (f1, f2, f3) == ("flash_attention_fwd", "flash_attention_fwd",
                            "flash_attention_bwd")
    for args in (a1, a2):
        assert args[6:12] == (B, Hq, Hkv, Sq, Sk, D)
        assert args[13:15] == (0, 0)                  # causal, window
    assert a1[4] is None and rec.tensors[a2[4]] is lse
    assert o.shape == o2.shape == (B, Hq, Sq, D) and lse.shape == (B, Hq, Sq)
    assert a3[10:16] == (B, Hq, Hkv, Sq, Sk, D)
    assert tuple(rec.tensors[a3[7]].shape) == (B, Hq, Sk, D)   # dk_h
    assert tuple(rec.tensors[a3[8]].shape) == (B, Hq, Sk, D)   # dv_h
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape


# ---------------------------------------------------------------------------
# the bf16 wide forward (D > 256): pieces of D, halves of a piece
# ---------------------------------------------------------------------------

WIDE_CU = (cudalib._CSRC / "flash_attention_wide.cu").read_text()
SMEM_OPT_IN = 232448       # the H100's opt-in shared memory a block


def _wide_cover(D: int, geom) -> tuple:
    """(how often one score product reads each column of D, how often the
    output pieces write it), as wide_fwd_tc_kernel walks a piece of
    ``piece_cols`` columns: the score product of a k-tile runs over every
    piece, warp half h of a row group taking the piece's k-steps h·pairs..
    (h + 1)·pairs − 1; a block owns one output piece, half h its column
    pairs h·pairs.. (h + 1)·pairs − 1."""
    score = np.zeros(geom.pieces * geom.piece_cols, np.int64)
    out = np.zeros_like(score)
    for pc in range(geom.pieces):
        for half in (0, 1):
            for kk in range(geom.pairs):
                lo = pc * geom.piece_cols + 16 * (geom.pairs * half + kk)
                score[lo:lo + 16] += 1
                out[lo:lo + 16] += 1
    return score[:D], out[:D]


def test_wide_fwd_geometry_fits_and_covers_every_column_once():
    """Every D from 257 to 1024: shared memory within the 232,448 bytes a
    block may have, an instantiated pair count, one score product per
    (q-tile, k-tile) pair up to D = 512 (a block a q-tile, q staged once)
    and two at 1024, no piece wholly past D, every column of D read once
    by a score product and written once by the output pieces, and the
    entry point's checks passed."""
    from repro_torch.kernels.flash_attention import kernel as fk
    for D in range(257, 1025):
        g = fk.wide_fwd_geometry(D)
        assert g.smem_bytes == 384 * (g.piece_cols + 8) + 32768 \
            <= SMEM_OPT_IN, D
        assert g.pairs in fk.WIDE_TC_PAIRS
        # flash_attention_wide_fwd_tc's checks of its geometry
        assert g.piece_cols == 32 * g.pairs <= fk.WIDE_PIECE_COLS
        assert g.pieces * g.piece_cols >= D > (g.pieces - 1) * g.piece_cols
        score, out = _wide_cover(D, g)
        np.testing.assert_array_equal(score, 1, err_msg=str(D))
        np.testing.assert_array_equal(out, 1, err_msg=str(D))
        # score products a tile pair: one a block, a block an output piece
        assert g.pieces == (1 if D <= 512 else 2), D
        # the narrowest instantiation: a narrower one leaves columns out
        narrower = [p for p in fk.WIDE_TC_PAIRS if p < g.pairs]
        assert all(g.pieces * 32 * p < D for p in narrower), D
    assert fk.wide_fwd_geometry(512).smem_bytes == SMEM_OPT_IN
    assert fk.wide_fwd_geometry(320) == (1, 320, 10, 158720)


def test_wide_fwd_source_splits_as_the_model():
    """The kernel's halves, pieces and shared memory are the ones the
    model above and wide_fwd_geometry follow."""
    assert "constexpr int W = 32 * NP;" in WIDE_CU
    for operand in ("tc::a_lane(lane, LD) +\n                      "
                    "tc::at(wr, 16 * NP * half, LD)",
                    "tc::bn_lane(lane, LD) +\n                      "
                    "tc::at(0, 16 * NP * half, LD)",
                    "tc::bk_lane(lane, LD) +\n                      "
                    "tc::at(0, 16 * NP * half, LD)"):
        assert operand in WIDE_CU
    assert "for (int kk = 0; kk < NP; ++kk) {" in WIDE_CU
    assert "const int col = c_out + 16 * (NP * half + p) + 8 * j + 2 * t;" \
        in WIDE_CU
    assert "const int c_out = ((int)blockIdx.x % pieces) * W;" in WIDE_CU
    assert "static_assert(tc_smem(10) == 158720 && tc_smem(16) == " \
        "kSmemOptIn" in WIDE_CU
    assert "const dim3 grid(((Sq + kT - 1) / kT) * pieces, Hq, B);" \
        in WIDE_CU
    for pairs in (9, 10, 12, 16):
        assert f"return launch_fwd_tc<{pairs}>(" in WIDE_CU
    # fp32 runs its own kernels (below), bf16 none of them
    assert "launch_fwd<bf16>" not in WIDE_CU
    assert "launch_fwd_f32<G>(" in WIDE_CU


# ---------------------------------------------------------------------------
# the bf16 wide backward (D > 256): the dq and dk/dv kernels' pieces
# ---------------------------------------------------------------------------

def _wide_bwd_cover(D: int, geom) -> tuple:
    """(how often the dq pieces write each column, how often the dk/dv
    pieces do, how often one score product of each kernel reads it), as
    wide_dq_tc_kernel and wide_dkv_tc_kernel walk them: a dq block owns a
    piece of ``dq_cols`` columns, warp half h its 16-column pairs
    h·pairs..; a dk/dv block a piece of ``dkv_cols``, warp half h its
    8-column tiles h·pairs..; each warp's score product runs its k-steps
    of 16 over every score piece of 32·pairs columns."""
    p = geom.pairs
    n = max(geom.dq_pieces * geom.dq_cols, geom.dkv_pieces * geom.dkv_cols)
    dq, dkv, score = (np.zeros(n, np.int64) for _ in range(3))
    for pc in range(geom.dq_pieces):
        for half in (0, 1):
            for j in range(p):
                lo = pc * geom.dq_cols + 16 * (p * half + j)
                dq[lo:lo + 16] += 1
    for pc in range(geom.dkv_pieces):
        for half in (0, 1):
            for j in range(p):
                lo = pc * geom.dkv_cols + 8 * (p * half + j)
                dkv[lo:lo + 8] += 1
    for pc in range(-(-D // (32 * p))):
        for kk in range(2 * p):
            lo = pc * 32 * p + 16 * kk
            score[lo:lo + 16] += 1
    return dq[:D], dkv[:D], score[:D]


def test_wide_bwd_geometry_fits_and_covers_every_column_once():
    """Every D from 257 to 1024: each kernel's shared memory within the
    232,448 bytes a block may have; the dq kernel one score computation per
    (q-tile, k-tile) pair up to D = 512 (one piece a q-tile) and the dk/dv
    kernel at most ceil(D / 256) (its pieces a k-tile); ds in one bf16 term
    where D is a multiple of 8, two elsewhere; every column of dq, dk and dv
    written once and read once by each score product; the entry point's
    checks of its geometry passed."""
    from repro_torch.kernels.flash_attention import kernel as fk
    for D in range(257, 1025):
        g = fk.wide_bwd_geometry(D)
        assert g.pairs in fk.WIDE_TC_PAIRS
        assert g.ds_terms == (1 if D % 8 == 0 else 2)
        resident = g.pairs <= fk.WIDE_BWD_RESIDENT
        tile = 2 * 64 * (32 * g.pairs + 8)
        assert g.dq_smem == (4 if resident else 3) * tile \
            + 8192 * g.ds_terms <= SMEM_OPT_IN, D
        assert g.dkv_smem == (4 if resident else 3) * tile \
            + 8192 * (1 + g.ds_terms) + 512 <= SMEM_OPT_IN, D
        # flash_attention_wide_bwd_tc's checks of its geometry
        assert g.dq_cols == 32 * g.pairs and g.dkv_cols == 16 * g.pairs
        for pieces, cols in ((g.dq_pieces, g.dq_cols),
                             (g.dkv_pieces, g.dkv_cols)):
            assert pieces * cols >= D > (pieces - 1) * cols, D
        assert not resident or g.dq_pieces == 1
        # score computations a tile pair: one a block of each kernel
        assert g.dq_pieces == (1 if D <= 512 else 2), D
        assert g.dkv_pieces <= -(-D // 256), D
        dq, dkv, score = _wide_bwd_cover(D, g)
        for name, cover in (("dq", dq), ("dk/dv", dkv), ("score", score)):
            np.testing.assert_array_equal(cover, 1, err_msg=f"{name} {D}")
        # held whole up to 384 columns, at the narrowest such width
        if D <= 384:
            assert resident and all(32 * p < D for p in fk.WIDE_TC_PAIRS
                                    if p < g.pairs), D
    assert fk.wide_bwd_geometry(320) == (10, 1, 1, 320, 2, 160, 176128,
                                         184832)
    assert max(max(fk.wide_bwd_geometry(D)[-2:])
               for D in range(257, 1025)) == 225792


def test_wide_bwd_source_takes_the_geometry():
    """The kernels' shared memory, warp shares and entry-point checks are
    the ones ``wide_bwd_geometry`` and the model above follow."""
    assert "static_assert(dq_tc_smem(10, 1) == 176128 && " \
        "dkv_tc_smem(10, 1) == 184832" in WIDE_CU
    assert "c_out + 16 * NP * half, t);" in WIDE_CU           # dq halves
    assert "const int col0 = c_out + 8 * NP * half;" in WIDE_CU  # dk, dv
    assert "const int c_out = ((int)blockIdx.x % pieces) * WO;" in WIDE_CU
    assert "__host__ __device__ constexpr bool bwd_resident(int NP) { " \
        "return NP <= 12; }" in WIDE_CU
    for pairs in (9, 10, 12, 16):
        for terms in (1, 2):
            assert f"return WIDE_BWD_TC({pairs}, {terms});" in WIDE_CU
    # fp32 runs its own kernels (below), bf16 none of them
    assert "launch_bwd<bf16>" not in WIDE_CU
    assert "launch_dq_f32<G>(" in WIDE_CU and "launch_dkv_f32<G>(" in WIDE_CU


# ---------------------------------------------------------------------------
# the fp32 wide kernels (D > 256): output pieces, score chunks, shares
# ---------------------------------------------------------------------------

WIDE_F32_DIMS = (257, 288, 300, 320, 384, 512, 513, 640, 1024)


def _f32_piece_cover(D: int, pieces: int, groups: int) -> np.ndarray:
    """How often the output pieces write each column of D, as
    ``f32_store`` walks a piece of 64·groups columns: thread column group
    cg < 16 holds the float4 columns 4·cg + 64j (j < groups) of it, and
    only columns below D are stored."""
    cover = np.zeros(D, np.int64)
    for pc in range(pieces):
        for cg in range(16):
            for j in range(groups):
                for e in range(4):
                    col = pc * 64 * groups + 4 * cg + 64 * j + e
                    if col < D:
                        cover[col] += 1
    return cover


def _f32_score_cover(D: int, chunk: int, geom) -> np.ndarray:
    """How often one score product of a tile pair reads each column of D,
    summed over the blocks of the tile's pieces (``f32_cols``): where the
    pieces form a cluster (2 to 8 of them) each block runs over its own
    piece's columns and the cluster adds the partial scores; otherwise
    (one piece, or more than 8) each block runs over all of D and its own
    scores are used, so one block's reads are counted.  A block walks
    steps of ``chunk`` columns, the halves that run the product (both in
    the forward and dv, one in dq and dk) each taking 16 columns of a
    step; columns past D are zero-filled, never read."""
    clustered = 1 < geom.pieces <= 8
    ranges = ([(pc * geom.piece_cols,
                min(geom.piece_cols, D - pc * geom.piece_cols))
               for pc in range(geom.pieces)] if clustered else [(0, D)])
    cover = np.zeros(D + chunk, np.int64)
    for lo, n in ranges:
        for step in range(-(-n // chunk)):
            for half in range(chunk // 16):
                a = lo + step * chunk + 16 * half
                cover[a:a + 16] += 1
    return cover[:D]


def _f32_slot(groups: int) -> int:
    """Floats of a ring slot: four 64 × 20 score chunks, or 16 rows of a
    piece of 64·groups columns (each row 4 floats longer)."""
    return max(4 * 64 * 20, 16 * (64 * groups + 4))


def _f32_steps(D: int, chunk: int) -> list:
    """The steps of one tile pair as the kernels walk them: ("score",
    first column of D) for each chunk, then ("rows", first row of the
    other tile) for each 16-row step of the accumulating operand."""
    return ([("score", c) for c in range(0, D, chunk)]
            + [("rows", r) for r in range(0, 64, 16)])


@pytest.mark.parametrize("D", WIDE_F32_DIMS)
def test_wide_f32_fwd_geometry_fits_and_covers_every_column_once(D):
    """The fp32 wide forward at D: shared memory within the 232,448 bytes
    a block may have, an instantiated group count, one piece up to D = 512
    (the scores once per tile pair), no piece wholly past D, every column
    of o written once and read once by each score product, every row of
    v's piece loaded once a tile pair (16 a step)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    g = fk.wide_f32_fwd_geometry(D)
    assert g.groups in fk.WIDE_F32_GROUPS
    assert g.smem_bytes == 4 * (4 * _f32_slot(g.groups) + 2 * 64 * 72
                                + 3 * 64) <= SMEM_OPT_IN
    # flash_attention_wide_fwd's checks of its geometry
    assert g.piece_cols == 64 * g.groups <= fk.WIDE_F32_PIECE_COLS
    assert g.pieces * g.piece_cols >= D > (g.pieces - 1) * g.piece_cols
    assert g.pieces == (1 if D <= 512 else 2)
    assert all(g.pieces * 64 * n < D for n in fk.WIDE_F32_GROUPS
               if n < g.groups)
    np.testing.assert_array_equal(_f32_piece_cover(D, g.pieces, g.groups), 1)
    np.testing.assert_array_equal(_f32_score_cover(D, 32, g), 1)
    rows = np.zeros(64, np.int64)
    for kind, r in _f32_steps(D, 32):
        if kind == "rows":
            rows[r:r + 16] += 1
    np.testing.assert_array_equal(rows, 1)


@pytest.mark.parametrize("D", WIDE_F32_DIMS)
def test_wide_f32_bwd_geometry_fits_and_covers_every_column_once(D):
    """The fp32 wide backward at D: the forward's pieces for dq, dv and dk
    (one up to D = 512, so each block's scores run once per tile pair),
    either kernel's shared memory within a block's 232,448 bytes; every
    column of dq, dv and dk written once, and read once by each score
    product (16-column steps of q, k, dO and v, a half a product; the dv
    blocks' k and q in 32-column steps, half a step a half); every row of the
    accumulating operand's piece (k, dO or q) loaded once a tile pair (16
    a step)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    g = fk.wide_f32_bwd_geometry(D)
    assert g[:3] == fk.wide_f32_fwd_geometry(D)[:3]
    assert g.smem_bytes == 4 * (4 * _f32_slot(g.groups) + 2 * 64 * 72
                                + 2 * 64) <= SMEM_OPT_IN
    # flash_attention_wide_bwd's checks of its geometry
    assert g.piece_cols == 64 * g.groups and g.groups in fk.WIDE_F32_GROUPS
    assert g.pieces * g.piece_cols >= D > (g.pieces - 1) * g.piece_cols
    # dq's pieces, then the dk/dv kernel's dv pieces and dk pieces
    for _ in ("dq", "dv", "dk"):
        np.testing.assert_array_equal(
            _f32_piece_cover(D, g.pieces, g.groups), 1)
    np.testing.assert_array_equal(_f32_score_cover(D, 16, g), 1)
    np.testing.assert_array_equal(_f32_score_cover(D, 32, g), 1)
    for chunk in (16, 32):
        rows = np.zeros(64, np.int64)
        for kind, r in _f32_steps(D, chunk):
            if kind == "rows":
                rows[r:r + 16] += 1
        np.testing.assert_array_equal(rows, 1)


def test_wide_f32_source_takes_the_geometry():
    """The fp32 kernels' shared memory, layouts and entry-point checks are
    the ones ``wide_f32_fwd_geometry``, ``wide_f32_bwd_geometry`` and the
    models above follow, and the first wide kernels are gone."""
    assert "static_assert(f32_fwd_smem(8) == 169728 && f32_bwd_smem(8) == " \
        "169472 &&" in WIDE_CU
    # a k-tile's dv pieces and dk pieces, each set a cluster where
    # f32_clustered: the model of _f32_score_cover
    assert "(Sk + kT - 1) / kT, 2 * pieces, pieces, Hq, B, stream" in WIDE_CU
    assert "return pieces > 1 && pieces <= kMaxCluster;" in WIDE_CU
    assert "constexpr int kMaxCluster = 8;" in WIDE_CU
    assert "const int col = c0 + 4 * cg + 64 * j;" in WIDE_CU
    assert "const float* st = ring + (g % kStages) * kSlot + 16 * half;" \
        in WIDE_CU
    assert "constexpr int kRowStep = 16;" in WIDE_CU
    for g in (5, 6, 8):
        assert f"case {g}: return WIDE_FWD_F32({g});" in WIDE_CU
        assert f"case {g}: WIDE_BWD_F32({g})" in WIDE_CU
    for gone in ("stage_chunk", "stage_slice", "outer4", "store_slice",
                 "wide_fwd_kernel<", "wide_dq_kernel<", "wide_dkv_kernel<",
                 "kFwdSmem", "kDqSmem", "kDkvSmem", "atomicAdd"):
        assert gone not in WIDE_CU, gone
