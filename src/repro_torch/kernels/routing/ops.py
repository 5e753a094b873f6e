"""Public routing entry points over the CUDA kernels.

Port of the JAX package's ``repro/kernels/routing/ops.py`` for the
single-device serving and training paths:

* ``dynamic_routing_procedure_fused`` / ``_stats`` — the whole-procedure
  kernel: one call for all iterations, û streamed at fp32, bf16 or int8
  (per-L-tile symmetric scale, ``quantize_u_stream``), optional per-tile
  early exit.
* ``dynamic_routing_fused`` — the per-iteration kernel in a loop with the
  Eq.3 squash between calls; the form ``fusion="iteration"`` and the
  non-fit fallback of ``fusion="auto"`` take.
* ``dynamic_routing_procedure_train`` — the differentiable procedure: an
  autograd Function whose forward is the procedure kernel at
  ``procedure_train_l_tile`` and saves only û, and whose backward is the
  recompute-b kernel ``routing_procedure_bwd``.
* ``dynamic_routing_fused_sharded`` / ``em_routing_fused`` — the
  stage-split form of sharded plans: per-shard stage kernels do the
  O(B·L·H·C) passes and this module puts the cross-shard collectives
  (``runtime.mesh_utils``) between them at exactly the paper's inter-vault
  aggregation points.  Both run as the per-rank body of
  ``mesh_utils.shard_call`` (the router's ``_core_fn``) or under an active
  mesh; with no sharded axes the collectives are the identity.  When
  neither B nor H is sharded, the next iteration's Eq.5 softmax folds into
  the update stage (``routing_stage_update_fold``).

``resolve_fusion`` is the single source of truth for the router's
``fusion="auto"`` knob.  The tile sizes are the reference's own
(``pick_l_tile``/``procedure_l_tile`` over its VMEM budgets): the int8
scales and the early-exit flags and counter are per L-tile, so the port
must cut û into the same tiles for those variants to mean the same thing.
Here the budgets are tile-size rules, not a memory limit of the H100;
what the card runs under each tile — row groups, batch chunks, clusters,
shared memory — is ``tile_geometry``, which the three wrappers of the
tile kernel read.  ``dma_bytes_per_call`` stays
the reference's analytic byte count.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from repro_torch.core import routing as routing_lib
from repro_torch.kernels.routing import ref
from repro_torch.kernels.routing.kernel import (check_no_autograd,
                                                em_stage_estep,
                                                em_stage_stats,
                                                routing_iteration_fused,
                                                routing_procedure_bwd,
                                                routing_procedure_fused,
                                                routing_stage_update,
                                                routing_stage_update_fold,
                                                routing_stage_votes)
from repro_torch.kernels.routing.vocab import (FUSION_LEVELS, STREAM_DTYPES,
                                               stream_itemsize as
                                               _stream_itemsize)
from repro_torch.runtime import mesh_utils

# the reference's tile-size budgets (ops.py:58-61): per-buffer û block and
# the procedure form's whole working set on one v5e core
_U_TILE_BUDGET = 8 * 2 ** 20
PROCEDURE_VMEM_BUDGET = 14 * 2 ** 20


def pick_l_tile(L: int, bytes_budget: int, row_bytes: int,
                preferred: int = 128) -> int:
    """Largest divisor of L that is <= preferred and fits the budget."""
    cap = max(1, bytes_budget // max(row_bytes, 1))
    lim = min(preferred, cap)
    best = 1
    i = 1
    while i * i <= L:
        if L % i == 0:
            for d in (i, L // i):
                if best < d <= lim:
                    best = d
        i += 1
    return best


def auto_l_tile(B: int, L: int, H: int, C: int, stream_dtype: str) -> int:
    """The l_tile the per-iteration wrapper picks."""
    return pick_l_tile(L, _U_TILE_BUDGET,
                       B * H * C * _stream_itemsize(stream_dtype))


def procedure_vmem_bytes(B: int, L: int, H: int, C: int, l_tile: int,
                         stream_dtype: str = "fp32",
                         early_exit: bool = False) -> int:
    """The reference's working-set model of the procedure kernel
    (double-buffered û block + resident b/v/s + output; early exit adds the
    frozen couplings and the per-tile flags)."""
    u_blk = B * l_tile * H * C * _stream_itemsize(stream_dtype)
    total = 2 * u_blk + L * H * 4 + 3 * B * H * C * 4
    if early_exit:
        total += L * H * 4 + (L // max(l_tile, 1)) * 4
    return total


def procedure_l_tile(B: int, L: int, H: int, C: int,
                     stream_dtype: str = "fp32", *,
                     early_exit: bool = False) -> int:
    """l_tile for the procedure kernel: the û block budget shrinks to what
    the working-set budget leaves after the resident b/v/s."""
    fixed = L * H * 4 * (2 if early_exit else 1) + 3 * B * H * C * 4
    budget = min(_U_TILE_BUDGET,
                 max(0, PROCEDURE_VMEM_BUDGET - fixed) // 2)
    return pick_l_tile(L, budget, B * H * C * _stream_itemsize(stream_dtype))


def procedure_bwd_vmem_bytes(B: int, L: int, H: int, C: int, l_tile: int,
                             iterations: int = 3,
                             stream_dtype: str = "fp32") -> int:
    """The reference's working-set model of the backward kernel
    (``ops.py:129``): double-buffered û and ∂û blocks, the b/v/s scratch
    (∂b / ∂v carry / ∂v accumulator in the reverse phase), the
    per-iteration snapshots — 2T logit-sized (c_t, ∂b_t) and 3T vote-sized
    (s_t, v_{t-1}, ∂s_t) — and the (B,H,C) cotangent block."""
    u_blk = B * l_tile * H * C * _stream_itemsize(stream_dtype)
    T = iterations
    return (4 * u_blk
            + (2 * T + 1) * L * H * 4
            + (3 * T + 3) * B * H * C * 4)


def procedure_train_l_tile(B: int, L: int, H: int, C: int,
                           iterations: int = 3,
                           stream_dtype: str = "fp32") -> int:
    """l_tile of the differentiable procedure (``ops.py:145``): like
    ``procedure_l_tile``, but the fixed cost is the backward's (snapshots
    included) and the tile budget splits four ways (û and ∂û, each
    double-buffered).  Forward and backward share this tile, so that the
    backward's replay reproduces the forward's b, c and v."""
    T = iterations
    fixed = (2 * T + 1) * L * H * 4 + (3 * T + 3) * B * H * C * 4
    budget = min(_U_TILE_BUDGET,
                 max(0, PROCEDURE_VMEM_BUDGET - fixed) // 4)
    return pick_l_tile(L, budget, B * H * C * _stream_itemsize(stream_dtype))


# The H100's limits that shape the tile kernel's launch (csrc/routing.cu):
# 132 SMs of 2048 threads, 228 KB of shared memory an SM of which 1 KB is
# the runtime's per block, at most 227 KB a block, clusters of at most 8
# blocks (portable).  The tile kernel runs 512 threads a block.
SM_COUNT = 132
SM_THREADS = 2048
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
MAX_BLOCK_SMEM = 232448
MAX_CLUSTER = 8
MAX_GRID_Y = 65535
TILE_THREADS = 512
# the tile kernel's static shared memory (block-max scratch, two mbarriers,
# the softmax's per-row scalars), rounded up
_TILE_STATIC_SMEM = 2176


def tile_blocks_per_sm(smem_bytes: int) -> int:
    """Tile blocks one SM holds at once, by shared memory and threads."""
    return min(SM_THREADS // TILE_THREADS,
               SM_SMEM_BYTES // (smem_bytes + BLOCK_RESERVED_SMEM
                                 + _TILE_STATIC_SMEM))


@dataclass(frozen=True)
class TileGeometry:
    """The launch geometry of the routing tile kernel under one reference
    tile size: a (row group, batch chunk) cell is ``rows`` L-rows of one
    reference tile (rows divides l_tile) by ``batch_chunk`` batch rows;
    the ``cluster`` blocks of a thread-block cluster take the batch chunks
    of one row group, and each cluster walks row groups ``slots`` apart.
    ``staged`` says whether a block copies its û sub-block into shared
    memory (two buffers: the next group's copy overlaps this group's
    work); ``smem_bytes`` is the block's dynamic shared memory.  ``slots``
    bounds the clusters launched: the kernel lowers it to the clusters the
    card holds at once (``routing.cu::resolve_slots``), and each cluster
    adds its groups' Eq.2 into its own (B, H, C) slice of the partials."""
    rows: int
    batch_chunk: int
    cluster: int
    staged: bool
    smem_bytes: int
    groups: int                # L / rows
    slots: int                 # clusters the card holds at once, ≤ groups

    @property
    def blocks(self) -> int:
        """Blocks launched if the card holds ``slots`` clusters at once;
        the kernel asks the runtime for that number at launch time."""
        return self.slots * self.cluster

    def partial_shape(self, B: int, H: int, C: int) -> tuple:
        """The fp32 partial-sum scratch a wrapper of the tile kernel
        allocates: one (B, H, C) slice per slot (the backward's replay and
        reverse sweep share it)."""
        return (self.slots, B, H, C)


def tile_smem_bytes(rows: int, batch_chunk: int, H: int, C: int,
                    itemsize: int, staged: bool) -> int:
    """Dynamic shared memory of one tile block (``routing.cu::
    tile_smem_bytes``), fp32: the (rows, H·C) Eq.4 column sums and four
    (rows, H) buffers (two parts of Eq.4, two of b rows); staged, also two
    û sub-blocks, each 16-byte aligned, and the block's (batch_chunk, H·C)
    v_prev rows and Eq.2 sums."""
    stage = -(-batch_chunk * rows * H * C * itemsize // 16) * 16
    return (4 * (rows * H * C + 4 * rows * H)
            + (2 * stage + 4 * 2 * batch_chunk * H * C if staged else 0))


@functools.lru_cache(maxsize=256)   # every wrapper call asks; pure in ints
def tile_geometry(B: int, L: int, H: int, C: int, l_tile: int,
                  stream_dtype: str = "fp32") -> TileGeometry:
    """The tile kernel's launch geometry at one reference tile size.

    Staged blocks two of which share an SM, else one an SM, else unstaged
    blocks; within the first of these that fits, a staged block takes
    every batch row where it can (no cluster exchange), else B splits
    over a cluster of min(8, B) blocks; then the largest rows dividing
    ``l_tile`` that still launch a block for every SM (the largest that
    fit where none does).  Fewer, larger row groups ran faster on the H100
    at every Caps-MN1 shape tried (a group's barriers, exchange and
    softmax cost about as much as its arithmetic).  Raises where nothing
    fits."""
    if B < 1 or l_tile < 1 or L % l_tile:
        raise ValueError(f"bad routing shape B={B}, L={L}, l_tile={l_tile}")
    item = _stream_itemsize(stream_dtype)
    divisors = [d for d in range(1, l_tile + 1) if l_tile % d == 0
                and d <= TILE_THREADS and L // d <= MAX_GRID_Y]
    two_a_sm = (SM_SMEM_BYTES // 2 - BLOCK_RESERVED_SMEM
                - _TILE_STATIC_SMEM)
    one_a_sm = MAX_BLOCK_SMEM - _TILE_STATIC_SMEM
    def geometry(r: int, kb: int, cluster: int, staged: bool):
        smem = tile_smem_bytes(r, kb, H, C, item, staged)
        slots = max(1, min(L // r,
                           SM_COUNT * tile_blocks_per_sm(smem) // cluster))
        return TileGeometry(rows=r, batch_chunk=kb, cluster=cluster,
                            staged=staged, smem_bytes=smem, groups=L // r,
                            slots=slots)

    for staged, limit in ((True, two_a_sm), (True, one_a_sm),
                          (False, one_a_sm)):
        for parts in sorted({1, min(MAX_CLUSTER, B)}) if staged else \
                (min(MAX_CLUSTER, B),):
            kb = -(-B // parts)
            cluster = -(-B // kb)
            fit = [geometry(r, kb, cluster, staged) for r in divisors
                   if tile_smem_bytes(r, kb, H, C, item, staged) <= limit]
            full = [geo for geo in fit if geo.blocks >= SM_COUNT]
            if fit:
                return max(full or fit, key=lambda geo: geo.rows)
    raise ValueError(
        f"one L-row of H·C = {H * C} couplings and column sums does not "
        f"fit one block's shared memory ({MAX_BLOCK_SMEM} bytes), or "
        f"L/l_tile = {L // l_tile} rows exceed the grid")


# The E-step kernel (csrc/em_routing.cu): blocks of 8 warps, two blocks an
# SM in a persistent grid; a lane owns one (row, h) — one h of each 32
# where H > 32 — and the kernel is built for up to 8 of them a lane.  Wider
# rows go to the wide kernel, which walks H in passes of this many h.
ESTEP_THREADS = 256
ESTEP_BLOCKS_PER_SM = 2
ESTEP_PASS_H = 256


@dataclass(frozen=True)
class EstepGeometry:
    """The launch geometry of the EM E-step kernel: a warp takes a pass of
    ``rows_per_pass`` consecutive (b, l) rows at once (lane = row-in-pass ·
    H + h), or one row with ``h_per_lane`` h a lane where H > 32; warp w
    takes the passes [w·P/W, (w+1)·P/W) of the ``passes`` P over the
    ``warps`` W of ``blocks`` blocks.  Where H > 256 the wide kernel walks
    a row in ``h_passes`` passes of 256 h (8 a lane: h = 256·pass + 32·j +
    lane); else ``h_passes`` is 1.  ``vector`` is 4 where a lane reads its
    C votes as 16-byte loads (C a multiple of 4 up to 16, and at most two h
    a lane, whose μ and 1/σ² stay in registers, or the wide kernel, which
    reads them with the votes), else 1; the wrapper drops to 1 for operands
    that are not 16-byte aligned."""
    rows_per_pass: int
    h_per_lane: int
    vector: int
    passes: int
    warps: int
    blocks: int
    h_passes: int = 1

    def warp_rows(self, w: int, n_rows: int) -> range:
        """The (b·L + l) rows warp ``w`` takes, as the kernel splits them."""
        p0 = w * self.passes // self.warps
        p1 = (w + 1) * self.passes // self.warps
        return range(p0 * self.rows_per_pass,
                     min(n_rows, p1 * self.rows_per_pass))


@functools.lru_cache(maxsize=256)   # every E-step call asks; pure in ints
def estep_geometry(B: int, L: int, H: int, C: int) -> EstepGeometry:
    """The E-step kernel's launch geometry for votes (B, L, H, C): as many
    warps as there are passes, up to two blocks on every SM; any H (above
    ``ESTEP_PASS_H`` the wide kernel, in h-passes)."""
    if min(B, L, H, C) < 1:
        raise ValueError(f"bad E-step shape B={B}, L={L}, H={H}, C={C}")
    wide = H > ESTEP_PASS_H
    rows = 32 // H if H <= 32 else 1
    nh = ESTEP_PASS_H // 32 if wide else -(-H // 32)
    passes = -(-B * L // rows)
    wpb = ESTEP_THREADS // 32
    warps = min(passes, SM_COUNT * ESTEP_BLOCKS_PER_SM * wpb)
    vector = 4 if C % 4 == 0 and C <= 16 and (nh <= 2 or wide) else 1
    return EstepGeometry(rows_per_pass=rows, h_per_lane=nh, vector=vector,
                         passes=passes, warps=warps, blocks=-(-warps // wpb),
                         h_passes=-(-H // ESTEP_PASS_H) if wide else 1)


# The stage-update kernel (csrc/routing_stage.cu): at most 512 threads a
# block under __launch_bounds__(512, 3), so a thread holds at most 40
# registers (65536 / (3·512), rounded down to the allocation unit of 8)
# and three full blocks share an SM.
STAGE_UPDATE_THREADS = 512
STAGE_UPDATE_REGS = 40
# û bytes in flight an SM that kept HBM busy in the H100 sweeps of
# scripts/stage_update_variants.py (PERF.md)
STAGE_UPDATE_INFLIGHT_BYTES = 24 * 1024
# û runs in flight a thread (routing_stage.cu's kRingRegisters and
# kRingShared): two in registers, or four in a ring of 16-byte slots in
# shared memory, which costs no registers and ran faster on the H100 for
# batch slices of this many rows or more (Caps-EN3 and Caps-CF3 at B=100,
# 50–100 rows a slice) and slower for shorter ones (Caps-MN1, 17–34)
STAGE_UPDATE_RING = {False: 2, True: 4}
STAGE_UPDATE_SHARED_RING_ROWS = 48
# the kernel's static shared memory: two mbarriers
_STAGE_STATIC_SMEM = 16
# a staging of v is at most this many bytes a block (at least one group of
# batch rows a slice): the first one is waited for, the rest arrive while
# the block works on the one before
STAGE_UPDATE_STAGING_BYTES = 16384


@dataclass(frozen=True)
class StageUpdateGeometry:
    """The launch geometry of the stage-update kernel: block k owns the
    ``rows`` L-rows [k·rows, (k+1)·rows) with all of H, ``blocks`` =
    ceil(L / rows).  A thread owns a run of ``vector`` consecutive (l, h,
    c) elements of them for one of ``slices`` batch slices (thread t:
    slice t // (rows·cols / vector), run t % that); where a row holds more
    runs than a block has threads, one row a block, walked in ``passes``
    segments of ``cols`` columns (else one pass, ``cols`` = H·C).  Slice s
    holds the batch rows ``slice_rows(s)``, ``unroll`` of them in flight a
    thread, in registers or, with ``smem_ring``, in a ring of
    shared-memory slots.  v of ``chunk_rows`` batch rows of every slice (a
    multiple of ``unroll`` where there are several stagings) is staged in
    shared memory at a time, ``chunks`` stagings a pass, in two buffers
    (the next staging's copies run while the block works on this one); the
    same bytes then hold the slices' partial sums.  ``smem_bytes`` is the
    block's dynamic shared memory."""
    rows: int
    slices: int
    passes: int
    cols: int
    threads: int
    blocks: int
    vector: int
    smem_ring: bool
    unroll: int
    chunk_rows: int
    chunks: int
    smem_bytes: int
    blocks_per_sm: int

    def slice_rows(self, s: int, B: int) -> range:
        """The batch rows of slice ``s``, summed in this order."""
        return range(s * B // self.slices, (s + 1) * B // self.slices)


def stage_update_smem_bytes(rows: int, slices: int, chunk_rows: int,
                            cols: int, H: int, passes: int, threads: int,
                            smem_ring: bool) -> int:
    """Dynamic shared memory of one stage-update block (``routing_stage.cu
    ::UpdateSmem``): two stagings of v, ``chunk_rows`` batch rows a slice
    and ``cols`` columns each, or the slices' (rows, cols) partial sums of
    a pass, whichever is larger; the fold's (rows, H) logits; with several
    passes, the (rows, H) sums over C so far; then, with ``smem_ring``,
    the ring of 16-byte û slots of every thread."""
    stage = slices * chunk_rows * cols
    sums = rows * H if passes > 1 else 0
    ring = -(-(max(2 * stage, slices * rows * cols) + rows * H + sums)
             // 4) * 4
    return 4 * ring + (16 * STAGE_UPDATE_RING[True] * threads if smem_ring
                       else 0)


def stage_update_blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """Stage-update blocks one SM holds at once, by threads, registers and
    shared memory."""
    warps = -(-threads // 32)
    return min(SM_THREADS // (32 * warps),
               65536 // (STAGE_UPDATE_REGS * 32 * warps),
               SM_SMEM_BYTES // (smem_bytes + _STAGE_STATIC_SMEM
                                 + BLOCK_RESERVED_SMEM))


def _stage_update_candidate(B: int, L: int, H: int, C: int, item: int,
                            vector: int, rows: int, slices: int):
    """(geometry, estimated cost) of one (rows, slices) of the
    stage-update kernel, or None where no staging of v fits."""
    HC = H * C
    passes = -(-HC // vector // STAGE_UPDATE_THREADS)
    pruns = -(-HC // vector // passes)      # a row's runs in one pass
    cols = pruns * vector
    sums = rows * H if passes > 1 else 0
    per_slice = -(-B // slices)
    smem_ring = per_slice >= STAGE_UPDATE_SHARED_RING_ROWS
    unroll = STAGE_UPDATE_RING[smem_ring]
    threads = -(-slices * rows * pruns // 32) * 32
    warps = threads // 32
    most = min(SM_THREADS // threads,
               65536 // (STAGE_UPDATE_REGS * 32 * warps))
    ring = 16 * unroll * threads if smem_ring else 0
    for bps in range(most, 0, -1):
        budget = min(MAX_BLOCK_SMEM, SM_SMEM_BYTES // bps
                     - BLOCK_RESERVED_SMEM) - _STAGE_STATIC_SMEM
        fit = ((budget - ring) // 4 - rows * H - sums - 3) // (
            2 * slices * cols)
        want = STAGE_UPDATE_STAGING_BYTES // (4 * slices * cols)
        kr = min(per_slice, fit, max(unroll, want - want % unroll))
        if kr < per_slice:   # several stagings: at least a ring each
            kr -= kr % unroll
        if kr >= 1 and stage_update_smem_bytes(
                rows, slices, kr, cols, H, passes, threads,
                smem_ring) <= budget:
            break
    else:
        return None
    smem = stage_update_smem_bytes(rows, slices, kr, cols, H, passes,
                                   threads, smem_ring)
    bps = stage_update_blocks_per_sm(threads, smem)
    blocks = -(-L // rows)
    busy = min(blocks, SM_COUNT)
    eff = busy / SM_COUNT       # the share of SMs with a block
    if per_slice > 4 * unroll:  # a few rings of rows: latency-bound anyway
        threads_per_sm = (min(blocks / busy, bps)
                          * slices * rows * pruns)
        eff *= min(1.0, threads_per_sm * unroll * 16
                   / STAGE_UPDATE_INFLIGHT_BYTES)
    # the staged v's bytes (L2 reads) count as û's (HBM reads): blocks that
    # staged v for fewer rows slowed as much as that says on the H100
    cost = (1 + 4 / (rows * item)) / eff
    return StageUpdateGeometry(
        rows=rows, slices=slices, passes=passes, cols=cols, threads=threads,
        blocks=blocks, vector=vector, smem_ring=smem_ring, unroll=unroll,
        chunk_rows=kr, chunks=-(-per_slice // kr), smem_bytes=smem,
        blocks_per_sm=bps), cost


@functools.lru_cache(maxsize=256)   # every wrapper call asks; pure in ints
def stage_update_geometry(B: int, L: int, H: int, C: int,
                          stream_dtype: str = "fp32", *,
                          aligned: bool = True) -> StageUpdateGeometry:
    """The stage-update kernel's launch geometry for û (B, L, H, C).

    A thread reads 16 bytes at a time (4 fp32 or 8 bf16 elements) where
    H·C divides into such runs and ``aligned`` says the operands allow it,
    else one element.  Over every (slices, rows) whose block fits 512
    threads, with stagings of v of ``STAGE_UPDATE_STAGING_BYTES`` (fewer
    where the shared memory of ``blocks_per_sm`` blocks is short), it
    picks the least estimated time: the bytes a block reads (û and the
    staged v, ∝ 1 + 4/(rows·itemsize)) over the share of the card that
    streams — the SMs with a block, times the û bytes in flight an SM
    (resident threads × ring depth × 16) against
    ``STAGE_UPDATE_INFLIGHT_BYTES``, which slices of at most four rings of
    rows do not need; ties go to more rows, then fewer slices.  A row of
    more runs than 512 takes one row a block in the fewest passes of at
    most 512 runs.  Raises where no block's shared memory holds the
    shape (H in the tens of thousands)."""
    if min(B, L, H, C) < 1:
        raise ValueError(f"bad stage shape B={B}, L={L}, H={H}, C={C}")
    item = _stream_itemsize(stream_dtype)
    if item not in (2, 4):
        raise ValueError(f"the stage-update kernel streams fp32 or bf16; "
                         f"got {stream_dtype}")
    HC = H * C
    vector = 16 // item if aligned and HC % (16 // item) == 0 else 1
    runs = HC // vector
    pruns = -(-runs // -(-runs // STAGE_UPDATE_THREADS))
    best, best_key = None, None
    for slices in range(1, min(B, STAGE_UPDATE_THREADS // pruns) + 1):
        most_rows = (min(L, STAGE_UPDATE_THREADS // (slices * pruns))
                     if pruns == runs else 1)
        for rows in range(1, most_rows + 1):
            got = _stage_update_candidate(B, L, H, C, item, vector, rows,
                                          slices)
            if got is None:
                continue
            geo, cost = got
            key = (round(cost, 9), -rows, slices)
            if best_key is None or key < best_key:
                best, best_key = geo, key
    if best is None:
        raise ValueError(f"no stage-update block holds H = {H}, C = {C} in "
                         f"its shared memory")
    return best


def resolve_fusion(fusion: str, shape, stream_dtype: str = "fp32",
                   sharded: bool = False, early_exit: bool = False) -> str:
    """Resolve a RouterSpec ``fusion`` knob to the concrete kernel form.

    Returns "procedure" | "iteration" for shard-local execution and
    "stage_split" under a sharded plan, where the stage kernels are the
    only legal form (the procedure kernel cannot surface for the Table-2
    collectives).  ``fusion="auto"`` picks the procedure kernel when the
    plan is shard-local and the reference's working-set model fits at
    ``procedure_l_tile``; int8 streaming and early exit exist only in the
    procedure kernel, so they resolve "auto" to "procedure"
    unconditionally and raise under a sharded plan or an explicit
    ``fusion="iteration"``."""
    if fusion not in FUSION_LEVELS:
        raise ValueError(f"unknown fusion level {fusion!r}; expected one of "
                         f"{FUSION_LEVELS}")
    deep_edge = stream_dtype == "int8" or early_exit
    if sharded:
        if fusion == "procedure":
            raise ValueError(
                "fusion='procedure' is shard-local (the megakernel keeps "
                "b/v/s in VMEM and cannot surface for the Table-2 psums); "
                "use fusion='auto' or 'iteration' with sharded plans")
        if stream_dtype == "int8":
            raise ValueError(
                "stream_dtype='int8' is shard-local: only the procedure "
                "megakernel has a dequant path, and it cannot surface for "
                "the Table-2 psums; use an unsharded plan (plan=None or "
                "'auto')")
        if early_exit:
            raise ValueError(
                "early-exit routing is shard-local: the per-tile "
                "convergence scratch lives in the procedure megakernel, "
                "which cannot surface for the Table-2 psums; use an "
                "unsharded plan (plan=None or 'auto')")
        return "stage_split"
    if fusion != "auto":
        if fusion == "iteration" and deep_edge:
            knob = ("stream_dtype='int8'" if stream_dtype == "int8"
                    else "early_exit_eps")
            raise ValueError(
                f"{knob} requires the procedure megakernel; "
                "fusion='iteration' has no "
                + ("dequant path" if stream_dtype == "int8"
                   else "per-tile convergence scratch")
                + " — use fusion='auto' or 'procedure'")
        return fusion
    if deep_edge:
        return "procedure"
    if shape is None:
        raise ValueError("fusion='auto' needs the votes shape to resolve")
    B, L, H, C = shape
    l_tile = procedure_l_tile(B, L, H, C, stream_dtype)
    fits = (procedure_vmem_bytes(B, L, H, C, l_tile, stream_dtype)
            <= PROCEDURE_VMEM_BUDGET)
    return "procedure" if fits else "iteration"


def dma_bytes_per_call(B: int, L: int, H: int, C: int,
                       iterations: int = 3, *, form: str = "iteration",
                       stream_dtype: str = "fp32",
                       fold: bool = False,
                       backward: bool = False,
                       early_exit_work_fraction: Optional[float] = None
                       ) -> dict:
    """The reference's analytic traffic count per routing call
    (``ops.py:225``).

    * ``iteration`` — û streams once per iteration at the stream itemsize;
      the (L,H) logits and (B,H,C) blocks round-trip:
      iterations · (2·LH + 4·BHC) · 4 bytes.
    * ``procedure`` — û streams once per iteration; only the final v is
      written: BHC · 4 bytes.  ``early_exit_work_fraction`` scales the û
      term by the measured effective-tile-iterations fraction.
    * ``stage_split`` — û crosses twice per iteration (once per stage: the
      price of distribution) and the inter-stage tensors at each host or
      collective boundary: c and db written and read (4·LH), b read and
      written (2·LH), s written and read and v written (3·BHC) per
      iteration.  ``fold=True`` models the softmax-folded update stage
      (taken where neither B nor H is sharded): no db crosses, so the
      logit-sized terms drop from 6·LH to 4·LH.

    * ``backward=True`` (procedure form, fp32/bf16) — the recompute-b
      backward: û streams 2T times (T replay + T reverse passes), a
      û-sized ∂û is written once at the stream dtype and the (B,H,C) fp32
      cotangent is read; ``naive_bytes`` models unfused autodiff of the
      same procedure.

    The port's forward kernels read û once per iteration and add the
    (slots, B, H, C) partial sums (``tile_geometry``); the backward's
    replay and reverse sweep read it once per launch on the same geometry,
    2T − 1 passes (the source notes in ``csrc/routing.cu`` and
    ``csrc/routing_bwd.cu``).  This count is the reference's stream model,
    the bound a one-pass kernel would meet.
    """
    f = 4
    u = B * L * H * C * _stream_itemsize(stream_dtype)
    bh = L * H * f
    vhc = B * H * C * f
    u_f32 = B * L * H * C * 4
    if stream_dtype == "int8" and form != "procedure":
        raise ValueError(
            "stream_dtype='int8' is a procedure-megakernel tier (no other "
            f"form has a dequant path); got form={form!r}")
    if early_exit_work_fraction is not None:
        if form != "procedure" or backward:
            raise ValueError(
                "early_exit_work_fraction models the forward procedure "
                f"megakernel only; got form={form!r}, backward={backward}")
        if not 0.0 < early_exit_work_fraction <= 1.0:
            raise ValueError(
                "early_exit_work_fraction must be in (0, 1] (= eff / "
                f"(iterations * L_tiles)); got {early_exit_work_fraction}")
    if backward:
        if form != "procedure":
            raise ValueError(
                "backward=True models the recompute-b VJP of the procedure "
                f"megakernel only (form={form!r} has no custom VJP)")
        if stream_dtype == "int8":
            raise ValueError(
                "backward=True has no int8 form: quantization rounding is "
                "non-differentiable and the backward megakernel has no "
                "dequant path (DESIGN.md §Quantized-routing)")
        return {
            "form": form,
            "fold": fold,
            "stream_dtype": stream_dtype,
            "backward": True,
            "u_hat_stream_bytes": 2 * iterations * u,
            "du_stream_bytes": u,
            "roundtrip_bytes": vhc,
            "total_bytes": 2 * iterations * u + u + vhc,
            "u_hat_bytes": u_f32,
            "naive_bytes": iterations * (2 * u_f32 + 2 * u_f32
                                         + 2 * (2 * bh + 2 * vhc)),
        }
    if form == "iteration":
        u_stream = iterations * u
        roundtrip = iterations * (2 * bh + 4 * vhc)
    elif form == "procedure":
        u_stream = iterations * u
        if early_exit_work_fraction is not None:
            u_stream = int(round(u_stream * early_exit_work_fraction))
        roundtrip = vhc
    elif form == "stage_split":
        u_stream = iterations * 2 * u
        roundtrip = iterations * ((4 if fold else 6) * bh + 3 * vhc)
    else:
        raise ValueError(f"unknown form {form!r}; expected 'iteration', "
                         "'procedure' or 'stage_split'")
    if fold and form != "stage_split":
        raise ValueError("fold=True models the softmax-folded STAGE 2 of "
                         f"the stage_split form only; got form={form!r}")
    return {
        "form": form,
        "fold": fold,
        "stream_dtype": stream_dtype,
        "backward": False,
        "early_exit_work_fraction": early_exit_work_fraction,
        "u_hat_stream_bytes": u_stream,
        "roundtrip_bytes": roundtrip,
        "total_bytes": u_stream + roundtrip,
        "u_hat_bytes": u_f32,
        "naive_bytes": iterations * (2 * u_f32 + 2 * bh + 4 * vhc
                                     + 2 * B * L * H * f),
    }


def dynamic_routing_fused(u_hat: torch.Tensor, *, iterations: int = 3,
                          use_approx: bool = False,
                          l_tile: Optional[int] = None,
                          stream_dtype: str = "fp32") -> torch.Tensor:
    """The routing procedure from the per-iteration kernel.

    u_hat (B,L,H,C) -> v (B,H,C).  û is cast to the stream dtype once; b and
    v stay on the device between calls; squash (Eq.3) runs between them."""
    u_hat = u_hat.to(STREAM_DTYPES[stream_dtype]).contiguous()
    B, L, H, C = u_hat.shape
    if l_tile is None:
        l_tile = auto_l_tile(B, L, H, C, stream_dtype)
    b = torch.zeros((L, H), dtype=torch.float32, device=u_hat.device)
    v = torch.zeros((B, H, C), dtype=torch.float32, device=u_hat.device)
    for _ in range(iterations):
        s, b = routing_iteration_fused(u_hat, b, v, l_tile=l_tile,
                                       use_approx=use_approx)
        v = ref.squash(s, use_approx)
    return v


def quantize_u_stream(u_hat: torch.Tensor, l_tile: int):
    """Per-L-tile symmetric int8 quantisation of the û stream.

    Each block of ``l_tile`` L-rows — one kernel tile — shares one fp32
    scale, max|û_tile| / 127 (1/127 for an all-zero tile); codes are
    round-half-to-even, clipped to [-127, 127].  Returns (codes int8
    (B,L,H,C), contiguous whatever û's strides — the kernel reads them
    as laid out — and scales fp32 (L/l_tile, 1))."""
    B, L, H, C = u_hat.shape
    if L % l_tile != 0:
        raise ValueError(f"L={L} not divisible by l_tile={l_tile}")
    n = L // l_tile
    u = u_hat.float().reshape(B, n, l_tile, H, C)
    absmax = torch.amax(torch.abs(u), dim=(0, 2, 3, 4))          # (n,)
    # times fp32(1/127): the reference's jitted "/ 127.0" compiles to this
    # multiply, and the scales must match it bit for bit
    scale = torch.where(absmax > 0.0, absmax,
                        torch.ones_like(absmax)) * (1.0 / 127.0)
    q = torch.clamp(torch.round(u / scale[None, :, None, None, None]),
                    -127.0, 127.0).to(torch.int8)
    return q.reshape(B, L, H, C).contiguous(), scale.reshape(n, 1)


def _procedure_call(u_hat, iterations, use_approx, l_tile, stream_dtype,
                    early_exit_eps):
    """Tile pick, stream cast or int8 quantisation, kernel call.  Returns
    (v, effective tile-iterations) — the fixed-grid count when early exit
    is off."""
    check_no_autograd(u_hat, "routing_procedure_fused")
    B, L, H, C = u_hat.shape
    early_exit = early_exit_eps is not None
    if l_tile is None:
        l_tile = procedure_l_tile(B, L, H, C, stream_dtype,
                                  early_exit=early_exit)
    if stream_dtype == "int8":
        q, scales = quantize_u_stream(u_hat, l_tile)
        out = routing_procedure_fused(q, scales, iterations=iterations,
                                      l_tile=l_tile, use_approx=use_approx,
                                      early_exit_eps=early_exit_eps)
    else:
        u = u_hat.to(STREAM_DTYPES[stream_dtype]).contiguous()
        out = routing_procedure_fused(u, iterations=iterations,
                                      l_tile=l_tile, use_approx=use_approx,
                                      early_exit_eps=early_exit_eps)
    if early_exit:
        return out
    return out, torch.tensor(iterations * (L // l_tile), dtype=torch.int32,
                             device=u_hat.device)


def dynamic_routing_procedure_fused(u_hat: torch.Tensor, *,
                                    iterations: int = 3,
                                    use_approx: bool = False,
                                    l_tile: Optional[int] = None,
                                    stream_dtype: str = "fp32",
                                    early_exit_eps: Optional[float] = None
                                    ) -> torch.Tensor:
    """Whole-procedure kernel: u_hat (B,L,H,C) -> v (B,H,C).

    ``stream_dtype`` "fp32" | "bf16" | "int8" (accumulation always fp32);
    ``early_exit_eps`` skips the Eq.4/Eq.5 work of L-tiles whose logit
    update has converged (‖Δb‖∞ < ε after iteration 0; ε = 0 is the fixed
    grid).  :func:`dynamic_routing_procedure_stats` also returns the work
    counter."""
    v, _ = _procedure_call(u_hat, iterations, use_approx, l_tile,
                           stream_dtype, early_exit_eps)
    return v


def dynamic_routing_procedure_stats(u_hat: torch.Tensor, *,
                                    iterations: int = 3,
                                    use_approx: bool = False,
                                    l_tile: Optional[int] = None,
                                    stream_dtype: str = "fp32",
                                    early_exit_eps: Optional[float] = None):
    """:func:`dynamic_routing_procedure_fused` plus the int32 count of
    (iteration, L-tile) cells that did Eq.4/Eq.5 work."""
    return _procedure_call(u_hat, iterations, use_approx, l_tile,
                           stream_dtype, early_exit_eps)


# ---------------------------------------------------------------------------
# Differentiable procedure (the reference's ops.py:487-558)
# ---------------------------------------------------------------------------

class _ProcedureTrain(torch.autograd.Function):
    """Recompute-b: the forward is ``routing_procedure_fused`` unchanged and
    saves only û; the backward is ``routing_procedure_bwd``, which replays
    the routing loop instead of reading per-iteration residuals."""

    @staticmethod
    def forward(ctx, u_hat, iterations, l_tile, use_approx):
        ctx.cfg = (iterations, l_tile, use_approx)
        ctx.save_for_backward(u_hat)
        return routing_procedure_fused(u_hat, iterations=iterations,
                                       l_tile=l_tile, use_approx=use_approx)

    @staticmethod
    def backward(ctx, g):
        (u_hat,) = ctx.saved_tensors
        iterations, l_tile, use_approx = ctx.cfg
        du = routing_procedure_bwd(u_hat, g.float().contiguous(),
                                   iterations=iterations, l_tile=l_tile,
                                   use_approx=use_approx)
        return du, None, None, None


def dynamic_routing_procedure_train(u_hat: torch.Tensor, *,
                                    iterations: int = 3,
                                    use_approx: bool = False,
                                    l_tile: Optional[int] = None,
                                    stream_dtype: str = "fp32"
                                    ) -> torch.Tensor:
    """Differentiable whole-procedure kernel: u_hat (B,L,H,C) -> v (B,H,C),
    with ``torch.autograd`` flowing through the recompute-b backward kernel.

    ``stream_dtype`` applies to both directions (û streams at it; ∂û comes
    back at it, accumulated in fp32).  The cast sits outside the autograd
    Function, so autograd carries a bf16 ∂û back to the caller's fp32.  The
    tile is ``procedure_train_l_tile``, shared by forward and backward.
    ``use_approx=True`` gets the exact-squash/softmax surrogate gradient, as
    in the reference; the router refuses it with ``differentiable=True``."""
    if stream_dtype == "int8":
        raise ValueError(
            "stream_dtype='int8' has no custom VJP: per-tile quantization "
            "rounds û (round-to-nearest has no derivative) and the backward "
            "megakernel has no dequant path (DESIGN.md §Quantized-routing); "
            "train at 'fp32'/'bf16' and serve int8")
    u_hat = u_hat.to(STREAM_DTYPES[stream_dtype]).contiguous()
    B, L, H, C = u_hat.shape
    if l_tile is None:
        l_tile = procedure_train_l_tile(B, L, H, C, iterations, stream_dtype)
    return _ProcedureTrain.apply(u_hat, iterations, l_tile, use_approx)


# ---------------------------------------------------------------------------
# Sharded routing through the stage kernels (the reference's ops.py:561-638)
# ---------------------------------------------------------------------------

def _softmax_h(b: torch.Tensor, h_axis: Optional[str],
               use_approx: bool) -> torch.Tensor:
    """Eq.5 softmax over H of b (L,H), cross-shard (pmax and psum) when H
    is sharded.  O(L·H), next to the O(B·L·H·C) stages, so it runs as
    PyTorch operations between them, through the torch path's own
    collective-aware softmax.  Where neither B nor H is sharded it does
    not run at all: the fold kernel emits the next iteration's c."""
    cfg = routing_lib.RoutingConfig(
        use_approx=use_approx,
        axes=(("H", h_axis),) if h_axis is not None else None)
    return routing_lib._softmax(b, cfg)


def dynamic_routing_fused_sharded(u_hat: torch.Tensor, *,
                                  axes: Mapping[str, str],
                                  iterations: int = 3,
                                  use_approx: bool = False,
                                  l_tile: Optional[int] = None,
                                  stream_dtype: str = "fp32"
                                  ) -> torch.Tensor:
    """Stage-split routing with the cross-shard aggregation of Table 2.

    u_hat: this rank's (B, L, H, C) block — the function runs as the body
    of ``mesh_utils.shard_call`` or under an active mesh.  ``axes`` maps
    each sharded logical dim ("B" | "L" | "H") to its mesh axis, and the
    matching collective runs at the paper's inter-vault aggregation point:

        shard L -> psum of the partial vote sums s   (after the votes stage)
        shard B -> psum of the logit updates db      (after the update stage)
        shard H -> pmax and psum in the softmax      (between the stages)

    Per iteration û crosses HBM twice (once per stage) instead of the
    unsharded kernel's once — the distribution cost the paper pays as
    crossbar traffic M.  The stream-dtype cast runs once, outside the
    iteration loop; where neither B nor H is sharded the update stage folds
    the next iteration's softmax into its û pass.  Returns v (B_local,
    H_local, C)."""
    u_hat = u_hat.to(STREAM_DTYPES[stream_dtype]).contiguous()
    B, L, H, C = u_hat.shape
    if l_tile is None:
        l_tile = auto_l_tile(B, L, H, C, stream_dtype)
    b_axis, h_axis, l_axis = axes.get("B"), axes.get("H"), axes.get("L")
    # the fold needs the complete db (no pending B psum) and a shard-local
    # softmax denominator (no H collective) inside the kernel
    fold = b_axis is None and h_axis is None
    b = torch.zeros((L, H), dtype=torch.float32, device=u_hat.device)
    v = None
    c = None
    for _ in range(iterations):
        if c is None:
            c = _softmax_h(b, h_axis, use_approx)                  # Eq.5
        s = routing_stage_votes(u_hat, c, l_tile=l_tile)          # Eq.2
        s = mesh_utils.psum(s, l_axis)
        if fold:
            v, b, c = routing_stage_update_fold(
                u_hat, s, b, l_tile=l_tile, use_approx=use_approx)  # Eq.3-5
        else:
            v, db = routing_stage_update(u_hat, s, l_tile=l_tile,
                                         use_approx=use_approx)   # Eq.3+4
            b = b + mesh_utils.psum(db, b_axis)
            c = None                            # softmax on the host next
    return v


# ---------------------------------------------------------------------------
# EM routing through the stage kernels (the reference's ops.py:641-691)
# ---------------------------------------------------------------------------

def em_routing_fused(votes: torch.Tensor, a_in: torch.Tensor, *,
                     axes: Mapping[str, str], iterations: int = 3,
                     beta_a: float = 1.0, beta_u: float = 1.0,
                     inv_temp: float = 1.0, eps: float = 1e-9,
                     l_tile: Optional[int] = None):
    """EM routing via the M-step statistics and E-step kernels.

    votes: this rank's (B, L, H, C) block; a_in (B, L), which may be a
    broadcast view.  Each iteration runs ``em_stage_stats``, the host
    M-step arithmetic on (B,H,C) tensors and ``em_stage_estep``.  ``axes``
    maps sharded dims to mesh axes: "L" psums the three M-step statistics
    (the Table-2 aggregation); "B" shards are independent (EM keeps no
    cross-batch state), so no collective runs; H is refused by the router
    (per-H Gaussian statistics cannot split).  σ² is recombined from the
    streamed sufficient statistics (Σrw·v² − 2μ·Σrw·v + μ²·Σrw: one votes
    pass instead of two with a materialised (votes−μ)²), clamped at 0
    before the +eps floor against catastrophic cancellation.  As in the
    reference, the last iteration's E-step runs although its r is not used,
    so the work and the launches are the reference's.

    Returns (pose μ (B, H, C), a_out (B, H))."""
    votes = votes.float().contiguous()
    B, L, H, C = votes.shape
    if l_tile is None:
        l_tile = auto_l_tile(B, L, H, C, "fp32")
    l_axis = axes.get("L")
    f32 = dict(dtype=torch.float32, device=votes.device)
    r = torch.full((B, L, H), 1.0 / H, **f32)
    mu = torch.zeros((B, H, C), **f32)
    a_out = torch.zeros((B, H), **f32)
    for it in range(iterations):
        lam = inv_temp * (1.0 - 0.95 ** (it + 1))
        stats = em_stage_stats(votes, r, a_in, l_tile=l_tile)
        stats = tuple(mesh_utils.psum(x, l_axis) for x in stats)
        mu, inv_sigma2, bias, a_out = em_m_step(
            *stats, lam=lam, beta_a=beta_a, beta_u=beta_u, eps=eps)
        r = em_stage_estep(votes, mu, inv_sigma2, bias, l_tile=l_tile)
    return mu, a_out


def em_m_step(rsum_raw: torch.Tensor, rv: torch.Tensor, rv2: torch.Tensor,
              *, lam: float, beta_a: float = 1.0, beta_u: float = 1.0,
              eps: float = 1e-9) -> tuple:
    """The host arithmetic between ``em_stage_stats`` and
    ``em_stage_estep`` (the reference's ops.py:679-689, line for line):
    μ, σ² from the sufficient statistics, the activation a_out, and the
    E-step's Gaussian constants, so that the kernel pass is MAC-only.
    Returns (μ (B,H,C), 1/σ² (B,H,C), bias (B,H), a_out (B,H))."""
    r_sum = rsum_raw + eps                                      # (B, H)
    mu = rv / r_sum[..., None]
    var = rv2 - 2.0 * mu * rv + torch.square(mu) * rsum_raw[..., None]
    sigma2 = torch.clamp(var, min=0.0) / r_sum[..., None] + eps
    cost = (beta_u + 0.5 * torch.log(sigma2)) * r_sum[..., None]
    a_out = torch.sigmoid(lam * (beta_a - torch.sum(cost, dim=-1)))
    bias = torch.log(a_out + eps) - 0.5 * torch.sum(
        torch.log(2.0 * math.pi * sigma2), dim=-1)              # (B, H)
    return mu, 1.0 / sigma2, bias, a_out
