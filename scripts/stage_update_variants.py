#!/usr/bin/env python3
"""The routing stage-update kernel's three ways of getting v on the card:
the library's squash launch followed by the update kernel as its
programmatic dependent launch (PDL), the same two kernels launched one
after the other without PDL, and one launch in which every block squashes
the s rows it stages.

    python3 scripts/stage_update_variants.py [--pin ROWS,SLICES ...]
                                             [--out FILE]

Builds ``src/repro_torch/csrc/routing_stage.cu`` together with the
squash-in-every-block kernel below into ``build/stage_variants/`` (nvcc
with ``cudalib.NVCC_FLAGS -shared``; one entry point, ``mode`` 0 squash
in every block, 1 the library's launch, 2 the library's two kernels
without PDL), and at the four phase-7 shapes of ``chip_smoke.py``
(Caps-MN1, Caps-EN3, Caps-CF3 at B=100, Caps-MN1 at B=8; the operands of
``chip_smoke.stage_inputs``), fp32 and bf16, exact, runs
``routing_stage_update`` and ``routing_stage_update_fold`` all three ways
at ``ops.stage_update_geometry``, and by the library's launch at each
``--pin`` geometry (rows a block, batch slices) that fits a block: each
output within 1e-5·max(1, max|plain|) of the plain version and two calls
bitwise equal, then the median of 20 CUDA-event-timed calls
(``chip_smoke.timed_ms``), the event time of 50 calls back to back over
50 (where PDL lets a call's update kernel start under its squash kernel,
this is what it saves), and the device time (``chip_smoke.device_ms``
against the phase-7 bound, split into the squash and the update kernel).
Needs one Hopper card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, ROOT)

VARIANTS = {0: "squash in each block", 1: "squash launch + PDL",
            2: "squash launch, no PDL"}
KERNEL_PARTS = {"squash": ("stage_squash",), "update": ("stage_update",)}
BATCH = 50

# The library's source with one more kernel: the update kernel of one pass
# that stages s instead of v and squashes each staging in shared memory
# before it uses it (exact only; 16-byte runs; every row of v written by
# one block).
SOURCE = r"""
#include "routing_stage.cu"

namespace {

// the staged s rows of staging t squashed in place, in three passes over
// shared memory: |s|² per (b, h) row — where C divides into a power of two
// of fours up to 32, each thread sums four elements and a row's lanes add
// theirs by an xor butterfly, otherwise a thread sums a row in c order;
// then the row's factor q/r, a thread a row (x·(q/r) is within an ulp of
// Squash's (x·q)/r); then every element times its row's factor.  The v
// this kernel returns is Squash's own, each row written by one block.
__device__ __forceinline__ void squash_staged(const UpdateArgs& a, float* vs,
                                              float* fac, int t) {
  const int C = a.C, H = a.H;
  const int nrows = a.slices * a.chunk_rows * H;
  const int g = C / 4;
  if (C % 4 == 0 && g <= 32 && (g & (g - 1)) == 0) {
    const int n = nrows * g;
    for (int i0 = threadIdx.x & ~31; i0 < n; i0 += blockDim.x) {
      const int i = i0 + (threadIdx.x & 31);
      const float4 x = i < n ? reinterpret_cast<const float4*>(vs)[i]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      float n2 = __fmul_rn(x.x, x.x);
      n2 = __fadd_rn(n2, __fmul_rn(x.y, x.y));
      n2 = __fadd_rn(n2, __fmul_rn(x.z, x.z));
      n2 = __fadd_rn(n2, __fmul_rn(x.w, x.w));
      for (int off = g >> 1; off > 0; off >>= 1)
        n2 = __fadd_rn(n2, __shfl_xor_sync(kFull, n2, off));
      if (i < n && i % g == 0) fac[i / g] = n2;
    }
  } else {
    for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
      const float* row = vs + (size_t)r * C;
      float n2 = 0.0f;
      for (int k = 0; k < C; ++k) n2 = __fadd_rn(n2, __fmul_rn(row[k], row[k]));
      fac[r] = n2;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int sj = r / H, h = r - sj * H;
    const int b = staged_row(a, sj, t);
    const routing::Squash<false> sq(fac[r]);
    fac[r] = __fdiv_rn(sq.q, sq.r);
    if (b >= 0 && (b * H + h) % gridDim.x == blockIdx.x) {
      const float* row = vs + (size_t)r * C;
      float* o = a.v + ((size_t)b * H + h) * C;
      for (int k = 0; k < C; ++k) o[k] = sq(row[k]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * C; i += blockDim.x)
    vs[i] = __fmul_rn(vs[i], fac[i / C]);
}

// the library's layout with a staging's squash factors after the two
// stagings
struct BlockSquashSmem {
  size_t stage, factors, logits, ring;
  __device__ __host__ BlockSquashSmem(int rows, int slices, int chunk_rows,
                                      int H, int C) {
    stage = (size_t)slices * chunk_rows * H * C;
    const size_t loop = 2 * stage + (size_t)slices * chunk_rows * H;
    const size_t part = (size_t)slices * rows * H * C;
    factors = 2 * stage;
    logits = loop > part ? loop : part;
    ring = (logits + (size_t)rows * H + 3) / 4 * 4;
  }
  size_t bytes(int threads, bool smem_ring) const {
    return 4 * ring + (smem_ring ? (size_t)16 * kRingShared * threads : 0);
  }
};

template <typename T, int V, bool FOLD, bool SMEM_RING>
__global__ void __launch_bounds__(kUpdateThreads, kUpdateBlocksPerSm)
stage_update_block_squash_kernel(const UpdateArgs a) {
  constexpr int D = SMEM_RING ? kRingShared : kRingRegisters;
  using R = Run<T, V>;
  extern __shared__ __align__(16) float sm[];
  __shared__ uint64_t bars[2];
  const int H = a.H, C = a.C, HC = H * C, S = a.slices, KR = a.chunk_rows;
  const BlockSquashSmem lay(a.rows, S, KR, H, C);
  UpdateArgs sa = a;  // stagings of s
  sa.v = const_cast<float*>(a.s);
  const int l0 = blockIdx.x * a.rows;
  const int rows = min(a.rows, a.L - l0);
  const int runs = a.rows * (HC / V);
  const int sl = threadIdx.x / runs;
  const int o = threadIdx.x - sl * runs;
  const bool on = sl < S && o < rows * (HC / V);
  const int e0 = o * V;
  const int hc0 = e0 % HC;
  const int b_lo = on ? sl * a.B / S : 0;
  const int nb = on ? (sl + 1) * a.B / S - b_lo : 0;
  const int stride = a.L * HC;
  const T* next = static_cast<const T*>(a.u)
                  + ((size_t)b_lo * a.L + l0) * HC + e0;
  const bool bulk = bulk_staging(sa);
  float* bn = sm + lay.logits;
  if (FOLD) {
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x)
      copy4(bn + i, a.b + (size_t)l0 * H + i);
    commit_group();
  }
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float4* ring = reinterpret_cast<float4*>(sm + lay.ring) + threadIdx.x;
  typename R::Raw x[SMEM_RING ? 1 : D];
#pragma unroll
  for (int q = 0; q < D; ++q) {
    if constexpr (SMEM_RING) {
      if (q < nb) R::fill(ring + q * blockDim.x, next);
      commit_group();
    } else {
      if (q < nb) x[q] = R::load(next);
    }
    next += stride;
  }
  __syncthreads();
  stage_issue(sa, bulk, sm, &bars[0], 0, 0, HC, HC);
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
  for (int t = 0; t < a.chunks; ++t) {
    float* vs = sm + (t & 1) * lay.stage;
    if (bulk) mbar_wait(&bars[t & 1], (t >> 1) & 1);
    __syncthreads();
    squash_staged(a, vs, sm + lay.factors, t);
    __syncthreads();
    if (t + 1 < a.chunks)
      stage_issue(sa, bulk, sm + ((t + 1) & 1) * lay.stage,
                  &bars[(t + 1) & 1], t + 1, 0, HC, HC);
    const int j0 = t * KR;
    const int jn = max(0, min(KR, nb - j0));
    const float* vrow = vs + (size_t)sl * KR * HC + hc0;
    if constexpr (SMEM_RING) {
      for (int j = 0; j < jn; ++j) {
        const int g = j0 + j;
        float4* slot = ring + (g % D) * blockDim.x;
        wait_groups<D - 1>();
        accumulate<T, V>(acc, R::read(slot), vrow + (size_t)j * HC);
        if (g + D < nb) R::fill(slot, next);
        next += stride;
        commit_group();
      }
    } else {
      for (int j = 0; j < jn; j += D) {
#pragma unroll
        for (int q = 0; q < D; ++q) {
          if (j + q < jn) {
            accumulate<T, V>(acc, x[q], vrow + (size_t)(j + q) * HC);
            if (j0 + j + q + D < nb) {
              x[q] = R::load(next);
              next += stride;
            }
          }
        }
      }
    }
  }
  const int blk = a.rows * HC;
  float* part = sm;
  if (FOLD) wait_groups<0>();
  __syncthreads();
  if (on) {
#pragma unroll
    for (int k = 0; k < V; ++k) part[(size_t)sl * blk + e0 + k] = acc[k];
  }
  __syncthreads();
  const int n_el = rows * HC;
  for (int i = threadIdx.x; i < n_el; i += blockDim.x) {
    float y = part[i];
    for (int k = 1; k < S; ++k) y = __fadd_rn(y, part[(size_t)k * blk + i]);
    part[i] = y;
  }
  __syncthreads();
  const int n_lh = rows * H;
  for (int i = threadIdx.x; i < n_lh; i += blockDim.x) {
    const float* tp = part + (size_t)i * C;
    float d = 0.0f;
    for (int k = 0; k < C; ++k) d = __fadd_rn(d, tp[k]);
    const size_t gi = (size_t)l0 * H + i;
    if (FOLD) {
      const float y = __fadd_rn(bn[i], d);
      a.b_out[gi] = y;
      bn[i] = y;
    } else {
      a.db[gi] = d;
    }
  }
  if (!FOLD) return;
  float* stat = part;
  __syncthreads();
  for (int l = threadIdx.x; l < rows; l += blockDim.x) {
    const float* row = bn + (size_t)l * H;
    float m = row[0];
    for (int h = 1; h < H; ++h) m = fmaxf(m, row[h]);
    stat[l] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_lh; i += blockDim.x)
    bn[i] = expf(__fsub_rn(bn[i], stat[i / H]));
  __syncthreads();
  for (int l = threadIdx.x; l < rows; l += blockDim.x) {
    const float* row = bn + (size_t)l * H;
    float sum = 0.0f;
    for (int h = 0; h < H; ++h) sum += row[h];
    stat[l] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_lh; i += blockDim.x)
    a.c_out[(size_t)l0 * H + i] = __fdiv_rn(bn[i], stat[i / H]);
}

template <typename K>
cudaError_t plain_launch(K kernel, const UpdateArgs& a, int threads,
                         int blocks, size_t smem, cudaStream_t st) {
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// mode 0: the block-squash kernel; mode 2: the library's squash kernel,
// then its update kernel, both launched plainly
template <typename T, int V, bool FOLD, bool SMEM_RING>
cudaError_t variant(const UpdateArgs& a, int mode, int threads, int blocks,
                    cudaStream_t st) {
  if (mode == 0) {
    const size_t smem = BlockSquashSmem(a.rows, a.slices, a.chunk_rows, a.H,
                                        a.C).bytes(threads, SMEM_RING);
    return plain_launch(stage_update_block_squash_kernel<T, V, FOLD,
                                                         SMEM_RING>,
                        a, threads, blocks, smem, st);
  }
  const int BH = a.B * a.H;
  const int n = a.C <= 32 && (a.C & (a.C - 1)) == 0 ? BH * a.C : BH;
  stage_squash_kernel<false><<<(n + kReduceThreads - 1) / kReduceThreads,
                               kReduceThreads, 0, st>>>(a.s, a.v, BH, a.C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = UpdateSmem(a.rows, a.slices, a.chunk_rows,
                                 pass_cols(a, V), a.H, a.passes)
                          .bytes(threads, SMEM_RING);
  return plain_launch(stage_update_kernel<T, V, FOLD, false, SMEM_RING,
                                          false>,
                      a, threads, blocks, smem, st);
}

template <typename T, int V>
cudaError_t variant_t(const UpdateArgs& a, int mode, bool fold, bool ring,
                      int threads, int blocks, cudaStream_t st) {
  if (fold)
    return ring ? variant<T, V, true, true>(a, mode, threads, blocks, st)
                : variant<T, V, true, false>(a, mode, threads, blocks, st);
  return ring ? variant<T, V, false, true>(a, mode, threads, blocks, st)
              : variant<T, V, false, false>(a, mode, threads, blocks, st);
}

}  // namespace

extern "C" int stage_update_variant(
    const void* u, int dtype, const float* s, float* v, float* db,
    const float* b, float* b_out, float* c_out, int B, int L, int H, int C,
    int fold, int rows, int slices, int passes, int vector, int ring,
    int chunk_rows, int chunks, int threads, int blocks, int smem_bytes,
    int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    return routing_stage_update(u, dtype, s, v, db, b, b_out, c_out, B, L, H,
                                C, 0, fold, rows, slices, passes, vector,
                                ring, chunk_rows, chunks, threads, blocks,
                                smem_bytes, stream);
  if (passes != 1 || vector != (dtype == 0 ? 4 : 8) || (mode != 0 && mode != 2))
    return (int)cudaErrorInvalidValue;
  const UpdateArgs a{u, s, v, db, b, b_out, c_out, B, L, H, C,
                     rows, slices, passes, chunk_rows, chunks};
  return (int)(dtype == 0
      ? variant_t<float, 4>(a, mode, fold != 0, ring != 0, threads, blocks,
                            st)
      : variant_t<__nv_bfloat16, 8>(a, mode, fold != 0, ring != 0, threads,
                                    blocks, st));
}
"""


def build(cudalib):
    out = os.path.join(ROOT, "build", "stage_variants")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "stage_variants.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    so = os.path.join(out, "libstage_variants.so")
    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    cmd = [cudalib._nvcc(), *cudalib.NVCC_FLAGS, "-I", csrc, "-shared",
           "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    entry = ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill" in line and not line.strip().startswith("0 bytes"):
            print(f"[variants] ptxas: {entry}: {line.strip()}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stage_update_variant.argtypes = [p, i, p, p, p, p, p, p,
                                         *[i] * 16, p]
    lib.stage_update_variant.restype = i
    return lib


def batched_ms(fn, calls: int = BATCH, repeats: int = 5) -> float:
    """Milliseconds a call of ``fn`` adds when ``calls`` of them run back
    to back: CUDA events around the batch, over ``calls``, median of
    ``repeats``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pin", nargs="+", default=[],
                    help="rows,slices geometries tried with PDL besides")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stage_update_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS as CAPS
    from repro_torch.kernels import cudalib
    from repro_torch.kernels.routing import kernel, ops
    lib = build(cudalib)
    pins = [tuple(map(int, p.split(","))) for p in args.pin]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    with torch.inference_mode():
        for name, cfg_name, batch in (("Caps-MN1", "Caps-MN1", 100),
                                      ("Caps-EN3", "Caps-EN3", 100),
                                      ("Caps-CF3", "Caps-CF3", 100),
                                      ("Caps-MN1 microbatch 8", "Caps-MN1",
                                       8)):
            u = cs.votes_for(CAPS[cfg_name], batch)
            for sd in ("fp32", "bf16"):
                us, lt, _, s, b = cs.stage_inputs(kernel, ops, u, sd)
                B, L, H, C = us.shape
                lh, bhc = L * H * 4, B * H * C * 4
                u_bytes = us.numel() * us.element_size()
                item = us.element_size()
                f32 = dict(dtype=torch.float32, device="cuda")
                geo0 = ops.stage_update_geometry(B, L, H, C, sd)
                cs.check(geo0.passes == 1 and geo0.vector == 16 // item,
                         f"{name} {sd}: the variants take one pass of "
                         f"16-byte runs")
                for fold in (False, True):
                    want = (kernel.routing_stage_update_fold_plain(
                        us, s, b, l_tile=lt) if fold else
                        kernel.routing_stage_update_plain(us, s, l_tile=lt))
                    b_ms = cs.bound(u_bytes + 2 * bhc + (3 if fold else 1)
                                    * lh, 2 * us.numel())[0]
                    times = {}
                    tries = [(0, geo0), (2, geo0), (1, geo0)]
                    for pin in pins:
                        got = ops._stage_update_candidate(
                            B, L, H, C, item, geo0.vector, *pin)
                        if (got and pin[0] * pin[1] * H * C // geo0.vector
                                <= ops.STAGE_UPDATE_THREADS):
                            tries.append((1, got[0]))
                    for mode, geo in tries:
                        label = (f"{VARIANTS[mode]}, {geo.blocks} blocks of "
                                 f"{geo.threads}, ring of {geo.unroll} in "
                                 + ("shared memory" if geo.smem_ring
                                    else "registers")
                                 + f", {geo.rows} rows, "
                                 f"{geo.slices} slices, {geo.chunks} "
                                 f"stagings of {geo.chunk_rows}")
                        outs = [torch.empty((B, H, C), **f32)] + [
                            torch.empty((L, H), **f32)
                            for _ in range(2 if fold else 1)]

                        def run(outs=outs, mode=mode, geo=geo):
                            v, *rest = outs
                            db, b_new, c_new = ((None, *rest) if fold
                                                else (rest[0], None, None))
                            ptr = (lambda t: None if t is None
                                   else t.data_ptr())
                            e = lib.stage_update_variant(
                                us.data_ptr(), 0 if sd == "fp32" else 1,
                                s.data_ptr(), v.data_ptr(), ptr(db),
                                b.data_ptr() if fold else None, ptr(b_new),
                                ptr(c_new), B, L, H, C, int(fold),
                                geo.rows, geo.slices, geo.passes, geo.vector,
                                int(geo.smem_ring), geo.chunk_rows,
                                geo.chunks, geo.threads, geo.blocks,
                                geo.smem_bytes, mode, stream)
                            cs.check(e == 0, f"variant launch: CUDA error {e}")
                            return outs
                        first = [t.clone() for t in run()]
                        second = run()
                        torch.cuda.synchronize()
                        cs.check(all(torch.equal(x, y) for x, y in
                                     zip(first, second)),
                                 f"{name} {sd} {label}: two calls differ")
                        err = max(cs.scaled_err(x, y)
                                  for x, y in zip(first, want))
                        cs.check(err <= cs.TOL, f"{name} {sd} {label}: "
                                                f"scaled max|Δ| {err:.3g}")
                        dev = cs.device_ms(run, bound_ms=b_ms,
                                           parts=KERNEL_PARTS)
                        times[label] = {"mode": VARIANTS[mode],
                                        "ms": cs.timed_ms(run),
                                        "batched_ms": batched_ms(run),
                                        "device_ms": dev["ms"],
                                        "squash_ms": dev.get("squash"),
                                        "update_ms": dev.get("update"),
                                        "event_ms": dev["event_ms"],
                                        "max_abs_err": err}
                    kname = ("routing_stage_update_fold" if fold
                             else "routing_stage_update")
                    rows.append({"kernel": kname, "shape": name,
                                 "variant": sd, "bound_ms": b_ms,
                                 "times": times})
                    print(f"[variants] {name:<22} {kname:<25} {sd}, bound "
                          f"{b_ms:.4f} ms:")
                    for k, t in times.items():
                        dev = ("not reported" if t["device_ms"] is None
                               else f"{t['device_ms']:.4f} ms")
                        split = ("" if not t["squash_ms"] else
                                 f" = squash kernel {t['squash_ms']:.4f} + "
                                 f"update kernel {t['update_ms']:.4f} ms")
                        print(f"[variants]     {k}: event {t['ms']:.4f} ms, "
                              f"{BATCH} back to back {t['batched_ms']:.4f} "
                              f"ms a call, device {dev}{split}")
                del us, s, b
            del u
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
