#!/usr/bin/env python3
"""The EM E-step's two designs on the card: lanes reading their votes from
device memory (the library's kernel, ``csrc/em_routing.cu``) against lanes
reading them from rows staged into shared memory by bulk copies.

    python3 scripts/estep_variants.py [--passes 2 4]

Builds the staged variant below with nvcc into ``build/estep_variants/``:
a persistent grid of 256-thread blocks walks tiles of consecutive (b, l)
rows; one thread copies the next tile into the second of two shared-memory
buffers by one TMA bulk copy completed on an mbarrier while the block
works on this one; each warp takes passes of R = 32 / H rows of the tile
(one row where H > 32) with the library kernel's lane layout, arithmetic
and shuffle trees, reading its 16 votes a (row, h) from shared memory as
16-byte loads.  ``--passes`` sets the passes a warp takes of a tile (the
tile is 8 warps × passes × R rows, the passes halved until two tiles fit
a block).  At the four phase-6 shapes of ``chip_smoke.py`` (Caps-MN1, Caps-EN3, Caps-CF3 at B=100, Caps-MN1 at
B=8; votes of the CapsNet encoder at random weights, μ, 1/σ² and the bias
of one real M-step with the serving mask) it checks both against the
plain version (max|Δ| ≤ 1e-5·max(1, max|plain|)) and prints the device
time of each (``chip_smoke.device_ms``, the median of 20 calls).  Shapes
with C = 16 only.  Needs one Hopper card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, ROOT)

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile("{\n.reg .pred done;\nLAB_WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
               "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
template <bool MAX>
__device__ __forceinline__ float group_reduce(float x, int h, int H, int p2,
                                              int base) {
  for (int off = p2 >> 1; off > 0; off >>= 1) {
    const float y = __shfl_down_sync(kFull, x, off);
    if (h + off < H) x = MAX ? fmaxf(x, y) : __fadd_rn(x, y);
  }
  return __shfl_sync(kFull, x, base);
}
template <bool MAX>
__device__ __forceinline__ float warp_reduce(float x) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = MAX ? fmaxf(x, y) : __fadd_rn(x, y);
  }
  return x;
}

// C = 16: four float4 a (row, h); tile = tile_rows consecutive rows
template <int NH>
__global__ void __launch_bounds__(kThreads)
staged_estep(const float* __restrict__ votes, const float* __restrict__ mu,
             const float* __restrict__ isig, const float* __restrict__ bias,
             float* __restrict__ r, int B, int L, int H, int R,
             int tile_rows) {
  constexpr int C = 16, C4 = 4;
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) uint64_t bars[2];
  const int HC = H * C, n_rows = B * L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = NH == 1 ? lane / H : 0;
  const int h0 = NH == 1 ? lane - sub * H : lane;
  const bool lane_on = NH == 1 ? sub < R : true;
  int p2 = 1;
  while (p2 < H) p2 <<= 1;
  const int tiles = (n_rows + tile_rows - 1) / tile_rows;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t, int buf) {
    const int rows = min(tile_rows, n_rows - t * tile_rows);
    const uint32_t bytes = (uint32_t)rows * HC * 4;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(&bars[buf], bytes);
    bulk_copy(sm + (size_t)buf * tile_rows * HC,
              votes + (size_t)t * tile_rows * HC, bytes, &bars[buf]);
  };
  if (threadIdx.x == 0 && blockIdx.x < tiles) issue(blockIdx.x, 0);
  int cur_b = -1;
  float4 m4[NH][C4], s4[NH][C4];
  float bias_h[NH];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int buf = it & 1;
    if (threadIdx.x == 0 && t + (int)gridDim.x < tiles)
      issue(t + gridDim.x, buf ^ 1);
    mbar_wait(&bars[buf], (uint32_t)((it >> 1) & 1));
    const float* tile = sm + (size_t)buf * tile_rows * HC;
    const int row0 = t * tile_rows;
    const int rows = min(tile_rows, n_rows - row0);
    const int passes = (rows + R - 1) / R;
    for (int p = warp; p < passes; p += kWarps) {
      const int local = p * R + sub;
      const bool ok = lane_on && local < rows;
      const int row = row0 + local;
      const int b = ok ? row / L : cur_b;
      if (b != cur_b) {
        cur_b = b;
        for (int j = 0; j < NH; ++j) {
          const int h = h0 + 32 * j;
          if (h >= H) continue;
          const size_t bh = (size_t)b * H + h;
          bias_h[j] = __ldg(bias + bh);
          const float4* mp = reinterpret_cast<const float4*>(mu + bh * C);
          const float4* ip = reinterpret_cast<const float4*>(isig + bh * C);
#pragma unroll
          for (int q = 0; q < C4; ++q) {
            m4[j][q] = __ldg(mp + q);
            s4[j][q] = __ldg(ip + q);
          }
        }
      }
      float lg[NH];
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int h = h0 + 32 * j;
        lg[j] = -__int_as_float(0x7f800000);
        if (!ok || h >= H) continue;
        const float4* src = reinterpret_cast<const float4*>(
            tile + (size_t)local * HC + (size_t)h * C);
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < C4; ++q) {
          const float4 x = src[q];
          const float v[4] = {x.x, x.y, x.z, x.w};
          const float m[4] = {m4[j][q].x, m4[j][q].y, m4[j][q].z, m4[j][q].w};
          const float is[4] = {s4[j][q].x, s4[j][q].y, s4[j][q].z,
                               s4[j][q].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = __fsub_rn(v[e], m[e]);
            s = __fadd_rn(s, __fmul_rn(__fmul_rn(d, d), is[e]));
          }
        }
        lg[j] = __fsub_rn(bias_h[j], __fmul_rn(0.5f, s));
      }
      float m = lg[0];
#pragma unroll
      for (int j = 1; j < NH; ++j) m = fmaxf(m, lg[j]);
      m = NH == 1 ? group_reduce<true>(m, h0, H, p2, sub * H)
                  : warp_reduce<true>(m);
      float e[NH], sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const bool on = ok && h0 + 32 * j < H;
        e[j] = on ? expf(__fsub_rn(lg[j], m)) : 0.0f;
        sum = __fadd_rn(sum, e[j]);
      }
      sum = NH == 1 ? group_reduce<false>(sum, h0, H, p2, sub * H)
                    : warp_reduce<false>(sum);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int h = h0 + 32 * j;
        if (ok && h < H) r[(size_t)row * H + h] = __fdiv_rn(e[j], sum);
      }
    }
    __syncthreads();  // this buffer is free for the copy two tiles on
  }
}
}  // namespace

extern "C" int staged_estep_launch(const float* votes, const float* mu,
                                   const float* isig, const float* bias,
                                   float* r, int B, int L, int H, int C,
                                   int passes_per_warp, void* stream) {
  if (C != 16 || H > 64) return (int)cudaErrorInvalidValue;
  const int R = H <= 32 ? 32 / H : 1;
  // two tiles within one block's shared memory (227 KB)
  while (passes_per_warp > 1 &&
         2 * (size_t)R * kWarps * passes_per_warp * H * C * sizeof(float) >
             232448 - 1024)
    passes_per_warp /= 2;
  const int tile_rows = R * kWarps * passes_per_warp;
  const size_t smem = 2 * (size_t)tile_rows * H * C * sizeof(float);
  auto kernel = H <= 32 ? staged_estep<1> : staged_estep<2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (B * L + tile_rows - 1) / tile_rows;
  const int blocks = tiles < 132 * per_sm ? tiles : 132 * per_sm;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      votes, mu, isig, bias, r, B, L, H, R, tile_rows);
  return (int)cudaGetLastError();
}
"""


def build(cudalib) -> ctypes.CDLL:
    out_dir = os.path.join(ROOT, "build", "estep_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "staged_estep.cu")
    so = os.path.join(out_dir, "staged_estep.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    cmd = [cudalib._nvcc(), *cudalib.NVCC_FLAGS, "-shared", "-o", so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[variants] ptxas: {line.strip()}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.staged_estep_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.staged_estep_launch.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, nargs="+", default=[2, 4],
                    help="passes a warp takes of one staged tile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("estep_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS as CAPS
    from repro_torch.kernels import cudalib
    from repro_torch.kernels.routing import kernel, ops
    lib = build(cudalib)
    stream = torch.cuda.current_stream().cuda_stream
    with torch.inference_mode():
        for name, cfg_name, batch in (("Caps-MN1", "Caps-MN1", 100),
                                      ("Caps-EN3", "Caps-EN3", 100),
                                      ("Caps-CF3", "Caps-CF3", 100),
                                      ("Caps-MN1 microbatch 8", "Caps-MN1",
                                       8)):
            u = cs.votes_for(CAPS[cfg_name], batch)
            B, L, H, C = u.shape
            lt = dict(l_tile=ops.auto_l_tile(B, L, H, C, "fp32"))
            gen = torch.Generator(device="cuda").manual_seed(B * L + H)
            r = torch.softmax(torch.randn((B, L, H), generator=gen,
                                          device="cuda"), dim=-1)
            a_in = torch.ones((B,), device="cuda")[:, None].expand(B, L)
            stats = kernel.em_stage_stats_plain(u, r, a_in, **lt)
            mu, isig, bias, _ = ops.em_m_step(*stats, lam=0.05)
            mu, isig, bias = (t.contiguous() for t in (mu, isig, bias))
            want = kernel.em_stage_estep_plain(u, mu, isig, bias, **lt)

            def direct():
                return kernel.em_stage_estep(u, mu, isig, bias, **lt)
            err = cs.scaled_err(direct(), want)
            cs.check(err <= cs.TOL, f"{name} direct: {err:.3g}")
            times = {"direct": cs.device_ms(direct)["ms"]}
            for k in args.passes:
                out = torch.empty((B, L, H), device="cuda")

                def staged():
                    e = lib.staged_estep_launch(
                        u.data_ptr(), mu.data_ptr(), isig.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), B, L, H, C, k,
                        stream)
                    cs.check(e == 0, f"staged launch: CUDA error {e}")
                    return out
                err = cs.scaled_err(staged().clone(), want)
                cs.check(err <= cs.TOL, f"{name} staged: {err:.3g}")
                times[f"staged, {k} passes a warp"] = cs.device_ms(
                    staged)["ms"]
            shown = ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            print(f"[variants] {name:<22} em_stage_estep device time: "
                  f"{shown} (both within {cs.TOL:g} of the plain version)")
            del u, r, stats, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
