// Causal (optionally sliding-window) / bidirectional GQA attention at head
// dims above 256 for Hopper (sm_90a): the forward, with or without its
// log-sum-exp, and the FlashAttention-2 backward, compiled into the port's
// one library (repro_torch/kernels/cudalib.py) and bound through a plain C
// interface.
//
// Source note
// -----------
// Replaces, for D > 256, the JAX package's Pallas TPU kernels
//   repro/kernels/flash_attention/kernel.py::flash_attention
//     (_flash_kernel) and ::flash_attention_fwd_lse (_flash_fwd_lse_kernel):
//     o = softmax(q·kᵀ·scale, masked) · v with an fp32 running max m, sum l
//     and accumulator, the −1e30 mask value, the l == 0 → 1 guard, and lse
//     = m + log(l) per row;
//   ...::flash_attention_bwd (_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel):
//     p = exp(s − lse), dp = dO·vᵀ, ds = p·(dp − delta)·scale, dq = ds·k,
//     and dv = pᵀ·dO, dk = dsᵀ·q per *query* head (the group sum happens
//     outside, as for the other head dims).
// The reference's kernels hold a (block, D) tile of q, k and v in VMEM for
// any D.  Here the kernels of flash_attention.cu and flash_attention_bwd.cu
// stage whole rows of D in shared memory and keep a row's accumulator in
// registers, which at D = 256 already takes 222,208 (forward) and 226,816
// (backward) of the 232,448 bytes a block may have; so above 256 the head
// dim is cut into pieces instead, and any D runs with no padding:
//   * a score product (q·kᵀ, dO·vᵀ) runs over D in chunks of kC = 64
//     columns, each staged transposed in shared memory and added to the
//     same running 4 × 4 sums in ascending column order;
//   * a block accumulates one slice of kS = 128 output columns (o, dq, or
//     dk and dv), so the grid holds ceil(D / 128) blocks for each tile, and
//     each recomputes the scores over the whole head dim;
//   * the ragged last chunk and slice are bounded in the loads: columns
//     past D are not read, and a slice's columns past D are zero in shared
//     memory and never stored.
// Every slice of a tile runs the same score products, masks and online
// softmax in the same order, so the slices agree bitwise on m, l and p;
// only slice 0 writes lse.  No atomics: two calls agree bitwise.
//
// Both dtypes compute in fp32 on the CUDA cores (bf16 inputs are widened as
// they are staged, and outputs rounded to nearest once), so the kernels
// agree with the plain versions to fp32 round-off in both: in bf16 this is
// the plain version's arithmetic, with no rounding of p or ds.
//
// What bounds them: operations.  The forward at (B=4, Hq=16, S=1024,
// D=512, causal) is 4·B·Hq·D·S²/2 = 68.8 GFLOP of multiply-adds, 1.03 ms at
// the 67 TFLOP/s fp32 CUDA-core rate (0.07 ms at the 989 TFLOP/s bf16
// tensor-core rate that the bound in chip_smoke.py uses for bf16 inputs);
// recomputing the scores in every slice adds (slices − 1) / 2 of that, 1.5×
// at D = 512.  The dq kernel runs two score products and one slice product
// a tile, the dk/dv kernel two and two.
//
// Thread layout (all three kernels, 256 threads as a 16 × 16 grid (ty, tx),
// as the fp32 kernels of the other head dims): a thread holds a 4 × 4 block
// of a 64 × 64 score tile (rows 4ty.., columns 4tx..), and for the slice
// product the same 4 rows by the 8 columns tx + 16c of the slice.  Scores
// and accumulators meet through shared memory: p (or ds) as a [64][kLd]
// tile, the slice of v, k, dO or q transposed as a [128][kLd] tile over the
// score chunks' buffers, which are free by then.
//
// Masks, tile ranges, the sliding window (W > 0, causal only: key col
// counts for row row iff row − W < col <= row) and cross attention (Sk ≠
// Sq, bidirectional) are those of the fp32 kernels in flash_attention.cu
// and flash_attention_bwd.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;                // query rows or keys a tile
constexpr int kC = 64;                // head-dim columns a score chunk
constexpr int kS = 128;               // output columns a block accumulates
constexpr int kThreads = 256;         // 16 × 16
constexpr int kLd = kT + 4;           // row stride of every staged tile
constexpr int kChunk = kC * kLd;      // floats of a staged chunk
constexpr int kTile = kT * kLd;       // floats of a p or ds tile
constexpr int kSlice = kS * kLd;      // floats of a staged slice
constexpr float kNegInf = -1e30f;     // the reference's mask value
static_assert(kSlice == 2 * kChunk, "a slice fills two chunk buffers");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// dst[d][r] = src[r0 + r][d0 + d] for the tile's 64 rows and the chunk's
// dn columns; rows past S are zero
template <typename T>
__device__ __forceinline__ void stage_chunk(float* dst, const T* src, int r0,
                                            int S, int D, int d0, int dn,
                                            int tid) {
  for (int e = tid; e < kT * kC; e += kThreads) {
    const int r = e / kC, d = e % kC;
    if (d < dn)
      dst[d * kLd + r] =
          r0 + r < S ? to_f32(src[(size_t)(r0 + r) * D + d0 + d]) : 0.f;
  }
}

// dst[c][r] = src[r0 + r][c0 + c] for the slice's kS columns; rows past S
// and columns past D are zero
template <typename T>
__device__ __forceinline__ void stage_slice(float* dst, const T* src, int r0,
                                            int S, int D, int c0, int tid) {
  for (int e = tid; e < kT * kS; e += kThreads) {
    const int r = e / kS, c = e % kS;
    dst[c * kLd + r] = r0 + r < S && c0 + c < D
                           ? to_f32(src[(size_t)(r0 + r) * D + c0 + c])
                           : 0.f;
  }
}

// a[i][j] += Σ_{d < dn} x[d][4·ty + i] · y[d][4·tx + j] over two staged
// chunks
__device__ __forceinline__ void outer4(float (&a)[4][4], const float* x,
                                       const float* y, int dn, int ty,
                                       int tx) {
#pragma unroll 8
  for (int d = 0; d < dn; ++d) {
    const float4 xa = *reinterpret_cast<const float4*>(x + d * kLd + 4 * ty);
    const float4 ya = *reinterpret_cast<const float4*>(y + d * kLd + 4 * tx);
    const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
    const float yv[4] = {ya.x, ya.y, ya.z, ya.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
  }
}

// acc[i][c] += Σ_r w[4·ty + i][r] · z[tx + 16c][r] over the tile's 64 rows
// r: w a [64][kLd] tile (p or ds, possibly transposed), z a staged slice
__device__ __forceinline__ void accum(float (&acc)[4][kS / 16],
                                      const float* w, const float* z, int ty,
                                      int tx) {
#pragma unroll 2
  for (int r = 0; r < kT; r += 4) {
    float wr[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 w4 =
          *reinterpret_cast<const float4*>(w + (4 * ty + i) * kLd + r);
      wr[i][0] = w4.x;
      wr[i][1] = w4.y;
      wr[i][2] = w4.z;
      wr[i][3] = w4.w;
    }
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) {
      const float4 z4 =
          *reinterpret_cast<const float4*>(z + (tx + 16 * c) * kLd + r);
      const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[i][c] = fmaf(wr[i][u], zv[u], acc[i][c]);
    }
  }
}

// a thread's accumulator rows r0 + 4ty + i and slice columns c0 + tx + 16c,
// stored where they fall inside (rows, D)
template <typename T>
__device__ __forceinline__ void store_slice(T* out,
                                            const float (&acc)[4][kS / 16],
                                            int r0, int rows, int D, int c0,
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < D) store(out + (size_t)row * D + col, acc[i][c]);
    }
  }
}

__device__ __forceinline__ bool in_band(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) &&
         (window == 0 || col > row - window);
}

// ---- the forward ------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                int D, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  float* xq = smem;                   // [kC][kLd] q chunk, transposed
  float* xk = xq + kChunk;            // [kC][kLd] k chunk, transposed
  float* vs = xq;                     // [kS][kLd] v slice (over both chunks)
  float* ps = xq + 2 * kChunk;        // [kT][kLd] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nsl = (D + kS - 1) / kS;
  const int n_qt = gridDim.x / nsl;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / nsl) * kT;  // heaviest first
  const int c0 = ((int)blockIdx.x % nsl) * kS;              // this slice
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                       // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* qp = q + qoff * D;
  const T* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const T* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;

  float m[4], l[4], acc[4][kS / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) acc[i][c] = 0.f;
  }

  const int n_kt_all = (Sk + kT - 1) / kT;
  // causal: k-tiles starting past this q-tile's last row are skipped;
  // window: so are those ending before its first row's window
  const int n_kt = causal ? min(n_kt_all, (q0 + kT - 1) / kT + 1) : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / kT : 0;
  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * kT;
    float s[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += kC) {
      const int dn = min(kC, D - d0);
      __syncthreads();  // the previous reads of these buffers are done
      stage_chunk(xq, qp, q0, Sq, D, d0, dn, tid);
      stage_chunk(xk, kp, k0, Sk, D, d0, dn, tid);
      __syncthreads();
      outer4(s, xq, xk, dn, ty, tx);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        s[i][j] = in_band(row, col, Sk, causal, window) ? s[i][j] * scale
                                                        : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + rs;
      m[i] = m_new;
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kS / 16; ++c) acc[i][c] *= alpha[i];
    __syncthreads();  // the last chunk's reads are done; p is written
    stage_slice(vs, vp, k0, Sk, D, c0, tid);
    __syncthreads();
    accum(acc, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) acc[i][c] /= lsafe;  // o = acc / l
    // m and l are whole-row values in each of the row's 16 threads, and
    // the same in every slice
    const int row = q0 + 4 * ty + i;
    if (lse != nullptr && c0 == 0 && tx == 0 && row < Sq)
      lse[qoff + row] = m[i] + logf(lsafe);
  }
  store_slice(o + qoff * D, acc, q0, Sq, D, c0, ty, tx);
}

// ---- the backward: dq --------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  float* xq = smem;                   // [kC][kLd] q chunk, transposed
  float* xk = xq + kChunk;            // [kC][kLd] k chunk
  float* xo = xk + kChunk;            // [kC][kLd] dO chunk
  float* xv = xo + kChunk;            // [kC][kLd] v chunk
  float* ks = xq;                     // [kS][kLd] k slice (over xq, xk)
  float* dss = xq + 4 * kChunk;       // [kT][kLd] ds
  float* lse_s = dss + kTile;         // [kT]
  float* delta_s = lse_s + kT;        // [kT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nsl = (D + kS - 1) / kS;
  const int n_qt = gridDim.x / nsl;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / nsl) * kT;  // heaviest first
  const int c0 = ((int)blockIdx.x % nsl) * kS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* qp = q + qoff * D;
  const T* dop = dout + qoff * D;
  const T* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const T* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;

  if (tid < kT) {
    const bool ok = q0 + tid < Sq;
    lse_s[tid] = ok ? lse[qoff + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
  }

  float acc[4][kS / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) acc[i][c] = 0.f;

  const int n_kt_all = (Sk + kT - 1) / kT;
  const int n_kt = causal ? min(n_kt_all, (q0 + kT - 1) / kT + 1) : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / kT : 0;
  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * kT;
    float s[4][4] = {}, dp[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += kC) {
      const int dn = min(kC, D - d0);
      __syncthreads();  // the previous reads of these buffers are done
      stage_chunk(xq, qp, q0, Sq, D, d0, dn, tid);
      stage_chunk(xk, kp, k0, Sk, D, d0, dn, tid);
      stage_chunk(xo, dop, q0, Sq, D, d0, dn, tid);
      stage_chunk(xv, vp, k0, Sk, D, d0, dn, tid);
      __syncthreads();
      outer4(s, xq, xk, dn, ty, tx);
      outer4(dp, xo, xv, dn, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int row = q0 + r;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const float p = row < Sq && in_band(row, col, Sk, causal, window)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.f;
        ds[j] = p * (dp[i][j] - delta_s[r]) * scale;
      }
      *reinterpret_cast<float4*>(dss + r * kLd + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // the last chunk's reads are done; ds is written
    stage_slice(ks, kp, k0, Sk, D, c0, tid);
    __syncthreads();
    accum(acc, dss, ks, ty, tx);
  }

  store_slice(dq + qoff * D, acc, q0, Sq, D, c0, ty, tx);
}

// ---- the backward: dk and dv per query head ---------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk_h,
                T* __restrict__ dv_h, int Hq, int Hkv, int Sq, int Sk, int D,
                float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  float* xk = smem;                   // [kC][kLd] k chunk, transposed
  float* xq = xk + kChunk;            // [kC][kLd] q chunk
  float* xv = xq + kChunk;            // [kC][kLd] v chunk
  float* xo = xv + kChunk;            // [kC][kLd] dO chunk
  float* os = xk;                     // [kS][kLd] dO slice (over xk, xq)
  float* qs = xv;                     // [kS][kLd] q slice (over xv, xo)
  float* pt = xk + 4 * kChunk;        // [kT][kLd] pᵀ (key rows)
  float* dst = pt + kTile;            // [kT][kLd] dsᵀ
  float* lse_s = dst + kTile;         // [kT]
  float* delta_s = lse_s + kT;        // [kT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nsl = (D + kS - 1) / kS;
  const int k0 = ((int)blockIdx.x / nsl) * kT;  // causal: heaviest first
  const int c0 = ((int)blockIdx.x % nsl) * kS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* qp = q + qoff * D;
  const T* dop = dout + qoff * D;
  const T* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const T* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;

  float dk[4][kS / 16], dv[4][kS / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) dk[i][c] = dv[i][c] = 0.f;

  // causal: q-tiles whose last row lies before this k-tile are skipped;
  // window: so are those starting past its last key's last row
  const int n_qt = window > 0
      ? min((Sq + kT - 1) / kT, (k0 + kT - 1 + window - 1) / kT + 1)
      : (Sq + kT - 1) / kT;
  for (int qi = causal ? k0 / kT : 0; qi < n_qt; ++qi) {
    const int q0 = qi * kT;
    float s[4][4] = {}, dp[4][4] = {};   // [key 4ty + i][query 4tx + j]
    for (int d0 = 0; d0 < D; d0 += kC) {
      const int dn = min(kC, D - d0);
      __syncthreads();  // the previous reads of these buffers are done
      if (d0 == 0 && tid < kT) {
        const bool ok = q0 + tid < Sq;
        lse_s[tid] = ok ? lse[qoff + q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
      }
      stage_chunk(xk, kp, k0, Sk, D, d0, dn, tid);
      stage_chunk(xq, qp, q0, Sq, D, d0, dn, tid);
      stage_chunk(xv, vp, k0, Sk, D, d0, dn, tid);
      stage_chunk(xo, dop, q0, Sq, D, d0, dn, tid);
      __syncthreads();
      outer4(s, xk, xq, dn, ty, tx);
      outer4(dp, xv, xo, dn, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * ty + i;
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * tx + j;
        const int row = q0 + r;
        p[j] = row < Sq && in_band(row, key, Sk, causal, window)
                   ? expf(s[i][j] * scale - lse_s[r])
                   : 0.f;
        ds[j] = p[j] * (dp[i][j] - delta_s[r]) * scale;
      }
      *reinterpret_cast<float4*>(pt + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dst + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // the last chunk's reads are done; p and ds written
    stage_slice(os, dop, q0, Sq, D, c0, tid);
    stage_slice(qs, qp, q0, Sq, D, c0, tid);
    __syncthreads();
    accum(dv, pt, os, ty, tx);
    accum(dk, dst, qs, ty, tx);
  }

  const size_t koff = (size_t)(b * Hq + h) * Sk;   // this head's dk_h rows
  store_slice(dk_h + koff * D, dk, k0, Sk, D, c0, ty, tx);
  store_slice(dv_h + koff * D, dv, k0, Sk, D, c0, ty, tx);
}

// shared memory a block: the forward's two chunks (the v slice over them)
// and p, 52,224 bytes; the dq kernel's four chunks, ds, lse and delta,
// 87,552; the dk/dv kernel's four chunks, pᵀ, dsᵀ, lse and delta, 104,960
constexpr size_t kFwdSmem = sizeof(float) * (2 * kChunk + kTile);
constexpr size_t kDqSmem = sizeof(float) * (4 * kChunk + kTile + 2 * kT);
constexpr size_t kDkvSmem = sizeof(float) * (4 * kChunk + 2 * kTile + 2 * kT);
static_assert(kFwdSmem == 52224 && kDqSmem == 87552 && kDkvSmem == 104960,
              "the wide kernels' shared memory, whatever D");

template <typename Kernel>
int configure(Kernel kernel, size_t smem, bool& configured) {
  if (configured) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  configured = true;
  return 0;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, int window, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  if (int err = configure(wide_fwd_kernel<T>, kFwdSmem, configured))
    return err;
  const int nsl = (D + kS - 1) / kS;
  const dim3 grid(((Sq + kT - 1) / kT) * nsl, Hq, B);
  wide_fwd_kernel<T><<<grid, kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, Sq, Sk, D,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk_h,
               void* dv_h, int B, int Hq, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, int window, cudaStream_t stream) {
  static bool configured_dq = false, configured_dkv = false;
  if (int err = configure(wide_dq_kernel<T>, kDqSmem, configured_dq))
    return err;
  if (int err = configure(wide_dkv_kernel<T>, kDkvSmem, configured_dkv))
    return err;
  const int nsl = (D + kS - 1) / kS;
  const dim3 grid_q(((Sq + kT - 1) / kT) * nsl, Hq, B);   // dq
  const dim3 grid_k(((Sk + kT - 1) / kT) * nsl, Hq, B);   // dk, dv
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  wide_dq_kernel<T><<<grid_q, kThreads, kDqSmem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Hq, Hkv, Sq, Sk, D,
      scale, causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_dkv_kernel<T><<<grid_k, kThreads, kDkvSmem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk_h),
      static_cast<T*>(dv_h), Hq, Hkv, Sq, Sk, D, scale, causal, window);
  return (int)cudaGetLastError();
}

bool bad_args(int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
              int window) {
  return B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || D < 1 ||
         window < 0 || (window > 0 && !causal) || (causal && Sk != Sq);
}

}  // namespace

extern "C" {

// As flash_attention_fwd (flash_attention.cu), for any head dim D ≥ 1 (the
// wrapper sends D > 256 here): o (B,Hq,Sq,D) and, with a non-null lse,
// lse (B,Hq,Sq) fp32, from q (B,Hq,Sq,D) and k, v (B,Hkv,Sk,D), contiguous
// and of one dtype (0 fp32, 1 bf16); Sk = Sq where causal; window > 0
// (causal only): the sliding window, 0: none.
int flash_attention_wide_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int dtype, int B, int Hq,
                             int Hkv, int Sq, int Sk, int D, float scale,
                             int causal, int window, void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, D, causal, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return launch_fwd<float>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, scale,
                               causal, window, s);
    case 1:
      return launch_fwd<bf16>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, scale,
                              causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As flash_attention_bwd (flash_attention_bwd.cu), for any head dim D ≥ 1:
// dq (B,Hq,Sq,D), and dk_h, dv_h (B,Hq,Sk,D) per query head.  Launches
// the dq kernel, then the dk/dv kernel.
int flash_attention_wide_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk_h,
                             void* dv_h, int dtype, int B, int Hq, int Hkv,
                             int Sq, int Sk, int D, float scale, int causal,
                             int window, void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, D, causal, window))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(q, k, v, dout, l, dl, dq, dk_h, dv_h, B, Hq,
                               Hkv, Sq, Sk, D, scale, causal, window, s);
    case 1:
      return launch_bwd<bf16>(q, k, v, dout, l, dl, dq, dk_h, dv_h, B, Hq,
                              Hkv, Sq, Sk, D, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
