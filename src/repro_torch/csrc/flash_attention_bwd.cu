// The FlashAttention-2 backward of causal / bidirectional GQA attention for
// Hopper (sm_90a), compiled into the port's one library
// (repro_torch/kernels/cudalib.py) and bound through a plain C interface.
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernels
//   repro/kernels/flash_attention/kernel.py::flash_attention_bwd
//     (_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel):
//     given q, k, v, dO, the forward's lse and delta = Σ_D o·dO (fp32,
//     computed outside the kernels), recompute p = exp(s − lse) with
//     s = q·kᵀ·scale masked to −1e30, dp = dO·vᵀ, ds = p·(dp − delta)·scale;
//     then dq = ds·k (per query head), dv = pᵀ·dO and dk = dsᵀ·q per *query*
//     head, written in q's dtype as (B, Hq, S, D).  The sum over each KV
//     head's query-head group happens outside, in a fixed order, after the
//     per-head rounding to q's dtype, as in the reference.
//
// What bounds it: operations.  At granite-3-2b's training shape (B=8,
// Hq=32, S=1024, D=64, causal) the backward is 2.5× the forward's
// products, about 86 GFLOP a layer: 0.087 ms at the 989 TFLOP/s bf16
// tensor-core rate.  Both kernels recompute s and dp (7 products against
// the 5 of a backward that accumulates dq with atomics), and each score
// takes one exp2 in each kernel.  Its bytes, each input read and each
// output written once, take 0.05 ms at 3.35 TB/s.
//
// Design.  The TPU grids run their innermost axis in order and keep the
// accumulators in VMEM scratch.  Here each block owns a whole reduction,
// so nothing carries between blocks and no atomics are needed: two calls
// agree bitwise.
//
// bf16: two tensor-core kernels (mma.sync.m16n8k16, bf16 in, fp32
// accumulate; the building blocks in flash_tc.cuh), 4 warps a block, each
// warp owning m_tiles<D>() 16-row tiles (two at D ≤ 64, one above; D = 112
// and 160 are multiples of 16 like the rest, so every k-step, 16-byte
// chunk and padded row holds as in the forward):
//   dq:  one block per (b, h, q-tile of 64·m_tiles rows) loops over the
//        k-tiles up to the diagonal, K and V double-buffered with cp.async,
//        the q and dO fragments in registers at D ≤ 64: S = Q·Kᵀ and dP =
//        dO·Vᵀ on mma, p = 2^(s·scale·log2e − lse·log2e) (one FFMA and
//        ex2.approx), ds = p·(dp − delta) in registers, and dQ += dS·K with
//        dS rounded to bf16 in registers into the A operand and K read
//        through ldmatrix.trans; the scale applies once at the end.  At
//        D ≤ 64 (two m-tiles) and at D = 256 (a 128-register accumulator)
//        a k-tile is taken in two halves of 32 keys, so the score
//        fragments fit beside the accumulators.
//   dkv: one block per (b, h_q, k-tile of 64·m_tiles keys) loops over the
//        q-tiles from the diagonal on (causal).  It computes the transposed
//        products Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so pᵀ and dsᵀ come out in the
//        accumulator layout, and those fragments, rounded to bf16, are the
//        A operands of dV += Pᵀ·dO and dK += dSᵀ·Q (dO and Q through
//        ldmatrix.trans): no shared-memory transpose.  K and V load once;
//        Q, dO and the q-tile's lse and delta stream through a cp.async
//        double buffer; the q-tile is taken in two halves of 32 rows.
//        At D = 256 dk and dv would hold 256 fp32 a lane: two blocks share
//        a k-tile, each recomputing pᵀ and dsᵀ over the whole head dim and
//        accumulating half of dk's and dv's columns (dkv_splits).
// Shared memory at D=64: 74–75 KB a block in each kernel (the block's own
// pair, q and dO or k and v, at 128 rows, and the streamed pair
// double-buffered at 64 rows); the fp32 kernels' staged tiles took 105 KB
// for 64 rows.  p and ds round to bf16 once before their
// products, as the library's backward does; the gate for these kernels is
// chip_smoke.py's library-anchored one.
//
// fp32: the first kernels of the port, kept as they were, computing in
// fp32 on the CUDA cores (67 TFLOP/s) so that fp32 inputs agree with the
// plain version to fp32 round-off.  Each thread (ty, tx) of a 16×16 grid
// holds a 4×4 block of scores; every tile is staged transposed ([D][68]
// floats) in shared memory: the score products read float4 rows of two
// transposed tiles; the accumulating products read a float4 of four
// consecutive rows/keys of one column, which a quarter-warp takes from 32
// distinct banks (the row stride 68 ≡ 4 mod 32).  p and ds pass through
// shared memory between the products.
//
// In every kernel rows and keys past S are zero-filled and masked, so any S
// runs.
//
// Sliding window (window = W > 0, causal only; 0: none), as in the forward:
// key col counts for row row iff row − W < col <= row.  The dq kernels
// start their k-tile loop at the tile holding the q-tile's first row's
// first key; the dk/dv kernels end their q-tile loop at the tile holding
// the k-tile's last key's last row (key + W − 1), so the q-tile range of a
// k-tile has two ends.  A warp skips a tile (or chunk) wholly outside its
// own rows' or keys' band, the band's lower edge joins the masked-tile
// test, and p is 0 outside it.  At W >= S the result is the causal one
// bitwise.
//
// Cross attention (causal = 0, Sk ≠ Sq allowed), as in the forward: q, dO,
// dq, lse and delta have Sq rows, k, v and the per-query-head dk_h, dv_h
// Sk.  The dq kernels' q-tile grid and their row masks count Sq, their
// k-tile loop, loads and column masks Sk; the dk/dv kernels' k-tile grid
// and key masks count Sk, their q-tile loop, loads and row masks Sq.
// Causal attention needs Sk = Sq, so there both are the one S they were.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

namespace tc = flash_tc;
using tc::bf16;

// ---- fp32: the CUDA-core kernels -------------------------------------------

constexpr int kBQ = 64;               // query rows per tile
constexpr int kBK = 64;               // keys per tile
constexpr int kThreads = 256;         // 16 × 16
constexpr int kLd = kBQ + 4;          // row stride of every staged tile
static_assert(kBQ == kBK, "the transposed tiles share kLd");
static_assert(kBQ == tc::kRows, "all kernels tile 64 × 64");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Above D = 160 the four transposed [D][kLd] tiles do not fit a block's
// shared memory (D = 256: 278,528 bytes of them), so the streamed pair
// takes turns in one buffer: the dq kernel stages v, takes dp = dO·vᵀ,
// then stages k over it for s and for dq += ds·k; the dk/dv kernel stages
// dO for dp, q for s and dk += dsᵀ·q, then dO again for dv += pᵀ·dO, with
// p and ds taking turns in one [64][kLd] tile too.  Every product sums in
// the same order as with the four tiles.
template <int D>
constexpr bool kLean = D > 160;

template <typename T, int D>
__device__ __forceinline__ void stage_t(float* dst, const T* src, int r0,
                                        int S, int tid) {
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[d * kLd + r] = r0 + r < S ? to_f32(src[(size_t)(r0 + r) * D + d])
                                  : 0.f;
  }
}

// a[i][j] += Σ_d x[d][4·ty + i] · y[d][4·tx + j] over two transposed tiles
template <int D>
__device__ __forceinline__ void outer4(float (&a)[4][4], const float* x,
                                       const float* y, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
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

// acc[i][c] += Σ_r w[4·ty + i][r] · z[tx + 16c][r] over the 64 rows r:
// w is a [64][kLd] tile (p or ds), z a transposed [D][kLd] tile
template <int D>
__device__ __forceinline__ void accum(float (&acc)[4][D / 16], const float* w,
                                      const float* z, int ty, int tx) {
  constexpr int DC = D / 16;
#pragma unroll 2
  for (int r = 0; r < kBQ; r += 4) {
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
    for (int c = 0; c < DC; ++c) {
      const float4 z4 =
          *reinterpret_cast<const float4*>(z + (tx + 16 * c) * kLd + r);
      const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][c] = fmaf(wr[i][u], zv[u], acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Hq, int Hkv, int Sq, int Sk, float scale, int causal,
                    int window) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // [D][kLd] q tile, transposed
  float* dot = qt + D * kLd;          // [D][kLd] dO tile, transposed
  float* kt = dot + D * kLd;          // [D][kLd] k tile, transposed
  float* vt = kLean<D> ? kt : kt + D * kLd;  // [D][kLd] v tile (lean: kt's)
  float* dss = vt + D * kLd;          // [kBQ][kLd] ds
  float* lse_s = dss + kBQ * kLd;     // [kBQ]
  float* delta_s = lse_s + kBQ;       // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                       // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const T* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;

  stage_t<T, D>(qt, q + qoff * D, q0, Sq, tid);
  stage_t<T, D>(dot, dout + qoff * D, q0, Sq, tid);
  if (tid < kBQ) {
    const bool ok = q0 + tid < Sq;
    lse_s[tid] = ok ? lse[qoff + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int n_kt_all = (Sk + kBK - 1) / kBK;
  // causal: k-tiles starting past this q-tile's last row are skipped
  const int n_kt = causal ? min(n_kt_all, (q0 + kBQ - 1) / kBK + 1)
                          : n_kt_all;
  // window: k-tiles ending before the q-tile's first row's window too
  const int it0 = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * kBK;
    __syncthreads();  // the previous tile's reads of kt, vt and dss are done
    float s[4][4] = {}, dp[4][4] = {};
    if constexpr (kLean<D>) {
      stage_t<T, D>(vt, vp, k0, Sk, tid);
      __syncthreads();
      outer4<D>(dp, dot, vt, ty, tx);
      __syncthreads();  // every thread is done with v before k replaces it
      stage_t<T, D>(kt, kp, k0, Sk, tid);
      __syncthreads();
      outer4<D>(s, qt, kt, ty, tx);
    } else {
      stage_t<T, D>(kt, kp, k0, Sk, tid);
      stage_t<T, D>(vt, vp, k0, Sk, tid);
      __syncthreads();
      outer4<D>(s, qt, kt, ty, tx);
      outer4<D>(dp, dot, vt, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int row = q0 + r;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const bool valid = row < Sq && col < Sk && (!causal || col <= row) &&
                           (window == 0 || col > row - window);
        const float p = valid ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds[j] = p * (dp[i][j] - delta_s[r]) * scale;
      }
      *reinterpret_cast<float4*>(dss + r * kLd + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    accum<D>(acc, dss, kt, ty, tx);
  }

  T* dqp = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(dqp + (size_t)row * D + tx + 16 * c, acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk_h,
                     T* __restrict__ dv_h, int Hq, int Hkv, int Sq, int Sk,
                     float scale, int causal, int window) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                   // [D][kLd] k tile, transposed
  float* vt = kt + D * kLd;           // [D][kLd] v tile, transposed
  float* qt = vt + D * kLd;           // [D][kLd] q tile, transposed
  float* dot = kLean<D> ? qt : qt + D * kLd;  // [D][kLd] dO tile (lean: qt's)
  float* pt = dot + D * kLd;          // [kBK][kLd] pᵀ (key rows)
  float* dst = kLean<D> ? pt : pt + kBK * kLd;  // [kBK][kLd] dsᵀ (lean: pt's)
  float* lse_s = dst + kBK * kLd;     // [kBQ]
  float* delta_s = lse_s + kBQ;       // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;    // causal: the first k-tiles are heaviest
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* qp = q + qoff * D;
  const T* dop = dout + qoff * D;

  stage_t<T, D>(kt, k + ((size_t)(b * Hkv + hk) * Sk) * D, k0, Sk, tid);
  stage_t<T, D>(vt, v + ((size_t)(b * Hkv + hk) * Sk) * D, k0, Sk, tid);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // causal: q-tiles whose last row lies before this k-tile are skipped;
  // window: so are those starting past its last key's last row
  const int n_qt = window > 0
      ? min((Sq + kBQ - 1) / kBQ, (k0 + kBK - 1 + window - 1) / kBQ + 1)
      : (Sq + kBQ - 1) / kBQ;
  for (int qi = causal ? k0 / kBQ : 0; qi < n_qt; ++qi) {
    const int q0 = qi * kBQ;
    __syncthreads();  // the previous tile's reads of qt, dot, pt, dst done
    if (tid < kBQ) {
      const bool ok = q0 + tid < Sq;
      lse_s[tid] = ok ? lse[qoff + q0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
    }
    float s[4][4] = {}, dp[4][4] = {};   // [key 4ty + i][query 4tx + j]
    if constexpr (kLean<D>) {
      stage_t<T, D>(dot, dop, q0, Sq, tid);
      __syncthreads();
      outer4<D>(dp, vt, dot, ty, tx);
      __syncthreads();  // every thread is done with dO before q replaces it
      stage_t<T, D>(qt, qp, q0, Sq, tid);
      __syncthreads();
      outer4<D>(s, kt, qt, ty, tx);
    } else {
      stage_t<T, D>(qt, qp, q0, Sq, tid);
      stage_t<T, D>(dot, dop, q0, Sq, tid);
      __syncthreads();
      outer4<D>(s, kt, qt, ty, tx);
      outer4<D>(dp, vt, dot, ty, tx);
    }
    float pk[4][4];                      // p kept for the lean dv pass
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * ty + i;
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * tx + j;
        const int row = q0 + r;
        const bool valid = row < Sq && key < Sk && (!causal || key <= row) &&
                           (window == 0 || key > row - window);
        p[j] = valid ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds[j] = p[j] * (dp[i][j] - delta_s[r]) * scale;
        pk[i][j] = p[j];
      }
      if constexpr (!kLean<D>)
        *reinterpret_cast<float4*>(pt + (4 * ty + i) * kLd + 4 * tx) =
            make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dst + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    if constexpr (kLean<D>) {
      accum<D>(dk, dst, qt, ty, tx);
      __syncthreads();  // every thread is done with ds and q
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(pt + (4 * ty + i) * kLd + 4 * tx) =
            make_float4(pk[i][0], pk[i][1], pk[i][2], pk[i][3]);
      stage_t<T, D>(dot, dop, q0, Sq, tid);
      __syncthreads();
      accum<D>(dv, pt, dot, ty, tx);
    } else {
      accum<D>(dv, pt, dot, ty, tx);
      accum<D>(dk, dst, qt, ty, tx);
    }
  }

  const size_t koff = (size_t)(b * Hq + h) * Sk;   // this head's dk_h rows
  T* dkp = dk_h + koff * D;
  T* dvp = dv_h + koff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(dkp + (size_t)key * D + tx + 16 * c, dk[i][c]);
      store(dvp + (size_t)key * D + tx + 16 * c, dv[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((kLean<D> ? 3 : 4) * D * kLd + kBQ * kLd +
                          2 * kBQ);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((kLean<D> ? 3 : 4) * D * kLd +
                          (kLean<D> ? 1 : 2) * kBK * kLd + 2 * kBQ);
}
// the H100's opt-in shared memory a block: at D = 160 the dq kernel takes
// 192,000 bytes and the dk/dv kernel 209,408, the latter only just; at
// D = 256 the lean layout takes 226,816 in each
constexpr size_t kSmemOptIn = 232448;
static_assert(dq_smem<160>() == 192000 && dq_smem<256>() == 226816 &&
                  dq_smem<256>() <= kSmemOptIn,
              "the fp32 dq kernel's tiles fit one block at every head dim");
static_assert(dkv_smem<160>() == 209408 && dkv_smem<256>() == 226816 &&
                  dkv_smem<256>() <= kSmemOptIn,
              "the fp32 dk/dv kernel's tiles fit one block at every head "
              "dim");

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk_h,
           void* dv_h, int B, int Hq, int Hkv, int Sq, int Sk, float scale,
           int causal, int window, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem<D>();
  constexpr size_t smem_dkv = dkv_smem<D>();
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dkv);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid_q((Sq + kBQ - 1) / kBQ, Hq, B);   // q-tiles (dq)
  const dim3 grid_k((Sk + kBK - 1) / kBK, Hq, B);   // k-tiles (dk, dv)
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, smem_dq, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Hq, Hkv, Sq, Sk,
      scale, causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, D><<<grid_k, kThreads, smem_dkv, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk_h),
      static_cast<T*>(dv_h), Hq, Hkv, Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk_h,
               void* dv_h, int B, int Hq, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, int w, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, Sq, Sk, scale, causal, w, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, Sq, Sk, scale, causal, w, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, Sq, Sk, scale, causal, w, s);
    case 112:
      return launch<T, 112>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    case 160:
      return launch<T, 160>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    case 256:
      return launch<T, 256>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---- bf16: the tensor-core kernels -----------------------------------------

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int Hq, int Hkv, int Sq, int Sk, float scale,
                       int causal, int window) {
  constexpr int MQ = tc::m_tiles<D>();
  constexpr int BQ = tc::kWarps * 16 * MQ;  // query rows a block
  // keys a chunk of a k-tile: 32 at D = 256 too, so its score fragments
  // fit beside the 128 registers of the dq accumulator
  constexpr int KC = D > 160 ? 32 : 64 / MQ;
  constexpr int NK = KC / 8;          // 8-key tiles of a chunk
  constexpr int LD = tc::ld<D>();
  constexpr int TILE = tc::tile<D>();
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr bool kRegQ = D <= 64;     // q, dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD] q tile
  bf16* dos = qs + MQ * TILE;                     // [BQ][LD] dO tile
  bf16* ks = dos + MQ * TILE;                     // [2][64][LD] k tiles
  bf16* vs = ks + 2 * TILE;                       // [2][64][LD] v tiles

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16 * MQ;  // this warp's first row in the tile
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                      // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const bf16* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bf16* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float sl2 = scale * tc::kLog2e;
  // this lane's ldmatrix addresses (a k-tile buffer adds 2·TILE bytes)
  const uint32_t qa = tc::smem_u32(qs) + tc::a_lane(lane, LD) +
                      tc::at(wr, 0, LD);
  const uint32_t doa = qa + 2 * MQ * TILE;
  const uint32_t kbn = tc::smem_u32(ks) + tc::bn_lane(lane, LD);
  const uint32_t vbn = tc::smem_u32(vs) + tc::bn_lane(lane, LD);
  const uint32_t kbk = tc::smem_u32(ks) + tc::bk_lane(lane, LD);

  const int n_kt_all = (Sk + tc::kRows - 1) / tc::kRows;
  // causal: k-tiles starting past this q-tile's last row are skipped
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / tc::kRows + 1)
                          : n_kt_all;
  // window: k-tiles ending before the q-tile's first row's window too
  const int it0 = window > 0 ? max(0, q0 - window + 1) / tc::kRows : 0;
  const int w_lo = q0 + wr, w_hi = q0 + wr + 16 * MQ - 1;  // this warp's
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    tc::load_tile<D>(qs + i * TILE, q + qoff * D, q0 + i * tc::kRows, Sq,
                     tid);
    tc::load_tile<D>(dos + i * TILE, dout + qoff * D, q0 + i * tc::kRows, Sq,
                     tid);
  }
  tc::load_tile<D>(ks, kp, it0 * tc::kRows, Sk, tid);
  tc::load_tile<D>(vs, vp, it0 * tc::kRows, Sk, tid);
  tc::cp_async_commit();

  float lse2[MQ][2], dl[MQ][2];       // rows g and g + 8 (0 past Sq)
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + 16 * i + g + 8 * r;
      lse2[i][r] = row < Sq ? lse[qoff + row] * tc::kLog2e : 0.f;
      dl[i][r] = row < Sq ? delta[qoff + row] : 0.f;
    }
  uint32_t qf[kRegQ ? MQ : 1][kRegQ ? KD : 1][4];
  uint32_t dof[kRegQ ? MQ : 1][kRegQ ? KD : 1][4];
  float acc[MQ][ND][4];               // dq, rows g and g + 8 of each m-tile
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * tc::kRows;
    const int nb = (it - it0) & 1;    // this k-tile's buffer
    if (it + 1 < n_kt) {              // prefetch the next k-tile
      tc::load_tile<D>(ks + (nb ^ 1) * TILE, kp, k0 + tc::kRows, Sk, tid);
      tc::load_tile<D>(vs + (nb ^ 1) * TILE, vp, k0 + tc::kRows, Sk, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kRegQ) {
      if (it == it0) {
#pragma unroll
        for (int i = 0; i < MQ; ++i)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            tc::ldsm_x4(qf[i][kk], qa + tc::at(16 * i, 16 * kk, LD));
            tc::ldsm_x4(dof[i][kk], doa + tc::at(16 * i, 16 * kk, LD));
          }
      }
    }
    const uint32_t buf = nb * 2 * TILE;

#pragma unroll
    for (int c0 = 0; c0 < tc::kRows; c0 += KC) {
      // causal: a chunk wholly past this warp's last row adds nothing;
      // window: nor one wholly before its first row's window
      if (causal && k0 + c0 > w_hi) continue;
      if (window > 0 && k0 + c0 + KC - 1 <= w_lo - window) continue;
      float s[MQ][NK][4], dp[MQ][NK][4];  // 16 rows × KC keys an m-tile
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][n][e] = dp[i][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[MQ][4], ado[MQ][4];
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          if constexpr (kRegQ) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              aq[i][x] = qf[i][kk][x];
              ado[i][x] = dof[i][kk][x];
            }
          } else {
            tc::ldsm_x4(aq[i], qa + tc::at(16 * i, 16 * kk, LD));
            tc::ldsm_x4(ado[i], doa + tc::at(16 * i, 16 * kk, LD));
          }
        }
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, kbn + buf + tc::at(c0 + 16 * np, 16 * kk, LD));
#pragma unroll
          for (int i = 0; i < MQ; ++i) {
            tc::mma(s[i][2 * np], aq[i], bb[0], bb[1]);
            tc::mma(s[i][2 * np + 1], aq[i], bb[2], bb[3]);
          }
          tc::ldsm_x4(bb, vbn + buf + tc::at(c0 + 16 * np, 16 * kk, LD));
#pragma unroll
          for (int i = 0; i < MQ; ++i) {
            tc::mma(dp[i][2 * np], ado[i], bb[0], bb[1]);
            tc::mma(dp[i][2 * np + 1], ado[i], bb[2], bb[3]);
          }
        }
      }

      // ds = p·(dp − delta), unscaled, into s; masked on the diagonal and
      // the ragged tile (each row's dq is its own: rows past Sq need none)
      const bool edge = k0 + c0 + KC > Sk ||
                        (causal && k0 + c0 + KC - 1 > w_lo) ||
                        (window > 0 && k0 + c0 <= w_hi - window);
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = tc::ex2(fmaf(s[i][n][e], sl2, -lse2[i][r]));
            if (edge) {
              const int row = q0 + wr + 16 * i + g + 8 * r;
              const int col = k0 + c0 + 8 * n + 2 * t + (e & 1);
              if (col >= Sk || (causal && col > row) ||
                  (window > 0 && col <= row - window))
                p = 0.f;
            }
            s[i][n][e] = p * (dp[i][n][e] - dl[i][r]);
          }

      // dq += ds · k, ds rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t da[MQ][4];
#pragma unroll
        for (int i = 0; i < MQ; ++i)
          tc::a_from_c(da[i], s[i][2 * kk], s[i][2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, kbk + buf + tc::at(c0 + 16 * kk, 16 * dn, LD));
#pragma unroll
          for (int i = 0; i < MQ; ++i) {
            tc::mma(acc[i][2 * dn], da[i], bb[0], bb[1]);
            tc::mma(acc[i][2 * dn + 1], da[i], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  bf16* dqp = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + 16 * i + g + 8 * r;
      if (row >= Sq) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(dqp + (size_t)row * D + 8 * n + 2 * t) =
            tc::pack_bf16(acc[i][n][2 * r] * scale,
                          acc[i][n][2 * r + 1] * scale);
    }
}

// Blocks a k-tile's dk and dv columns are split over: above D = 160 the
// two accumulators (D/2 fp32 a lane each, 256 at D = 256) would not fit
// the 255 registers of a lane, so each of two blocks recomputes pᵀ and
// dsᵀ of the k-tile over the whole head dim and accumulates half of the
// columns of dk and dv
template <int D>
__host__ __device__ constexpr int dkv_splits() {
  return D > 160 ? 2 : 1;
}

// q rows a chunk of the dk/dv kernel's transposed products.  At D = 112
// and 160 the dk and dv accumulators (D/2 fp32 a lane each) and a 32-row
// chunk's scores spill 8 and 24 bytes; 16-row chunks spill none at 112
// and more at 160, and were slower at both (PERF.md §6)
constexpr int kQChunk = 32;

// q, dO, lse and delta of the q-tile from row q0 into one buffer
template <int D>
__device__ __forceinline__ void load_q_side(bf16* qs, bf16* dos, float* ls,
                                            float* dls, const bf16* q,
                                            const bf16* dout,
                                            const float* lse,
                                            const float* delta, int q0,
                                            int S, int tid) {
  tc::load_tile<D>(qs, q, q0, S, tid);
  tc::load_tile<D>(dos, dout, q0, S, tid);
  const int r = tid & (tc::kRows - 1);
  const bool ok = q0 + r < S;
  const size_t src = ok ? q0 + r : 0;
  if (tid < tc::kRows)
    tc::cp_async4(ls + r, lse + src, ok);
  else
    tc::cp_async4(dls + r, delta + src, ok);
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk_h, bf16* __restrict__ dv_h,
                        int Hq, int Hkv, int Sq, int Sk, float scale,
                        int causal, int window) {
  static_assert(tc::kThreads == 2 * tc::kRows, "lse and delta: a row each");
  constexpr int MK = tc::m_tiles<D>();
  constexpr int BK = tc::kWarps * 16 * MK;  // keys a block
  constexpr int LD = tc::ld<D>();
  constexpr int TILE = tc::tile<D>();
  constexpr int KD = D / 16;
  constexpr int DS = dkv_splits<D>();
  constexpr int DO = D / DS;          // dk, dv columns this block owns
  constexpr int ND = DO / 8;
  constexpr int NC = kQChunk / 8;     // 8-column tiles of a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD] k tile
  bf16* vs = ks + MK * TILE;                      // [BK][LD] v tile
  bf16* qs = vs + MK * TILE;                      // [2][64][LD] q tiles
  bf16* dos = qs + 2 * TILE;                      // [2][64][LD] dO tiles
  float* ls = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][64] lse
  float* dls = ls + 2 * tc::kRows;                       // [2][64] delta

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16 * MK;  // this warp's first key in the tile
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x / DS * BK;  // causal: first k-tiles heaviest
  const int c_lo = blockIdx.x % DS * DO;  // this block's first dk/dv column
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const bf16* qp = q + qoff * D;
  const bf16* dop = dout + qoff * D;
  const float* lp = lse + qoff;
  const float* dlp = delta + qoff;
  const float sl2 = scale * tc::kLog2e;
  // this lane's ldmatrix addresses (a q-tile buffer adds 2·TILE bytes)
  const uint32_t ka = tc::smem_u32(ks) + tc::a_lane(lane, LD) +
                      tc::at(wr, 0, LD);
  const uint32_t va = ka + 2 * MK * TILE;
  const uint32_t qbn = tc::smem_u32(qs) + tc::bn_lane(lane, LD);
  const uint32_t dobn = qbn + 4 * TILE;
  const uint32_t qbk = tc::smem_u32(qs) + tc::bk_lane(lane, LD);
  const uint32_t dobk = qbk + 4 * TILE;

  // causal: q-tiles whose last row lies before this k-tile are skipped;
  // window: so are those starting past its last key's last row
  const int n_qt = window > 0
      ? min((Sq + tc::kRows - 1) / tc::kRows,
            (k0 + BK - 1 + window - 1) / tc::kRows + 1)
      : (Sq + tc::kRows - 1) / tc::kRows;
  const int qi0 = causal ? k0 / tc::kRows : 0;
  const int k_lo = k0 + wr, k_hi = k0 + wr + 16 * MK - 1;  // this warp's
  const bf16* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bf16* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
#pragma unroll
  for (int i = 0; i < MK; ++i) {
    tc::load_tile<D>(ks + i * TILE, kp, k0 + i * tc::kRows, Sk, tid);
    tc::load_tile<D>(vs + i * TILE, vp, k0 + i * tc::kRows, Sk, tid);
  }
  load_q_side<D>(qs, dos, ls, dls, qp, dop, lp, dlp, qi0 * tc::kRows, Sq,
                 tid);
  tc::cp_async_commit();

  float dk[MK][ND][4], dv[MK][ND][4];  // keys g and g + 8 of each m-tile
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][n][e] = dv[i][n][e] = 0.f;

  for (int qi = qi0; qi < n_qt; ++qi) {
    const int buf = (qi - qi0) & 1;
    if (qi + 1 < n_qt) {              // prefetch the next q-tile
      load_q_side<D>(qs + (buf ^ 1) * TILE, dos + (buf ^ 1) * TILE,
                     ls + (buf ^ 1) * tc::kRows, dls + (buf ^ 1) * tc::kRows,
                     qp, dop, lp, dlp, (qi + 1) * tc::kRows, Sq, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qi * tc::kRows;
    const uint32_t qb = buf * 2 * TILE;
    const float* lt = ls + buf * tc::kRows;
    const float* dlt = dls + buf * tc::kRows;
    // causal: a q-tile wholly before this warp's first key adds nothing,
    // window: nor one wholly past its last key's window; rows past Sq
    // must not reach dk, dv; causal keys past a row, and keys at or before
    // row − window, are masked
    const bool skip = (causal && q0 + tc::kRows - 1 < k_lo) ||
                      (window > 0 && q0 - k_hi >= window);
    const bool edge = q0 + tc::kRows > Sq || (causal && k_hi > q0) ||
                      (window > 0 && q0 + tc::kRows - 1 - k_lo >= window);

#pragma unroll
    for (int c0 = 0; c0 < tc::kRows; c0 += kQChunk) {
      if (skip) break;
      float st[MK][NC][4], dpt[MK][NC][4];  // 16 keys × 32 q rows each
#pragma unroll
      for (int i = 0; i < MK; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][n][e] = dpt[i][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[MK][4], av[MK][4];  // this warp's keys, A fragments
#pragma unroll
        for (int i = 0; i < MK; ++i) {
          tc::ldsm_x4(ak[i], ka + tc::at(16 * i, 16 * kk, LD));
          tc::ldsm_x4(av[i], va + tc::at(16 * i, 16 * kk, LD));
        }
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, qbn + qb + tc::at(c0 + 16 * np, 16 * kk, LD));
#pragma unroll
          for (int i = 0; i < MK; ++i) {
            tc::mma(st[i][2 * np], ak[i], bb[0], bb[1]);
            tc::mma(st[i][2 * np + 1], ak[i], bb[2], bb[3]);
          }
          tc::ldsm_x4(bb, dobn + qb + tc::at(c0 + 16 * np, 16 * kk, LD));
#pragma unroll
          for (int i = 0; i < MK; ++i) {
            tc::mma(dpt[i][2 * np], av[i], bb[0], bb[1]);
            tc::mma(dpt[i][2 * np + 1], av[i], bb[2], bb[3]);
          }
        }
      }

      // pᵀ into st and dsᵀ = pᵀ·(dpᵀ − delta), unscaled, into dpt
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qr = c0 + 8 * n + 2 * t + c;        // row in the tile
          const float l2 = lt[qr] * tc::kLog2e, dl = dlt[qr];
#pragma unroll
          for (int i = 0; i < MK; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + c;
              float p = tc::ex2(fmaf(st[i][n][e], sl2, -l2));
              if (edge) {
                const int key = k0 + wr + 16 * i + g + 8 * r;
                const int row = q0 + qr;
                if (row >= Sq || (causal && key > row) ||
                    (window > 0 && key <= row - window))
                  p = 0.f;
              }
              st[i][n][e] = p;
              dpt[i][n][e] = p * (dpt[i][n][e] - dl);
            }
        }

      // dv += pᵀ · dO and dk += dsᵀ · q, both rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        uint32_t pa[MK][4], da[MK][4];
#pragma unroll
        for (int i = 0; i < MK; ++i) {
          tc::a_from_c(pa[i], st[i][2 * kk], st[i][2 * kk + 1]);
          tc::a_from_c(da[i], dpt[i][2 * kk], dpt[i][2 * kk + 1]);
        }
#pragma unroll
        for (int dn = 0; dn < DO / 16; ++dn) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb,
                        dobk + qb + tc::at(c0 + 16 * kk, c_lo + 16 * dn, LD));
#pragma unroll
          for (int i = 0; i < MK; ++i) {
            tc::mma(dv[i][2 * dn], pa[i], bb[0], bb[1]);
            tc::mma(dv[i][2 * dn + 1], pa[i], bb[2], bb[3]);
          }
          tc::ldsm_x4_t(bb,
                        qbk + qb + tc::at(c0 + 16 * kk, c_lo + 16 * dn, LD));
#pragma unroll
          for (int i = 0; i < MK; ++i) {
            tc::mma(dk[i][2 * dn], da[i], bb[0], bb[1]);
            tc::mma(dk[i][2 * dn + 1], da[i], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  const size_t koff = (size_t)(b * Hq + h) * Sk;   // this head's dk_h rows
  bf16* dkp = dk_h + koff * D;
  bf16* dvp = dv_h + koff * D;
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + wr + 16 * i + g + 8 * r;
      if (key >= Sk) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const size_t off = (size_t)key * D + c_lo + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(dkp + off) =
            tc::pack_bf16(dk[i][n][2 * r] * scale,
                          dk[i][n][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvp + off) =
            tc::pack_bf16(dv[i][n][2 * r], dv[i][n][2 * r + 1]);
      }
    }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk_h,
              void* dv_h, int B, int Hq, int Hkv, int Sq, int Sk, float scale,
              int causal, int window, cudaStream_t stream) {
  constexpr int M = tc::m_tiles<D>();
  // dq: q and dO (M staged tiles each), two k and two v tiles; dk/dv: k
  // and v (M each), two q and two dO tiles, two lse and two delta rows
  constexpr size_t smem_dq = (2 * M + 4) * tc::tile<D>() * sizeof(bf16);
  constexpr size_t smem_dkv = (2 * M + 4) * tc::tile<D>() * sizeof(bf16) +
                              4 * tc::kRows * sizeof(float);
  // D = 160: 129,024 and 130,048 bytes; D = 256: 202,752 and 203,776
  static_assert(smem_dkv <= kSmemOptIn, "the bf16 tiles fit one block");
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dkv);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int rows = tc::kWarps * 16 * M;   // rows (dq) or keys (dk/dv) a block
  const dim3 grid_q((Sq + rows - 1) / rows, Hq, B);
  const dim3 grid_k((Sk + rows - 1) / rows * dkv_splits<D>(), Hq, B);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  flash_bwd_dq_tc_kernel<D><<<grid_q, tc::kThreads, smem_dq, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq), Hq, Hkv, Sq, Sk,
      scale, causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_tc_kernel<D><<<grid_k, tc::kThreads, smem_dkv, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk_h),
      static_cast<bf16*>(dv_h), Hq, Hkv, Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

int launch_tc_dim(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk_h, void* dv_h, int B, int Hq, int Hkv,
                  int Sq, int Sk, int D, float scale, int causal, int w,
                  cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_tc<16>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, Sq, Sk, scale, causal, w, s);
    case 32:
      return launch_tc<32>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, Sq, Sk, scale, causal, w, s);
    case 64:
      return launch_tc<64>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, Sq, Sk, scale, causal, w, s);
    case 112:
      return launch_tc<112>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    case 128:
      return launch_tc<128>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    case 160:
      return launch_tc<160>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    case 256:
      return launch_tc<256>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dq (B,Hq,Sq,D), and dk_h, dv_h (B,Hq,Sk,D) per query head, from q
// (B,Hq,Sq,D), k, v (B,Hkv,Sk,D), dO (B,Hq,Sq,D), all contiguous and of one
// dtype (0 fp32: the CUDA-core kernels; 1 bf16: the tensor-core kernels,
// 16-byte aligned), and lse, delta (B,Hq,Sq) fp32; D in {16, 32, 64, 112,
// 128, 160, 256} (above 256: flash_attention_wide.cu; the wrapper
// zero-pads any other D up to 256 to the next
// one); Sk = Sq where causal.
// window > 0 (causal only): the sliding window; 0: none.  Launches the dq
// kernel, then the dk/dv kernel.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, void* dk_h, void* dv_h, int dtype, int B,
                        int Hq, int Hkv, int Sq, int Sk, int D, float scale,
                        int causal, int window, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || window < 0 ||
      (window > 0 && !causal) || (causal && Sk != Sq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0:
      return launch_dim<float>(q, k, v, dout, l, dl, dq, dk_h, dv_h, B, Hq,
                               Hkv, Sq, Sk, D, scale, causal, window, s);
    case 1:
      return launch_tc_dim(q, k, v, dout, l, dl, dq, dk_h, dv_h, B, Hq, Hkv,
                           Sq, Sk, D, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
