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
// tensor-core rate.  These first kernels compute in fp32 on the CUDA cores
// (67 TFLOP/s), recomputing s and dp in both kernels (3.5× the forward's
// products), so that they agree with the plain version to fp32 round-off
// whatever the input dtype; tensor cores are the later step.
//
// Design.  The TPU grids run their innermost axis in order and keep the
// accumulators in VMEM scratch.  Here each block owns a whole reduction,
// so nothing carries between blocks and no atomics are needed: two calls
// agree bitwise.
//   dq:  one block of 256 threads per (b, h, 64-row q-tile) loops over the
//        k-tiles up to the diagonal.  Thread (ty, tx) of the 16×16 grid
//        holds the 4×4 scores of rows 4ty.., keys 4tx.. and, for the
//        product with k, rows 4ty.. by the columns tx + 16c of dq.
//   dkv: one block per (b, h_q, 64-key k-tile) loops over the q-tiles from
//        the diagonal on (causal) and holds keys 4ty.. by the columns
//        tx + 16c of dk and dv.
// Every tile is staged transposed ([D][68] floats) in shared memory and
// converted to fp32: the score products read float4 rows of two transposed
// tiles; the accumulating products read a float4 of four consecutive
// rows/keys of one column, which a quarter-warp takes from 32 distinct
// banks (the row stride 68 ≡ 4 mod 32).  p and ds pass through shared
// memory between the products.  Rows and keys past S are zero-filled and
// masked, so any S runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // query rows per tile
constexpr int kBK = 64;               // keys per tile
constexpr int kThreads = 256;         // 16 × 16
constexpr int kLd = kBQ + 4;          // row stride of every staged tile
static_assert(kBQ == kBK, "the transposed tiles share kLd");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as Tensor.to
}

// dst[d * kLd + r] = src[(r0 + r) * D + d] for the 64 rows r from r0,
// zero past S
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
                    int Hq, int Hkv, int S, float scale, int causal) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // [D][kLd] q tile, transposed
  float* dot = qt + D * kLd;          // [D][kLd] dO tile, transposed
  float* kt = dot + D * kLd;          // [D][kLd] k tile, transposed
  float* vt = kt + D * kLd;           // [D][kLd] v tile, transposed
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
  const size_t qoff = (size_t)(b * Hq + h) * S;
  const T* kp = k + ((size_t)(b * Hkv + hk) * S) * D;
  const T* vp = v + ((size_t)(b * Hkv + hk) * S) * D;

  stage_t<T, D>(qt, q + qoff * D, q0, S, tid);
  stage_t<T, D>(dot, dout + qoff * D, q0, S, tid);
  if (tid < kBQ) {
    const bool ok = q0 + tid < S;
    lse_s[tid] = ok ? lse[qoff + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int n_kt_all = (S + kBK - 1) / kBK;
  // causal: k-tiles starting past this q-tile's last row are skipped
  const int n_kt = causal ? min(n_kt_all, (q0 + kBQ - 1) / kBK + 1)
                          : n_kt_all;
  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kBK;
    __syncthreads();  // the previous tile's reads of kt, vt and dss are done
    stage_t<T, D>(kt, kp, k0, S, tid);
    stage_t<T, D>(vt, vp, k0, S, tid);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    outer4<D>(s, qt, kt, ty, tx);
    outer4<D>(dp, dot, vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int row = q0 + r;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const bool valid = row < S && col < S && (!causal || col <= row);
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
    if (row >= S) continue;
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
                     T* __restrict__ dv_h, int Hq, int Hkv, int S,
                     float scale, int causal) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                   // [D][kLd] k tile, transposed
  float* vt = kt + D * kLd;           // [D][kLd] v tile, transposed
  float* qt = vt + D * kLd;           // [D][kLd] q tile, transposed
  float* dot = qt + D * kLd;          // [D][kLd] dO tile, transposed
  float* pt = dot + D * kLd;          // [kBK][kLd] pᵀ (key rows)
  float* dst = pt + kBK * kLd;        // [kBK][kLd] dsᵀ
  float* lse_s = dst + kBK * kLd;     // [kBQ]
  float* delta_s = lse_s + kBQ;       // [kBQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;    // causal: the first k-tiles are heaviest
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * S;
  const T* qp = q + qoff * D;
  const T* dop = dout + qoff * D;

  stage_t<T, D>(kt, k + ((size_t)(b * Hkv + hk) * S) * D, k0, S, tid);
  stage_t<T, D>(vt, v + ((size_t)(b * Hkv + hk) * S) * D, k0, S, tid);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (S + kBQ - 1) / kBQ;
  // causal: q-tiles whose last row lies before this k-tile are skipped
  for (int qi = causal ? k0 / kBQ : 0; qi < n_qt; ++qi) {
    const int q0 = qi * kBQ;
    __syncthreads();  // the previous tile's reads of qt, dot, pt, dst done
    stage_t<T, D>(qt, qp, q0, S, tid);
    stage_t<T, D>(dot, dop, q0, S, tid);
    if (tid < kBQ) {
      const bool ok = q0 + tid < S;
      lse_s[tid] = ok ? lse[qoff + q0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};   // [key 4ty + i][query 4tx + j]
    outer4<D>(s, kt, qt, ty, tx);
    outer4<D>(dp, vt, dot, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * ty + i;
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * tx + j;
        const int row = q0 + r;
        const bool valid = row < S && key < S && (!causal || key <= row);
        p[j] = valid ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds[j] = p[j] * (dp[i][j] - delta_s[r]) * scale;
      }
      *reinterpret_cast<float4*>(pt + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dst + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    accum<D>(dv, pt, dot, ty, tx);
    accum<D>(dk, dst, qt, ty, tx);
  }

  T* dkp = dk_h + qoff * D;
  T* dvp = dv_h + qoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(dkp + (size_t)key * D + tx + 16 * c, dk[i][c]);
      store(dvp + (size_t)key * D + tx + 16 * c, dv[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * kLd + kBQ * kLd + 2 * kBQ);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * D * kLd + 2 * kBK * kLd + 2 * kBQ);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk_h,
           void* dv_h, int B, int Hq, int Hkv, int S, float scale,
           int causal, cudaStream_t stream) {
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
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem_dq, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Hq, Hkv, S, scale,
      causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem_dkv, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk_h),
      static_cast<T*>(dv_h), Hq, Hkv, S, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk_h,
               void* dv_h, int B, int Hq, int Hkv, int S, int D, float scale,
               int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, S, scale, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, S, scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, S, scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, S, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dq (B,Hq,S,D), and dk_h, dv_h (B,Hq,S,D) per query head, from q
// (B,Hq,S,D), k, v (B,Hkv,S,D), dO (B,Hq,S,D), all contiguous and of one
// dtype (0 fp32, 1 bf16), and lse, delta (B,Hq,S) fp32; D in
// {16, 32, 64, 128}.  Launches the dq kernel, then the dk/dv kernel.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, void* dk_h, void* dv_h, int dtype, int B,
                        int Hq, int Hkv, int S, int D, float scale,
                        int causal, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0:
      return launch_dim<float>(q, k, v, dout, l, dl, dq, dk_h, dv_h, B, Hq,
                               Hkv, S, D, scale, causal, s);
    case 1:
      return launch_dim<__nv_bfloat16>(q, k, v, dout, l, dl, dq, dk_h, dv_h,
                                       B, Hq, Hkv, S, D, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
