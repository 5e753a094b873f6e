// Causal / bidirectional GQA attention with an online softmax (the
// forward, with or without its log-sum-exp) for Hopper (sm_90a), compiled
// into the port's one library (repro_torch/kernels/cudalib.py) and bound
// through a plain C interface.
//
// Source note
// -----------
// Replaces two of the JAX package's Pallas TPU kernels, one body each:
//   repro/kernels/flash_attention/kernel.py::flash_attention (_flash_kernel):
//     o = softmax(q·kᵀ·scale, masked) · v per (batch, query head), query
//     head h reading KV head h // (Hq/Hkv), with an fp32 running max m, sum
//     l and accumulator carried across the k-blocks, the −1e30 mask value,
//     causal k-blocks wholly above the diagonal skipped, and the l == 0 → 1
//     guard at the end;
//   ...::flash_attention_fwd_lse (_flash_fwd_lse_kernel): the same o, and
//     lse = m + log(l, guarded) per row in fp32 for the training backward
//     (flash_attention_bwd.cu): the same kernel, given an lse output.
//
// What bounds it: operations.  Granite-3-2b's prefill (B=8, Hq=32, S=1024,
// D=64, causal) is 2·2·B·Hq·D·S²/2 ≈ 34 GFLOP a layer against 84 MB of q,
// k, v and o in bf16: 0.035 ms at the 989 TFLOP/s bf16 tensor-core rate,
// 0.025 ms of bytes.  This first kernel computes in fp32 on the CUDA cores
// (67 TFLOP/s), so that it agrees with its plain version to fp32 round-off
// whatever the input dtype; tensor cores (mma/wgmma on bf16 tiles) are the
// later step, and the kernel sits 10–50× above the bound until then.
//
// Design.  The TPU grid (B, Hq, S/bq, S/bk) runs the k-blocks in order and
// keeps the accumulator in VMEM scratch.  Here one block of 256 threads owns
// one (b, h, 64-row q-tile) and loops over the 64-key k-tiles itself, so
// nothing carries between blocks.  The q-tile is staged once, transposed,
// in shared memory; each k-tile's K (transposed) and V are staged in
// shared memory, converted to fp32.  Thread (ty, tx) of the 16×16 grid
// holds a 4×4 block of scores (rows 4ty.., keys 4tx..) and, for the product
// with V, the same 4 rows by D/16 columns of the accumulator; the row max
// and row sum reduce over the 16 threads of a row group with warp shuffles.
// Probabilities pass through shared memory between the two products.  Rows
// and keys past S are masked (zero-filled tiles, −1e30 scores), so any S
// runs — the TPU's rule that S divides by the block is not kept.  Causal
// k-tiles above the diagonal are never loaded, and the grid hands out the
// heaviest (last) q-tiles first.  No atomics: two calls agree bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kBK = 64;               // keys per k-tile
constexpr int kThreads = 256;         // 16 × 16
constexpr int kLd = kBQ + 4;          // row stride of qᵀ, kᵀ and p tiles
constexpr float kNegInf = -1e30f;     // the reference's mask value
static_assert(kBQ == kBK, "the transposed q and k tiles share kLd");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as Tensor.to
}

// column of the accumulator that thread tx holds in slot c (D/16 slots):
// float4 groups of 64 columns for D >= 64, single columns strided by 16
// below that; either way a half-warp reads contiguous shared memory
template <int D>
__device__ __forceinline__ int acc_col(int tx, int c) {
  if constexpr (D >= 64) {
    return 64 * (c / 4) + 4 * tx + (c % 4);
  } else {
    return 16 * c + tx;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Hq, int Hkv, int S, float scale,
                 int causal) {
  constexpr int DC = D / 16;          // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // [D][kLd]   q tile, transposed
  float* kt = qt + D * kLd;           // [D][kLd]   k tile, transposed
  float* vs = kt + D * kLd;           // [kBK][D]   v tile
  float* ps = vs + kBK * D;           // [kBQ][kLd] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                       // jnp.repeat's order
  const T* qp = q + ((size_t)(b * Hq + h) * S) * D;
  const T* kp = k + ((size_t)(b * Hkv + hk) * S) * D;
  const T* vp = v + ((size_t)(b * Hkv + hk) * S) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qt[d * kLd + r] = q0 + r < S ? to_f32(qp[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt_all = (S + kBK - 1) / kBK;
  // causal: k-tiles starting past this q-tile's last row are skipped
  const int n_kt = causal ? min(n_kt_all, (q0 + kBQ - 1) / kBK + 1)
                          : n_kt_all;
  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kBK;
    __syncthreads();  // the previous tile's reads of kt, vs and ps are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool ok = k0 + r < S;
      const size_t off = (size_t)(k0 + r) * D + d;
      kt[d * kLd + r] = ok ? to_f32(kp[off]) : 0.f;
      vs[r * D + d] = ok ? to_f32(vp[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * kLd + 4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(kt + d * kLd + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const bool valid = col < S && (!causal || col <= row);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
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
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha[i];
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + (4 * ty + i) * kLd + kk);
        pr[i][0] = p4.x;
        pr[i][1] = p4.y;
        pr[i][2] = p4.z;
        pr[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * D;
        float vv[DC];
        if constexpr (D >= 64) {
#pragma unroll
          for (int g = 0; g < DC / 4; ++g) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(vrow + 64 * g + 4 * tx);
            vv[4 * g] = v4.x;
            vv[4 * g + 1] = v4.y;
            vv[4 * g + 2] = v4.z;
            vv[4 * g + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < DC; ++c) vv[c] = vrow[acc_col<D>(tx, c)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            acc[i][c] = fmaf(pr[i][u], vv[c], acc[i][c]);
      }
    }
  }

  T* op = o + ((size_t)(b * Hq + h) * S) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(op + (size_t)row * D + acc_col<D>(tx, c), acc[i][c] / lsafe);
    // m and l are whole-row values in each of the row's 16 threads
    if (lse != nullptr && tx == 0)
      lse[(size_t)(b * Hq + h) * S + row] = m[i] + logf(lsafe);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * D * kLd + kBK * D + kBQ * kLd);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int S, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, S, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int S, int D, float scale,
               int causal, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, Hq, Hkv, S, scale, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, Hq, Hkv, S, scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, Hq, Hkv, S, scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Hq, Hkv, S, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o (B,Hq,S,D) = attention of q (B,Hq,S,D) over k, v (B,Hkv,S,D), all
// contiguous and of one dtype (0 fp32, 1 bf16); D in {16, 32, 64, 128}.
// With a non-null lse, also lse (B,Hq,S) fp32 = m + log(l, guarded) per
// row (the training forward).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int dtype, int B, int Hq, int Hkv, int S,
                        int D, float scale, int causal, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return launch_dim<float>(q, k, v, o, l, B, Hq, Hkv, S, D, scale,
                               causal, s);
    case 1:
      return launch_dim<__nv_bfloat16>(q, k, v, o, l, B, Hq, Hkv, S, D,
                                       scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
