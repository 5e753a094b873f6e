// The Mamba-1 selective scan for Hopper (sm_90a), compiled into the port's
// one library (repro_torch/kernels/cudalib.py) and bound through a plain C
// interface.
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernel
//   repro/kernels/ssm_scan/kernel.py::selective_scan (_ssm_kernel):
//     h_t = exp(dt_t·A) ⊙ h_{t−1} + (dt_t·x_t) ⊗ B_t,
//     y_t = ⟨h_t, C_t⟩_N + D·x_t,
//   with the (Din, N) state carried across the time chunks in fp32 and y
//   written in x's dtype.  The TPU kernel starts from a zero state and drops
//   the final one; this one also takes an optional h0 and writes h_T
//   (Bt, Din, N) fp32, which the serving path keeps as the prompt's SSM
//   state.  Without h0, y is the TPU kernel's.
//
// What bounds it: bytes.  Each input is read once and y written once — at
// falcon-mamba-7b's prefill (Bt=4, T=1024, Din=8192, N=16, x bf16, dt fp32)
// about 0.27 GB, 0.08 ms at 3.35 TB/s — against about 5 fp32 operations
// and one exp per (t, channel, state), 2.7 GFLOP, 0.04 ms at 67 TFLOP/s.
//
// Design.  The TPU walks (batch, T/chunk) in order with the state in VMEM.
// Here the recurrence is independent per (batch, channel): one thread owns
// one channel's N states in registers and walks T, so Bt·Din threads (512
// blocks of 64 at falcon-mamba's width, all resident at once) cover the
// card.  Per 16-step chunk the block stages B_t and C_t in shared memory
// (every channel of the batch row reads the same N values: broadcasts) and
// each thread loads its chunk of x and dt into registers before the
// dependent walk, so the loads are in flight together; consecutive threads
// read consecutive channels (coalesced).  Any T runs.  No atomics: two
// calls agree bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 64;   // channels per block
constexpr int kChunk = 16;         // time steps staged at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as Tensor.to
}

template <typename T, int N>
__global__ void __launch_bounds__(kScanThreads)
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ Dv,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ hT, int T_len, int Din) {
  __shared__ float sb[kChunk][N];
  __shared__ float sc[kChunk][N];
  const int d = blockIdx.x * kScanThreads + threadIdx.x;
  const int b = blockIdx.y;
  const bool active = d < Din;
  const size_t row0 = (size_t)b * T_len;

  float a_row[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a_row[n] = active ? A[(size_t)d * N + n] : 0.f;
    h[n] = (active && h0 != nullptr) ? h0[((size_t)b * Din + d) * N + n]
                                     : 0.f;
  }
  const float dd = active ? Dv[d] : 0.f;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int len = min(kChunk, T_len - t0);
    __syncthreads();  // the previous chunk's reads of sb and sc are done
    for (int e = threadIdx.x; e < len * N; e += kScanThreads) {
      sb[e / N][e % N] = to_f32(Bm[(row0 + t0) * N + e]);
      sc[e / N][e % N] = to_f32(Cm[(row0 + t0) * N + e]);
    }
    float xr[kChunk], dr[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool ok = active && i < len;
      const size_t off = (row0 + t0 + i) * Din + d;
      xr[i] = ok ? to_f32(x[off]) : 0.f;
      dr[i] = ok ? dt[off] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < len) {
        const float u = dr[i] * xr[i];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float a = expf(dr[i] * a_row[n]);
          h[n] = a * h[n] + u * sb[i][n];
          acc += h[n] * sc[i][n];
        }
        store(y + (row0 + t0 + i) * Din + d, acc + dd * xr[i]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < N; ++n) hT[((size_t)b * Din + d) * N + n] = h[n];
  }
}

template <typename T, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* Dv, const float* h0, void* y,
           float* hT, int Bt, int T_len, int Din, cudaStream_t s) {
  const dim3 grid((Din + kScanThreads - 1) / kScanThreads, Bt);
  selective_scan_kernel<T, N><<<grid, kScanThreads, 0, s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), Dv, h0, static_cast<T*>(y), hT, T_len, Din);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_state(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, const float* Dv,
                 const float* h0, void* y, float* hT, int Bt, int T_len,
                 int Din, int N, cudaStream_t s) {
  switch (N) {
    case 4: return launch<T, 4>(x, dt, A, Bm, Cm, Dv, h0, y, hT, Bt, T_len, Din, s);
    case 8: return launch<T, 8>(x, dt, A, Bm, Cm, Dv, h0, y, hT, Bt, T_len, Din, s);
    case 16: return launch<T, 16>(x, dt, A, Bm, Cm, Dv, h0, y, hT, Bt, T_len, Din, s);
    case 32: return launch<T, 32>(x, dt, A, Bm, Cm, Dv, h0, y, hT, Bt, T_len, Din, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// y (Bt,T,Din) in x's dtype and hT (Bt,Din,N) fp32 from x (Bt,T,Din), dt
// (Bt,T,Din) fp32, A (Din,N) fp32, B and C (Bt,T,N) in x's dtype, D (Din,)
// fp32 and an optional h0 (Bt,Din,N) fp32 (null: zeros); all contiguous;
// dtype 0 fp32, 1 bf16; N in {4, 8, 16, 32}.
int selective_scan_fwd(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* Dv,
                       const float* h0, void* y, float* hT, int dtype, int Bt,
                       int T_len, int Din, int N, void* stream) {
  if (Bt < 1 || T_len < 1 || Din < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_state<float>(x, dt, A, Bm, Cm, Dv, h0, y, hT, Bt, T_len,
                                 Din, N, s);
    case 1:
      return launch_state<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, h0, y, hT, Bt,
                                         T_len, Din, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
