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
// What bounds it: bytes, then the exponentials.  Each input is read once
// and y written once — at falcon-mamba-7b's prefill (Bt=4, T=1024,
// Din=8192, N=16, x bf16, dt fp32) about 0.27 GB, 0.081 ms at 3.35 TB/s.
// The walk takes one exp per (t, channel, state): 537 M there, which the
// special-function units (16 a clock an SM, 132 SMs, about 1.98 GHz) need
// about 0.13 ms for, above the byte bound; the fp32 pipe's five or so
// operations around each exp take about as long again in issue slots.
//
// Design.  The TPU walks (batch, T/chunk) in order with the state in VMEM.
// Here the recurrence is independent per (batch, channel, state), and each
// state is walked over T in order by one thread, so h_T rounds as the plain
// version's.  A channel's N states are split over N/8 neighbouring lanes,
// 8 each (all N at N ≤ 8): a block of 64 channels is 8·N threads, which at
// falcon-mamba's width puts 16 warps on each SM where one thread per
// channel gave 8 (4 states a lane gave 32 warps and ran slower on the
// H100: more shuffles and more per-step work per state).  y_t is the
// group's partial
// ⟨h_t, C_t⟩ added with xor shuffles (a fixed order, the same bits in
// every lane).  The block streams 32-step chunks of x, dt,
// B and C into shared memory with cp.async (16-byte copies along Din for x
// and dt, neighbouring threads on neighbouring addresses), two chunks in
// flight: the next chunk loads while this one is walked.  y goes out
// through shared memory in 16-byte stores.  exp(dt·A) is one ex2 of
// dt·(A·log2e), with A·log2e taken once per (channel, state).  A block whose 64 channels
// run past Din, or whose rows are not 16-byte aligned (odd Din), loads and
// stores element by element, so any T and any Din run.  No atomics: two
// calls agree bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

constexpr int kChannels = 64;  // channels a block owns
constexpr int kStates = 8;     // states a lane owns (all N when N is less)
constexpr int kChunk = 32;     // time steps staged at once
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
__host__ __device__ constexpr int states_per_lane() {
  return N < kStates ? N : kStates;
}

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
// (a decay that small leaves h_t = u·B_t either way)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as Tensor.to
}

template <typename T, int N>
struct Stage {
  T x[kChunk][kChannels];
  float dt[kChunk][kChannels];
  T b[kChunk][N];
  T c[kChunk][N];
};

// two chunk stages; the chunk's B and C in fp32 (converted once a chunk
// from a bf16 stream, so the walk reads S-wide float vectors); its y
template <typename T, int N>
struct ScanSmem {
  Stage<T, N> st[2];
  alignas(16) float bf[kChunk][N];
  alignas(16) float cf[kChunk][N];
  T y[kChunk][kChannels];
};

// a lane's S (a multiple of 4) consecutive fp32 B or C values, 16 bytes a load
template <int S>
__device__ __forceinline__ void load_states(const float* p, float (&o)[S]) {
#pragma unroll
  for (int s = 0; s < S; s += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + s);
    o[s] = v.x; o[s + 1] = v.y; o[s + 2] = v.z; o[s + 3] = v.w;
  }
}

// chunk rows t0 .. t0 + len of this block's channels (and of the batch
// row's B and C) into one stage; 16-byte cp.async where the block's rows
// are aligned and whole, element copies otherwise.  Commits one group.
template <typename T, int N>
__device__ __forceinline__ void load_chunk(
    Stage<T, N>& st, const T* x, const float* dt, const T* Bm, const T* Cm,
    size_t row0, int t0, int len, int d0, int Din, bool vec, bool bc_vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    constexpr int XV = kChannels * (int)sizeof(T) / 16;  // 16 B per row part
    constexpr int DV = kChannels * 4 / 16;
    for (int i = tid; i < len * XV; i += nt) {
      const int r = i / XV, q = i - r * XV;
      flash_tc::cp_async16(reinterpret_cast<char*>(&st.x[r][0]) + 16 * q,
                           reinterpret_cast<const char*>(
                               x + (row0 + t0 + r) * Din + d0) + 16 * q,
                           true);
    }
    for (int i = tid; i < len * DV; i += nt) {
      const int r = i / DV, q = i - r * DV;
      flash_tc::cp_async16(reinterpret_cast<char*>(&st.dt[r][0]) + 16 * q,
                           reinterpret_cast<const char*>(
                               dt + (row0 + t0 + r) * Din + d0) + 16 * q,
                           true);
    }
  } else {
    for (int i = tid; i < len * kChannels; i += nt) {
      const int r = i / kChannels, cc = i - r * kChannels;
      const bool ok = d0 + cc < Din;
      const size_t off = (row0 + t0 + r) * Din + d0 + cc;
      st.x[r][cc] = ok ? x[off] : T(0.0f);
      st.dt[r][cc] = ok ? dt[off] : 0.0f;
    }
  }
  const size_t bc0 = (row0 + t0) * N;
  if (bc_vec) {
    const int words = len * N * (int)sizeof(T) / 4;
    for (int i = tid; i < words; i += nt) {
      flash_tc::cp_async4(reinterpret_cast<char*>(&st.b[0][0]) + 4 * i,
                          reinterpret_cast<const char*>(Bm + bc0) + 4 * i, true);
      flash_tc::cp_async4(reinterpret_cast<char*>(&st.c[0][0]) + 4 * i,
                          reinterpret_cast<const char*>(Cm + bc0) + 4 * i, true);
    }
  } else {
    for (int i = tid; i < len * N; i += nt) {
      (&st.b[0][0])[i] = Bm[bc0 + i];
      (&st.c[0][0])[i] = Cm[bc0 + i];
    }
  }
  flash_tc::cp_async_commit();
}

template <typename T, int N>
__global__ void __launch_bounds__(kChannels * N / states_per_lane<N>())
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ Dv,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ hT, int T_len, int Din) {
  constexpr int S = states_per_lane<N>();
  constexpr int G = N / S;  // lanes a channel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem<T, N>& sm = *reinterpret_cast<ScanSmem<T, N>*>(smem_raw);
  const int cc = threadIdx.x / G;      // channel in the block
  const int sub = threadIdx.x % G;     // which 4 states of it
  const int n0 = sub * S;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + cc;
  const int b = blockIdx.y;
  const bool active = d < Din;
  const size_t row0 = (size_t)b * T_len;
  const bool vec =
      d0 + kChannels <= Din && (Din * sizeof(T)) % 16 == 0 && Din % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dt) |
        reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const bool bc_vec = ((reinterpret_cast<uintptr_t>(Bm) |
                        reinterpret_cast<uintptr_t>(Cm)) % 4) == 0;

  float a2[S], h[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a2[s] = active ? A[(size_t)d * N + n0 + s] * kLog2e : 0.f;
    h[s] = (active && h0 != nullptr) ? h0[((size_t)b * Din + d) * N + n0 + s]
                                     : 0.f;
  }
  const float dd = active ? Dv[d] : 0.f;

  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  load_chunk<T, N>(sm.st[0], x, dt, Bm, Cm, row0, 0, min(kChunk, T_len), d0,
                   Din, vec, bc_vec);
  if (n_chunks > 1) {
    load_chunk<T, N>(sm.st[1], x, dt, Bm, Cm, row0, kChunk,
                     min(kChunk, T_len - kChunk), d0, Din, vec, bc_vec);
  } else {
    flash_tc::cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kChunk;
    const int len = min(kChunk, T_len - t0);
    Stage<T, N>& st = sm.st[ch & 1];
    flash_tc::cp_async_wait<1>();  // this chunk's group has landed
    __syncthreads();
    for (int e = threadIdx.x; e < len * N; e += blockDim.x) {
      (&sm.bf[0][0])[e] = to_f32((&st.b[0][0])[e]);
      (&sm.cf[0][0])[e] = to_f32((&st.c[0][0])[e]);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < len; ++i) {
      const float xv = to_f32(st.x[i][cc]);
      const float dv = st.dt[i][cc];
      const float u = dv * xv;
      float bv[S], cv[S];
      load_states(&sm.bf[i][n0], bv);
      load_states(&sm.cf[i][n0], cv);
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float a = ex2(dv * a2[s]);
        h[s] = a * h[s] + u * bv[s];
        acc += h[s] * cv[s];
      }
#pragma unroll
      for (int o = 1; o < G; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (sub == 0) from_f32(&sm.y[i][cc], acc + dd * xv);
    }
    __syncthreads();  // the stage is free and y of the chunk is complete
    if (ch + 2 < n_chunks) {
      load_chunk<T, N>(st, x, dt, Bm, Cm, row0, t0 + 2 * kChunk,
                       min(kChunk, T_len - t0 - 2 * kChunk), d0, Din, vec,
                       bc_vec);
    } else {
      flash_tc::cp_async_commit();
    }
    if (vec) {
      constexpr int YV = kChannels * (int)sizeof(T) / 16;
      for (int i = threadIdx.x; i < len * YV; i += blockDim.x) {
        const int r = i / YV, q = i - r * YV;
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(
            y + (row0 + t0 + r) * Din + d0) + 16 * q) =
            *reinterpret_cast<const uint4*>(
                reinterpret_cast<const char*>(&sm.y[r][0]) + 16 * q);
      }
    } else {
      for (int i = threadIdx.x; i < len * kChannels; i += blockDim.x) {
        const int r = i / kChannels, c2 = i - r * kChannels;
        if (d0 + c2 < Din) y[(row0 + t0 + r) * Din + d0 + c2] = sm.y[r][c2];
      }
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      hT[((size_t)b * Din + d) * N + n0 + s] = h[s];
  }
}

template <typename T, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* Dv, const float* h0, void* y,
           float* hT, int Bt, int T_len, int Din, cudaStream_t s) {
  const dim3 grid((Din + kChannels - 1) / kChannels, Bt);
  const size_t smem = sizeof(ScanSmem<T, N>);
  auto kernel = selective_scan_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kChannels * N / states_per_lane<N>(), smem, s>>>(
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
