// Recompute-b backward of the whole routing procedure for Hopper (sm_90a),
// compiled into the same library as routing.cu (kernel.py::build) and bound
// through the same plain C interface.
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernel
//   repro/kernels/routing/kernel.py::routing_procedure_bwd
//     (_routing_procedure_bwd_kernel) — (û (B,L,H,C), ∂v (B,H,C)) -> ∂û at
//     û's stream dtype (fp32 or bf16), fp32 accumulation, written once.
//
// The forward saved only û.  The backward first replays the forward and
// snapshots the small per-iteration state — c_t (T,L,H), s_t (T,B,H,C) and
// v_{t-1} (T,B,H,C) — then walks the iterations in reverse, carrying ∂v and
// the accumulated logit cotangent ∂b (kernel.py:405-419 in the reference):
//
//   gs   = squash_vjp(s_t, gv)             exact squash, even in approx mode
//   gc   = Σ_{k,c} û·gs                    (L,H)
//   gb  += c_t ⊙ (gc − Σ_H c_t·gc)         Eq.5 softmax vjp, snapshot gb_t
//   gv   = Σ_l gb·û                        carried to iteration t-1
//   ∂û   = Σ_t c_t⊗gs_t + Σ_{t≥1} gb_t⊗v_{t-1}   (the t=0 Eq.4 term vanishes)
//
// At t = 0 neither gb_0 nor the carry is needed, so the reverse sweep runs
// its tile launch for t = T-1 … 1 only.  Launches (4T for T iterations):
//
//   replay   T × (forward tile kernel + forward reduce kernel): the launches
//            of routing.cu at the forward's own geometry (clusters over B,
//            û staged once an iteration), with c_t and s_t snapshotted
//            through their c_out / s_out pointers, and v_t written straight
//            into the v_{t-1} snapshot slot of iteration t+1;
//   reverse  one reduce that turns ∂v into gs_{T-1}, then per t = T-1 … 1 a
//            reverse tile kernel (one block per L-tile: gc, the softmax vjp
//            into gb and a partial Σ_l gb·û over its rows) and a reverse
//            reduce (the partials summed in tile order, then squash_vjp of
//            s_{t-1} gives gs_{t-1});
//   ∂û       one elementwise kernel over (B,L,H,C) sums the snapshot terms.
//
// Every sum runs in a fixed order with no float atomics, so ∂û is bitwise
// deterministic.  All snapshots live in device memory (a few hundred KB at
// Caps-MN1), allocated by the wrapper.
//
// Bound: the function reads û (and ∂v) once and writes ∂û once, so the
// least it could move is 2·|û| bytes — 0.044 ms at Caps-MN1 fp32, B=100,
// over 3.35 TB/s; the arithmetic (about 4T FLOP per û element) is far below
// the fp32 rate.  The reference's stream model counts 2T û passes plus ∂û
// (ops.dma_bytes_per_call(backward=True)).  The replay reads û once per
// iteration across the whole card (routing.cu); the reverse tile kernel
// still reads it twice per launch, 2(T-1) passes, with one block per
// reference L-tile (24 at Caps-MN1 fp32), which leaves most of the card
// idle: its redesign is recorded in PERF.md.
//
// The squash vjp is written out: v = s·f(n2) with n2 = |s|², so
// ∂s = f·∂v + 2·f'(n2)·<s,∂v>·s, f = n2 / ((1+n2)·sqrt(n2+1e-9)) and
// f' = a·r·(a − n2·r²/2) with a = 1/(1+n2), r = 1/sqrt(n2+1e-9): finite at
// s = 0, where f = 0, so zero (padding) lanes get exactly zero gradient.

#include "routing.cuh"

namespace {

using routing::kDefaultSmem;
using routing::kReduceThreads;
using routing::kTileThreads;
using routing::load_u;

__device__ __forceinline__ void store_du(float* p, size_t i, float x) {
  p[i] = x;
}

__device__ __forceinline__ void store_du(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);  // round to nearest even, as Tensor.to
}

// ---- reverse tile kernel: gc, softmax vjp into gb, partial ∂v carry -------
//
// One block per L-tile j.  gs (B,H,C) is gs_t, c_t (L,H) the replayed
// couplings of iteration t, gb (L,H) the running ∂b (updated in place; every
// (l, h) element is read and written by the same thread), gb_snap the
// iteration's snapshot slot.

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
reverse_tile_kernel(const T* __restrict__ u, const float* __restrict__ gs,
                    const float* __restrict__ c_t, float* __restrict__ gb,
                    float* __restrict__ gb_snap, float* __restrict__ partial,
                    int B, int L, int H, int C, int l_tile) {
  extern __shared__ float sg[];  // (l_tile, H): gc, then the new gb rows
  const int j = blockIdx.x;
  const int row0 = j * l_tile;
  const int HC = H * C;
  const int n_lh = l_tile * H;

  // gc[l,h] = Σ_{k,c} û[k,l,h,c] · gs[k,h,c]: Σ_c per batch row first, then
  // Σ_k, as the forward's Eq.4 pass sums
  for (int idx = threadIdx.x; idx < n_lh; idx += blockDim.x) {
    const int l = idx / H, h = idx - l * H;
    float gc = 0.0f;
    for (int k = 0; k < B; ++k) {
      const size_t base = ((size_t)k * L + row0 + l) * HC + (size_t)h * C;
      const float* gp = gs + ((size_t)k * H + h) * C;
      float t = 0.0f;
#pragma unroll 8
      for (int c = 0; c < C; ++c) t += load_u(u, base + c, 1.0f) * __ldg(gp + c);
      gc += t;
    }
    sg[idx] = gc;
  }
  __syncthreads();
  // Eq.5 softmax vjp folded into the running ∂b, one thread per row
  for (int l = threadIdx.x; l < l_tile; l += blockDim.x) {
    float* row = sg + l * H;
    const size_t r0 = (size_t)(row0 + l) * H;
    float dot = 0.0f;
    for (int h = 0; h < H; ++h) dot += c_t[r0 + h] * row[h];
    for (int h = 0; h < H; ++h) {
      const float g = gb[r0 + h] + c_t[r0 + h] * (row[h] - dot);
      gb[r0 + h] = g;
      gb_snap[r0 + h] = g;
      row[h] = g;
    }
  }
  __syncthreads();

  // partial ∂v carry: partial[j,k,h,c] = Σ_{l in tile} gb[l,h] · û[k,l,h,c]
  const int n_out = B * HC;
  for (int idx = threadIdx.x; idx < n_out; idx += blockDim.x) {
    const int k = idx / HC, hc = idx - k * HC, h = hc / C;
    const size_t base = ((size_t)k * L + row0) * HC + hc;
    float acc = 0.0f;
#pragma unroll 8
    for (int l = 0; l < l_tile; ++l)
      acc += sg[l * H + h] * load_u(u, base + (size_t)l * HC, 1.0f);
    partial[(size_t)j * n_out + idx] = acc;
  }
}

// ---- reverse reduce kernel: ∂v in tile order, then the exact squash vjp ---
//
// One thread per (k, h).  ∂v is g (the incoming cotangent, first reverse
// step) or Σ_j partial[j,k,h,:]; gs_out[k,h,:] = squash_vjp(s_t[k,h,:], ∂v).

__global__ void __launch_bounds__(kReduceThreads)
reverse_reduce_kernel(const float* __restrict__ partial,
                      const float* __restrict__ g, int n_tiles,
                      const float* __restrict__ s_t, float* __restrict__ gs_out,
                      int B, int H, int C) {
  const int kh = blockIdx.x * blockDim.x + threadIdx.x;
  if (kh >= B * H) return;
  const size_t stride = (size_t)B * H * C;
  const float* s = s_t + (size_t)kh * C;
  float* o = gs_out + (size_t)kh * C;
  float n2 = 0.0f, dot = 0.0f;
  for (int c = 0; c < C; ++c) {
    float gv;
    if (g != nullptr) {
      gv = g[(size_t)kh * C + c];
    } else {
      gv = 0.0f;
      for (int j = 0; j < n_tiles; ++j) gv += partial[(size_t)j * stride + (size_t)kh * C + c];
    }
    o[c] = gv;
    n2 += s[c] * s[c];
    dot += s[c] * gv;
  }
  const float a = 1.0f / (1.0f + n2);
  const float r = 1.0f / sqrtf(n2 + 1e-9f);
  const float f = n2 * a * r;
  const float fp = a * r * (a - 0.5f * n2 * r * r);
  for (int c = 0; c < C; ++c) o[c] = f * o[c] + 2.0f * fp * dot * s[c];
}

// ---- ∂û: the snapshot terms summed per element -----------------------------
//
// ∂û[k,l,h,c] = c_0[l,h]·gs_0[k,h,c]
//             + Σ_{t≥1} (c_t[l,h]·gs_t[k,h,c] + gb_t[l,h]·v_{t-1}[k,h,c]),
// each product and sum rounded on its own (as the plain version's tensor
// operations round), written once at û's dtype.

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
du_kernel(T* __restrict__ du, const float* __restrict__ c_all,
          const float* __restrict__ gs_all, const float* __restrict__ gb_all,
          const float* __restrict__ vp_all, int B, int L, int H, int C,
          int iterations) {
  const size_t n = (size_t)B * L * H * C;
  const size_t LH = (size_t)L * H, BHC = (size_t)B * H * C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    size_t rest = i / C;
    const int h = (int)(rest % H);
    rest /= H;
    const int l = (int)(rest % L);
    const int k = (int)(rest / L);
    const size_t lh = (size_t)l * H + h;
    const size_t khc = ((size_t)k * H + h) * C + c;
    float acc = __fmul_rn(c_all[lh], gs_all[khc]);
    for (int t = 1; t < iterations; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(c_all[t * LH + lh], gs_all[t * BHC + khc]));
      acc = __fadd_rn(acc, __fmul_rn(gb_all[t * LH + lh], vp_all[t * BHC + khc]));
    }
    store_du(du, i, acc);
  }
}

// ---- host-side dispatch ----------------------------------------------------

template <typename T>
cudaError_t launch_reverse_tile(const void* u, const float* gs,
                                const float* c_t, float* gb, float* gb_snap,
                                float* partial, int B, int L, int H, int C,
                                int l_tile, cudaStream_t stream) {
  const size_t smem = (size_t)l_tile * H * sizeof(float);
  auto kernel = reverse_tile_kernel<T>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<L / l_tile, kTileThreads, smem, stream>>>(
      static_cast<const T*>(u), gs, c_t, gb, gb_snap, partial, B, L, H, C,
      l_tile);
  return cudaGetLastError();
}

cudaError_t launch_reverse_reduce(const float* partial, const float* g,
                                  int n_tiles, const float* s_t, float* gs_out,
                                  int B, int H, int C, cudaStream_t stream) {
  const int blocks = (B * H + kReduceThreads - 1) / kReduceThreads;
  reverse_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(
      partial, g, n_tiles, s_t, gs_out, B, H, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_du(void* du, const float* c_all, const float* gs_all,
                      const float* gb_all, const float* vp_all, int B, int L,
                      int H, int C, int iterations, cudaStream_t stream) {
  const size_t n = (size_t)B * L * H * C;
  size_t blocks = (n + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  du_kernel<T><<<(unsigned)blocks, kReduceThreads, 0, stream>>>(
      static_cast<T*>(du), c_all, gs_all, gb_all, vp_all, B, L, H, C,
      iterations);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ∂û (B,L,H,C) at û's dtype (0 fp32, 1 bf16) from û and ∂v = g (B,H,C).
// Scratch, all fp32 and allocated by the caller: b (L,H) (the replay
// starts from b = 0 without reading it), gb (L,H) zero on entry; partial
// (max(slots, L/l_tile),B,H,C), shared by the replay (one slice per slot of
// the forward's geometry, ops.tile_geometry) and the reverse sweep (one per
// L-tile); snapshots c_all, gb_all (T,L,H) and s_all, vp_all, gs_all
// (T,B,H,C), of which vp_all[0] (v_{-1} = 0) is never read.  Returns the
// CUDA error of the first launch that failed, or 0.
int routing_procedure_backward(const void* u, int dtype, const float* g,
                               void* du, float* b, float* gb, float* partial,
                               float* c_all, float* gb_all, float* s_all,
                               float* vp_all, float* gs_all, int B, int L,
                               int H, int C, int l_tile, int rows,
                               int batch_chunk, int cluster, int staged,
                               int slots, int iterations, int use_approx,
                               void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = L / l_tile;
  const size_t LH = (size_t)L * H, BHC = (size_t)B * H * C;
  const bool approx = use_approx != 0;
  const int T = iterations;
  cudaError_t err;

  // replay: the forward's own launches, snapshotting c_t, s_t and v_t
  routing::TileArgs a{u, nullptr, vp_all, b, b, partial, nullptr, nullptr,
                      nullptr, nullptr, nullptr, B, L, H, C, l_tile, 0, 0.0f,
                      rows, batch_chunk, cluster, staged, slots};
  err = routing::resolve_slots(a, dtype, approx, false);
  if (err != cudaSuccess) return (int)err;
  for (int t = 0; t < T; ++t) {
    a.v_prev = vp_all + t * BHC;
    a.c_out = c_all + t * LH;
    a.iteration = t;
    a.zero_state = t == 0;
    err = routing::launch_tile(a, dtype, approx, false, st);
    if (err != cudaSuccess) return (int)err;
    if (t + 1 < T) {
      err = routing::launch_reduce(a, vp_all + (t + 1) * BHC,
                                   s_all + t * BHC, true, approx, false, st);
    } else {  // the last v is the forward's output: only s_{T-1} is needed
      err = routing::launch_reduce(a, s_all + t * BHC, nullptr, false, false,
                                   false, st);
    }
    if (err != cudaSuccess) return (int)err;
  }

  // reverse: seed with the incoming cotangent, then t = T-1 … 1
  err = launch_reverse_reduce(nullptr, g, 0, s_all + (T - 1) * BHC,
                              gs_all + (T - 1) * BHC, B, H, C, st);
  if (err != cudaSuccess) return (int)err;
  for (int t = T - 1; t >= 1; --t) {
    err = dtype == 0
        ? launch_reverse_tile<float>(u, gs_all + t * BHC, c_all + t * LH, gb,
                                     gb_all + t * LH, partial, B, L, H, C,
                                     l_tile, st)
        : launch_reverse_tile<__nv_bfloat16>(u, gs_all + t * BHC,
                                             c_all + t * LH, gb,
                                             gb_all + t * LH, partial, B, L,
                                             H, C, l_tile, st);
    if (err != cudaSuccess) return (int)err;
    err = launch_reverse_reduce(partial, nullptr, n, s_all + (t - 1) * BHC,
                                gs_all + (t - 1) * BHC, B, H, C, st);
    if (err != cudaSuccess) return (int)err;
  }

  // ∂û from the snapshots, written once
  err = dtype == 0
      ? launch_du<float>(du, c_all, gs_all, gb_all, vp_all, B, L, H, C, T, st)
      : launch_du<__nv_bfloat16>(du, c_all, gs_all, gb_all, vp_all, B, L, H,
                                 C, T, st);
  return (int)err;
}

}  // extern "C"
