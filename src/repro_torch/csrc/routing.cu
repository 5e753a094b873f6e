// Dynamic-routing kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface and ctypes (repro_torch/kernels/routing/kernel.py builds
// this file with nvcc and loads it).
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernels
//   repro/kernels/routing/kernel.py::routing_procedure_fused
//     (_routing_procedure_kernel) — the whole routing procedure, T iterations
//     of the lazy-update schedule, fp32/bf16/int8 û streams, early exit;
//   repro/kernels/routing/kernel.py::routing_iteration_fused
//     (_routing_iter_kernel) — one lazy-update iteration, returns (s, b_new).
//
// Both are memory-bound on this card: about 4 FLOP per û element per
// iteration (2 for the Eq.4 agreement, 2 for the Eq.2 vote sum) against
// 4 bytes (fp32), 2 (bf16) or 1 (int8) of û — far below the ~20 FLOP/byte
// at which fp32 arithmetic (67 TFLOP/s) would take over from HBM
// (3.35 TB/s).  The bound is the û bytes per iteration over 3.35 TB/s:
// ops.dma_bytes_per_call(form="procedure") counts them.  The û stream of
// the Table-1 shapes (74 MB fp32 for Caps-MN1 at B=100) does not fit the
// 50 MB L2, so every iteration streams it from HBM again.  Measured times
// against this bound are in PERF.md.
//
// The TPU grid runs its (iteration, L-tile) cells in order on one core and
// carries b, v and s in VMEM scratch across them.  Blocks on the H100 run in
// parallel with no order, so this port splits each iteration in two launches:
//
//   tile kernel    one block per L-tile (the reference's l_tile, so int8
//                  scales and early-exit flags mean the same rows).  The
//                  block owns its b rows in device memory, so Eq.4's
//                  Σ_{k,c} and Eq.5's softmax over H are block-local.  It
//                  reads v_prev and writes its partial Eq.2 vote sum into an
//                  (n_tiles, B, H, C) fp32 buffer.  Under early exit it reads
//                  and writes its tile's converged flag and frozen couplings
//                  and atomically counts its worked tile-iterations.
//   reduce kernel  sums the partials over tiles in a fixed order (so the
//                  result is deterministic) and, for the procedure form,
//                  applies the Eq.3 squash, writing v in place for the next
//                  iteration.  The kernel boundary is the grid-wide barrier.
//
// b, v and s stay on the card for the whole procedure; only v is the output.
// The backward (routing_bwd.cu) replays the forward through these same
// launches (routing.cuh), snapshotting c and s through c_out and s_out.
// Why launches and not a grid barrier inside one kernel: the sums are then
// deterministic (fixed tile order, no float atomics), each launch can be
// held against the plain PyTorch version on its own, and a cooperative
// grid.sync() or a cluster would remove one launch per iteration but not
// the second û pass, which costs far more.
// What this design costs against the bound, recorded for the redesign:
//   * it reads û twice per iteration (one pass for Eq.4, one for Eq.2)
//     where the reference reads it once;
//   * one block per tile gives 6..72 blocks on the Table-1 shapes against
//     132 SMs, so most of the card idles;
//   * partial sums make one (n_tiles, B, H, C) round trip per iteration.
// A persistent cooperative kernel (grid.sync) or clusters with distributed
// shared memory would remove the second launch, and more blocks per tile
// with cp.async/TMA staging would approach the bound; both are later work.
//
// Arithmetic follows repro/kernels/routing/kernel.py: fp32 accumulation, the
// squash and softmax of routing.cuh (shared with routing_stage.cu), the
// §5.2.2 bit-level helpers with __fmul_rn/__fadd_rn/__fsub_rn where the
// reference rounds each product (so nvcc's FMA contraction cannot change the
// bits the bitcasts see), the fast-exp int32 cast truncating after the clip
// to [0, 254.999], and squash epsilons +1e-9 on |s|^2 (approx) and
// sqrt(|s|^2 + 1e-9) (exact).

#include "routing.cuh"

namespace {

using routing::kDefaultSmem;
using routing::kReduceThreads;
using routing::kTileThreads;
using routing::load_u;
using routing::softmax_row;
using routing::squash_row;
using routing::TileArgs;

__device__ __forceinline__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) x = fmaxf(x, red[w]);
  }
  return x;  // valid in thread 0
}

// ---- tile kernel: deferred Eq.4 + Eq.5 softmax + partial Eq.2 -------------
//
// One block per L-tile j (rows row0 .. row0 + l_tile).  u is the lane-packed
// (B, L, H·C) stream.  b_in/b_out may alias (procedure form: b is updated in
// place; every (l, h) element is read and written by the same thread).
// c_out, when set, receives the couplings (the backward's replay snapshot).

template <typename T, bool APPROX, bool EARLY_EXIT>
__global__ void __launch_bounds__(kTileThreads)
routing_tile_kernel(const T* __restrict__ u, const float* __restrict__ scales,
                    const float* __restrict__ v_prev, const float* b_in,
                    float* b_out, float* __restrict__ partial,
                    int* __restrict__ conv, float* __restrict__ c_frozen,
                    int* __restrict__ cnt, float* __restrict__ c_out, int B,
                    int L, int H, int C, int l_tile, int iteration,
                    float eps) {
  extern __shared__ float sc[];  // (l_tile, H): b_new, then the couplings c
  __shared__ float red[kTileThreads / 32];
  const int j = blockIdx.x;
  const int row0 = j * l_tile;
  const int HC = H * C;
  const int n_lh = l_tile * H;
  const float scale = scales != nullptr ? scales[j] : 1.0f;
  const bool active = !EARLY_EXIT || conv[j] == 0;  // uniform in the block

  if (active) {
    // deferred Eq.4: db[l,h] = Σ_{k,c} û[k,l,h,c] · v_prev[k,h,c]
    float dmax = 0.0f;
    for (int idx = threadIdx.x; idx < n_lh; idx += blockDim.x) {
      const int l = idx / H, h = idx - l * H;
      // Σ_c per batch row first, then Σ_k: two short sums in place of one
      // chain of B·C terms, which keeps the rounding error near torch's
      float db = 0.0f;
      for (int k = 0; k < B; ++k) {
        const size_t base = ((size_t)k * L + row0 + l) * HC + (size_t)h * C;
        const float* vp = v_prev + ((size_t)k * H + h) * C;
        float t = 0.0f;
#pragma unroll 8
        for (int c = 0; c < C; ++c) t += load_u(u, base + c, scale) * __ldg(vp + c);
        db += t;
      }
      const size_t bi = (size_t)(row0 + l) * H + h;
      const float bn = b_in[bi] + db;
      b_out[bi] = bn;
      sc[idx] = bn;
      if (EARLY_EXIT) dmax = fmaxf(dmax, fabsf(db));
    }
    __syncthreads();
    // Eq.5: c = softmax_H(b_new), one thread per row
    for (int l = threadIdx.x; l < l_tile; l += blockDim.x) {
      float* row = sc + l * H;
      softmax_row<APPROX>(row, H);
      if (EARLY_EXIT) {
        for (int h = 0; h < H; ++h) c_frozen[(size_t)(row0 + l) * H + h] = row[h];
      }
      if (c_out != nullptr) {
        for (int h = 0; h < H; ++h) c_out[(size_t)(row0 + l) * H + h] = row[h];
      }
    }
    if (EARLY_EXIT) {
      // ‖Δb‖∞ < ε freezes the tile from the next iteration on; iteration 0
      // (v_prev = 0, so Δb ≡ 0) is exempt, and ε = 0 never freezes.
      const float delta = block_max(dmax, red);
      if (threadIdx.x == 0) {
        if (iteration > 0 && delta < eps) conv[j] = 1;
        atomicAdd(cnt, 1);
      }
    }
  } else {
    // converged tile: Eq.2 reads the couplings frozen at its last worked
    // iteration
    for (int idx = threadIdx.x; idx < n_lh; idx += blockDim.x)
      sc[idx] = c_frozen[(size_t)row0 * H + idx];
  }
  __syncthreads();

  // partial Eq.2: s_j[k,h,c] = Σ_{l in tile} c[l,h] · û[k,l,h,c]
  const int n_out = B * HC;
  for (int idx = threadIdx.x; idx < n_out; idx += blockDim.x) {
    const int k = idx / HC, hc = idx - k * HC, h = hc / C;
    const size_t base = ((size_t)k * L + row0) * HC + hc;
    float acc = 0.0f;
#pragma unroll 8
    for (int l = 0; l < l_tile; ++l)
      acc += sc[l * H + h] * load_u(u, base + (size_t)l * HC, scale);
    partial[(size_t)j * n_out + idx] = acc;
  }
}

// ---- reduce kernel: Σ over tiles in order, then Eq.3 squash ---------------
//
// One thread per (k, h): out[k,h,:] = Σ_j partial[j,k,h,:], squashed over C
// when SQUASH (procedure form; the iteration form returns s unsquashed).
// s_out, when set, also receives the unsquashed sum (the backward's replay
// snapshot of s_t).

template <bool SQUASH, bool APPROX>
__global__ void __launch_bounds__(kReduceThreads)
routing_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                      float* __restrict__ s_out, int n_tiles, int B, int H,
                      int C) {
  const int kh = blockIdx.x * blockDim.x + threadIdx.x;
  if (kh >= B * H) return;
  const size_t stride = (size_t)B * H * C;
  const float* p = partial + (size_t)kh * C;
  float* o = out + (size_t)kh * C;
  float n2 = 0.0f;
  for (int c = 0; c < C; ++c) {
    float s = 0.0f;
    for (int j = 0; j < n_tiles; ++j) s += p[(size_t)j * stride + c];
    o[c] = s;
    if (s_out != nullptr) s_out[(size_t)kh * C + c] = s;
    n2 += s * s;
  }
  if (SQUASH) squash_row<APPROX>(o, C, n2);
}

// ---- host-side dispatch ----------------------------------------------------

template <typename T, bool APPROX, bool EARLY_EXIT>
cudaError_t launch_tile_t(const TileArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.l_tile * a.H * sizeof(float);
  auto kernel = routing_tile_kernel<T, APPROX, EARLY_EXIT>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.L / a.l_tile, kTileThreads, smem, stream>>>(
      static_cast<const T*>(a.u), a.scales, a.v_prev, a.b_in, a.b_out,
      a.partial, a.conv, a.c_frozen, a.cnt, a.c_out, a.B, a.L, a.H, a.C,
      a.l_tile, a.iteration, a.eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile_dtype(const TileArgs& a, bool approx, bool early_exit,
                              cudaStream_t stream) {
  if (approx) {
    return early_exit ? launch_tile_t<T, true, true>(a, stream)
                      : launch_tile_t<T, true, false>(a, stream);
  }
  return early_exit ? launch_tile_t<T, false, true>(a, stream)
                    : launch_tile_t<T, false, false>(a, stream);
}

}  // namespace

namespace routing {

cudaError_t launch_tile(const TileArgs& a, int dtype, bool approx,
                        bool early_exit, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_tile_dtype<float>(a, approx, early_exit, stream);
    case 1: return launch_tile_dtype<__nv_bfloat16>(a, approx, early_exit, stream);
    case 2: return launch_tile_dtype<int8_t>(a, approx, early_exit, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_reduce(const float* partial, float* out, float* s_out,
                          int n_tiles, int B, int H, int C, bool squash,
                          bool approx, cudaStream_t stream) {
  const int blocks = (B * H + kReduceThreads - 1) / kReduceThreads;
  if (!squash) {
    routing_reduce_kernel<false, false><<<blocks, kReduceThreads, 0, stream>>>(
        partial, out, s_out, n_tiles, B, H, C);
  } else if (approx) {
    routing_reduce_kernel<true, true><<<blocks, kReduceThreads, 0, stream>>>(
        partial, out, s_out, n_tiles, B, H, C);
  } else {
    routing_reduce_kernel<true, false><<<blocks, kReduceThreads, 0, stream>>>(
        partial, out, s_out, n_tiles, B, H, C);
  }
  return cudaGetLastError();
}

}  // namespace routing

extern "C" {

// The whole procedure: `iterations` × (tile, reduce+squash) on one stream.
// v (B,H,C) and b (L,H) must be zero on entry (iteration 0 of the
// lazy-update schedule starts from b = 0, v_prev = 0); v holds the result.
// Early exit: conv (n_tiles) and cnt (1) zero on entry, c_frozen (L,H)
// scratch.  Returns cudaGetLastError() of the last launch that failed, or 0.
int routing_procedure(const void* u, int dtype, const float* scales,
                      float* v, float* b, float* partial, int* conv,
                      float* c_frozen, int* cnt, int B, int L, int H, int C,
                      int l_tile, int iterations, int use_approx,
                      int early_exit, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  routing::TileArgs a{u, scales, v, b, b, partial, conv, c_frozen, cnt,
                      nullptr, B, L, H, C, l_tile, 0, eps};
  for (int it = 0; it < iterations; ++it) {
    a.iteration = it;
    cudaError_t err = routing::launch_tile(a, dtype, use_approx != 0,
                                           early_exit != 0, s);
    if (err != cudaSuccess) return (int)err;
    err = routing::launch_reduce(partial, v, nullptr, L / l_tile, B, H, C,
                                 true, use_approx != 0, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// One lazy-update iteration: s (B,H,C) = Eq.2 sum, b_out (L,H) = b_in + Eq.4.
int routing_iteration(const void* u, int dtype, const float* b_in,
                      const float* v_prev, float* s, float* b_out,
                      float* partial, int B, int L, int H, int C, int l_tile,
                      int use_approx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  routing::TileArgs a{u, nullptr, v_prev, b_in, b_out, partial, nullptr,
                      nullptr, nullptr, nullptr, B, L, H, C, l_tile, 0, 0.0f};
  cudaError_t err = routing::launch_tile(a, dtype, use_approx != 0, false, st);
  if (err != cudaSuccess) return (int)err;
  return (int)routing::launch_reduce(partial, s, nullptr, L / l_tile, B, H, C,
                                     false, false, st);
}

const char* routing_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
