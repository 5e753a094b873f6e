// Declarations shared by the routing kernels (routing.cu) and their
// recompute-b backward (routing_bwd.cu).  Both files compile into one
// shared library (repro_torch/kernels/routing/kernel.py::build), so the
// backward's replay launches the forward's own tile and reduce kernels:
// the replayed b, c, s and v are the forward's, bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace routing {

constexpr int kTileThreads = 512;
constexpr int kReduceThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

// ---- û stream loads: fp32, bf16, or int8 codes times the tile's scale -----

__device__ __forceinline__ float load_u(const float* p, size_t i, float) {
  return __ldg(p + i);
}

__device__ __forceinline__ float load_u(const __nv_bfloat16* p, size_t i,
                                        float) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float load_u(const int8_t* p, size_t i,
                                        float scale) {
  return __fmul_rn((float)p[i], scale);  // kernel.py: u.astype(f32) * scale
}

// One iteration's tile launch (deferred Eq.4, Eq.5 softmax, partial Eq.2).
// b_in/b_out may alias.  c_out, when set, receives the iteration's couplings
// c (L,H) — the backward's replay snapshots them there.
struct TileArgs {
  const void* u;
  const float* scales;
  const float* v_prev;
  const float* b_in;
  float* b_out;
  float* partial;
  int* conv;
  float* c_frozen;
  int* cnt;
  float* c_out;
  int B, L, H, C, l_tile, iteration;
  float eps;
};

// stream dtype codes shared with kernel.py: 0 fp32, 1 bf16, 2 int8
cudaError_t launch_tile(const TileArgs& a, int dtype, bool approx,
                        bool early_exit, cudaStream_t stream);

// out[k,h,:] = Σ_j partial[j,k,h,:] in tile order, squashed over C when
// `squash`; s_out, when set, also receives the unsquashed sum.
cudaError_t launch_reduce(const float* partial, float* out, float* s_out,
                          int n_tiles, int B, int H, int C, bool squash,
                          bool approx, cudaStream_t stream);

}  // namespace routing
