// Declarations shared by the routing kernels (routing.cu), their
// recompute-b backward (routing_bwd.cu, whose replay and reverse sweep both
// run routing.cu's tile and reduce kernels), the stage-split kernels of the
// sharded path (routing_stage.cu) and the §5.2.2 fast-math kernel
// (fastmath.cu).  Every source compiles into one shared library
// (repro_torch/kernels/cudalib.py::build), so the backward's replay
// launches the forward's own tile and reduce kernels: the replayed b, c, s
// and v are the forward's, bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace routing {

constexpr int kTileThreads = 512;
constexpr int kReduceThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

// ---- §5.2.2 bit-level special functions (repro/core/approx.py) -----------
//
// One definition for the routing kernels' use_approx mode and the
// elementwise fastmath_2d kernel.  Every product and sum is rounded on its
// own (__fmul_rn/__fadd_rn/__fsub_rn), so nvcc's FMA contraction cannot
// change the bits the bitcasts see; the fast-exp int32 cast truncates after
// the clip to [0, 254.999].

constexpr float kLog2e = (float)1.4426950408889634;
constexpr float kExpBiasAvg = (float)(127.0 + (1.0 / 0.6931471805599453 - 1.5));
constexpr float kMant = 8388608.0f;  // 2^23
constexpr float kExpRecovery = (float)1.0000973;
constexpr float kInvSqrtRecovery = (float)1.0008818;
constexpr float kRecipRecovery = (float)1.0013653;

// RECOVER applies the accuracy-recovery multiplier.  The reference's fp32
// multiply (XLA) flushes a subnormal operand to zero, so with RECOVER a
// subnormal bitcast (bits < 2^23) gives 0; without it the bitcast comes back
// unchanged, subnormal and all.
template <bool RECOVER>
__device__ __forceinline__ float fast_exp(float x) {
  float y = __fadd_rn(__fmul_rn(kLog2e, x), kExpBiasAvg);
  y = fminf(fmaxf(y, 0.0f), 254.999f);
  const int bits = __float2int_rz(__fmul_rn(y, kMant));  // y >= 0: trunc == floor
  if (!RECOVER) return __int_as_float(bits);
  if (bits < 0x800000) return 0.0f;
  return __fmul_rn(__int_as_float(bits), kExpRecovery);
}

// bits(1/x) ≈ 0x7EF311C2 − bits(x), then one Newton step y·(2 − x·y); the
// integer subtraction wraps as the reference's int32 arithmetic does
template <bool RECOVER>
__device__ __forceinline__ float fast_recip(float x) {
  float y = __int_as_float(
      (int)(0x7EF311C2u - (unsigned)__float_as_int(x)));
  y = __fmul_rn(y, __fsub_rn(2.0f, __fmul_rn(x, y)));
  return RECOVER ? __fmul_rn(y, kRecipRecovery) : y;
}

// i = 0x5F3759DF − (bits(x) >> 1), then y·(1.5 − ((0.5·x)·y)·y)
template <bool RECOVER>
__device__ __forceinline__ float fast_rsqrt(float x) {
  float y = __int_as_float(
      (int)(0x5F3759DFu - (unsigned)(__float_as_int(x) >> 1)));
  const float t = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, x), y), y);
  y = __fmul_rn(y, __fsub_rn(1.5f, t));
  return RECOVER ? __fmul_rn(y, kInvSqrtRecovery) : y;
}

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

// ---- Eq.3 squash and Eq.5 softmax (kernel.py:_squash_inkernel,
// _softmax_h_inkernel), with the §5.2.2 helpers (recovery on) in approx mode

// Eq.3's factor for a row whose Σ|s|² is n2, applied element by element:
// approx x·f with f = n2'·rsqrt(n2')·1/(1+n2'), n2' = n2 + 1e-9; exact
// (x·q)/r with q = n2/(1+n2), r = sqrt(n2 + 1e-9).
template <bool APPROX>
struct Squash {
  float q, r;
  __device__ __forceinline__ explicit Squash(float n2) {
    if (APPROX) {
      n2 = __fadd_rn(n2, 1e-9f);
      q = __fmul_rn(__fmul_rn(n2, fast_rsqrt<true>(n2)),
                    fast_recip<true>(__fadd_rn(1.0f, n2)));
      r = 1.0f;
    } else {
      q = __fdiv_rn(n2, __fadd_rn(1.0f, n2));
      r = __fsqrt_rn(__fadd_rn(n2, 1e-9f));
    }
  }
  __device__ __forceinline__ float operator()(float x) const {
    return APPROX ? __fmul_rn(x, q) : __fdiv_rn(__fmul_rn(x, q), r);
  }
};

// o[0..C) squashed in place, n2 the sum of o[c]² the caller accumulated
template <bool APPROX>
__device__ __forceinline__ void squash_row(float* o, int C, float n2) {
  const Squash<APPROX> sq(n2);
  for (int c = 0; c < C; ++c) o[c] = sq(o[c]);
}

// row[0..H) = softmax(row) in place, the row max subtracted first
template <bool APPROX>
__device__ __forceinline__ void softmax_row(float* row, int H) {
  float m = row[0];
  for (int h = 1; h < H; ++h) m = fmaxf(m, row[h]);
  float sum = 0.0f;
  for (int h = 0; h < H; ++h) {
    const float e =
        APPROX ? fast_exp<true>(__fsub_rn(row[h], m)) : expf(row[h] - m);
    row[h] = e;
    sum += e;
  }
  if (APPROX) {
    const float r = fast_recip<true>(sum);
    for (int h = 0; h < H; ++h) row[h] = __fmul_rn(row[h], r);
  } else {
    for (int h = 0; h < H; ++h) row[h] = __fdiv_rn(row[h], sum);
  }
}

// One iteration's tile launch (deferred Eq.4, Eq.5 softmax, partial Eq.2)
// and its reduce launch (the partials summed in a fixed order, then the
// squash).  b_in/b_out may alias.  c_out, when set, receives the
// iteration's couplings c (L,H) — the backward's replay snapshots them
// there.  The launch geometry (rows, batch_chunk, cluster, staged, slots)
// comes from kernels/routing/ops.py::tile_geometry: a cell is `rows`
// L-rows of one reference tile by `batch_chunk` batch rows; the `cluster`
// blocks of a cluster take one row group's batch chunks, and the `slots`
// clusters walk the row groups `slots` apart, each adding its groups'
// Eq.2 into its own slice of partial (slots, B, H, C).  gmax (L/rows)
// carries each row group's max|Δb| to the reduce launch, which folds it
// into the tile flags conv (L/l_tile) and the counter cnt.
struct TileArgs {
  const void* u;
  const float* scales;
  const float* v_prev;
  const float* b_in;
  float* b_out;
  float* partial;
  float* gmax;
  int* conv;
  float* c_frozen;
  int* cnt;
  float* c_out;
  int B, L, H, C, l_tile, iteration;
  float eps;
  int rows, batch_chunk, cluster, staged, slots;
  // b and v_prev are zero (iteration 0 of the lazy-update schedule): Eq.4
  // adds nothing, so the launch skips it and reads neither
  int zero_state;
  // set: the backward's reverse sweep on the same cells (c_rev the
  // iteration's couplings c_t, v_prev gs_t, b_in / b_out the running ∂b,
  // c_out its snapshot ∂b_t; fp32 or bf16 û, exact, no early exit)
  const float* c_rev;
};

// stream dtype codes shared with kernel.py: 0 fp32, 1 bf16, 2 int8.
// resolve_slots checks the geometry and lowers a.slots to the clusters the
// card holds at once for this kernel (so every cluster of the grid runs
// together and the partial sums' order is fixed by the launch); call it
// once before a run of launch_tile / launch_reduce with the same a.
cudaError_t resolve_slots(TileArgs& a, int dtype, bool approx,
                          bool early_exit);
cudaError_t launch_tile(const TileArgs& a, int dtype, bool approx,
                        bool early_exit, cudaStream_t stream);

// out[k,h,:] = Σ_slot partial[slot,k,h,:] in slot order, squashed over C
// when `squash`; s_out, when set, also receives the unsquashed sum.  With
// early_exit it also folds gmax into conv and counts the worked tiles.
cudaError_t launch_reduce(const TileArgs& a, float* out, float* s_out,
                          bool squash, bool approx, bool early_exit,
                          cudaStream_t stream);

// The reverse sweep's reduce: the same sum, here ∂v, then gs_out[k,h,:] =
// the exact squash's vjp at s_t[k,h,:] (in approx mode too, as in the
// reference).
cudaError_t launch_reduce_vjp(const TileArgs& a, float* gs_out,
                              const float* s_t, cudaStream_t stream);

}  // namespace routing
