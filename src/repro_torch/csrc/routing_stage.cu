// Stage-split routing kernels for Hopper (sm_90a): the kernels of sharded
// dynamic routing, compiled into the port's one library
// (repro_torch/kernels/cudalib.py builds every source with nvcc) and bound
// through a plain C interface.
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernels
//   repro/kernels/routing/kernel.py::routing_stage_votes (_stage_votes_kernel)
//     — STAGE 1, Eq.2: s[b,h,:] = Σ_l c[l,h]·û[b,l,h,:];
//   repro/kernels/routing/kernel.py::routing_stage_update
//     (_stage_update_kernel) — STAGE 2, Eq.3 v = squash(s) and Eq.4
//     db[l,h] = Σ_b Σ_c û[b,l,h,c]·v[b,h,c];
//   repro/kernels/routing/kernel.py::routing_stage_update_fold
//     (_stage_update_fold_kernel) — STAGE 2 plus b_new = b + db and the next
//     iteration's couplings c = softmax_H(b_new).
// kernels/routing/ops.py::dynamic_routing_fused_sharded runs them once per
// iteration each, with the collectives of the paper's Table 2 between them
// (psum of s over L's axis, of db over B's axis, the softmax's max and sum
// over H's axis).
//
// All three are bound by bytes on this card: each reads û once (73.7 MB
// fp32 at Caps-MN1, B=100) and does 2 fp32 operations per vote element, far
// below the ~20 FLOP/byte at which fp32 arithmetic (67 TFLOP/s) would take
// over from HBM (3.35 TB/s).  The bound is each input read once and each
// output written once over 3.35 TB/s (about 0.022 ms per stage at
// Caps-MN1); the measured times against it are in PERF.md.
//
// The TPU grid walks the L-tiles in order on one core, the output block
// resident across the steps.  These kernels keep no per-tile state (no int8
// scales, no early-exit flags), so their grids need not follow the
// reference's l_tile (kernel.py keeps it for its error surface) and are sized
// for the card's 132 SMs instead:
//
//   votes kernel    one block per (batch row b, L-chunk); kernel.py's
//                   stage_chunks cuts L so that B·chunks is near 8 blocks
//                   per SM, as em_stage_stats does.  Threads run over h·c,
//                   so a warp reads consecutive votes of one row; each
//                   thread sums its chunk's rows in order into one slot of a
//                   (chunks, B, H, C) partial buffer.
//   reduce kernel   one thread per (b, h, c) sums the partials in chunk
//                   order: deterministic, no float atomics.
//   squash kernel   one thread per (b, h): v = squash(s), written once (the
//                   reference writes v at grid step 0).  v is (B, H, C):
//                   64 KB at Caps-MN1 but 397 KB at Caps-EN3 (H = 62), more
//                   than the 227 KB of shared memory a block may have, so
//                   the update kernel reads v through L1/L2 instead of
//                   staging it.
//   update kernel   one block per run of consecutive l rows (kUpdateElems
//                   votes per batch row).  Each thread owns one (l, h, c)
//                   and sums û·v over b in order; for each b the block reads
//                   one contiguous range of û, coalesced whatever H and C
//                   are.  Then one thread per (l, h) sums its C terms in
//                   order: Σ_c of Σ_b, two short sums in place of one chain
//                   of B·C terms, as routing.cu's Eq.4 does.  Each db
//                   element has one owner, so there is no second reduce.
//                   FOLD: b_new = b + db, and one thread per row runs the
//                   Eq.5 softmax over H — block-local, since a block owns
//                   whole rows with all of H.
//
// Arithmetic follows repro/kernels/routing/kernel.py in fp32: û streams as
// fp32 or bf16 through routing.cuh's load_u, the squash and the softmax are
// routing.cuh's (the §5.2.2 fast helpers in approx mode, exact squash
// dividing by sqrt(|s|² + 1e-9)), and only the order of the sums differs
// from the plain PyTorch versions.

#include "routing.cuh"

namespace {

using routing::kReduceThreads;
using routing::load_u;
using routing::softmax_row;
using routing::squash_row;

constexpr int kVotesMaxThreads = 1024;
constexpr int kUpdateMaxThreads = 1024;
constexpr int kUpdateElems = 512;  // votes per batch row of one update block
constexpr int kDefaultSmem = 48 * 1024;

// ---- STAGE 1: partial Eq.2 sums, one block per (b, L-chunk) ---------------

template <typename T>
__global__ void __launch_bounds__(kVotesMaxThreads)
stage_votes_kernel(const T* __restrict__ u, const float* __restrict__ c,
                   float* __restrict__ partial, int B, int L, int H, int C,
                   int chunk_rows) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int HC = H * C;
  const int l0 = j * chunk_rows;
  const int l1 = min(L, l0 + chunk_rows);
  float* out = partial + ((size_t)j * B + b) * HC;
  for (int hc = threadIdx.x; hc < HC; hc += blockDim.x) {
    const int h = hc / C;
    size_t p = ((size_t)b * L + l0) * HC + hc;
    const float* cp = c + (size_t)l0 * H + h;
    float acc = 0.0f;
#pragma unroll 4
    for (int l = l0; l < l1; ++l) {
      acc = __fadd_rn(acc, __fmul_rn(__ldg(cp), load_u(u, p, 1.0f)));
      p += HC;
      cp += H;
    }
    out[hc] = acc;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
stage_votes_reduce_kernel(const float* __restrict__ partial,
                          float* __restrict__ s, int chunks, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.0f;
  for (int j = 0; j < chunks; ++j)
    acc = __fadd_rn(acc, partial[(size_t)j * n + idx]);
  s[idx] = acc;
}

// ---- STAGE 2, first launch: v = squash(s), one thread per (b, h) ----------

template <bool APPROX>
__global__ void __launch_bounds__(kReduceThreads)
stage_squash_kernel(const float* __restrict__ s, float* __restrict__ v,
                    int BH, int C) {
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= BH) return;
  const float* sp = s + (size_t)bh * C;
  float* o = v + (size_t)bh * C;
  float n2 = 0.0f;
  for (int k = 0; k < C; ++k) {
    const float x = sp[k];
    o[k] = x;
    n2 = __fadd_rn(n2, __fmul_rn(x, x));
  }
  squash_row<APPROX>(o, C, n2);
}

// ---- STAGE 2, second launch: Eq.4 (+ the folded Eq.5) per run of rows ----
//
// FOLD = false: db[l,h] = Σ_c Σ_b û·v.
// FOLD = true:  b_out[l,h] = b[l,h] + db, c_out[l,:] = softmax_H(b_out[l,:]).

template <typename T, bool FOLD, bool APPROX>
__global__ void __launch_bounds__(kUpdateMaxThreads)
stage_update_kernel(const T* __restrict__ u, const float* __restrict__ v,
                    float* __restrict__ db, const float* __restrict__ b,
                    float* __restrict__ b_out, float* __restrict__ c_out,
                    int B, int L, int H, int C, int rows_per_block) {
  extern __shared__ float sm[];  // rows·H·C agreement terms, then rows·H
  const int HC = H * C;
  const int l0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, L - l0);
  float* term = sm;
  float* bn = sm + (size_t)rows_per_block * HC;

  // Σ_b û[b, l0 + i / HC, hc]·v[b, hc] for every vote i of the block's rows
  const int n_el = rows * HC;
  const size_t row_stride = (size_t)L * HC;
  for (int i = threadIdx.x; i < n_el; i += blockDim.x) {
    const int hc = i % HC;
    size_t p = (size_t)l0 * HC + i;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = 0; k < B; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(load_u(u, p, 1.0f),
                                     __ldg(v + (size_t)k * HC + hc)));
      p += row_stride;
    }
    term[i] = acc;
  }
  __syncthreads();

  // Σ_c per (row, h), in order; one owner per db element
  const int n_lh = rows * H;
  for (int i = threadIdx.x; i < n_lh; i += blockDim.x) {
    const float* tp = term + (size_t)i * C;
    float d = 0.0f;
    for (int k = 0; k < C; ++k) d = __fadd_rn(d, tp[k]);
    const size_t gi = (size_t)l0 * H + i;
    if (FOLD) {
      const float x = __fadd_rn(b[gi], d);
      b_out[gi] = x;
      bn[i] = x;
    } else {
      db[gi] = d;
    }
  }
  if (!FOLD) return;
  __syncthreads();

  // the next iteration's Eq.5 couplings, one thread per row
  for (int l = threadIdx.x; l < rows; l += blockDim.x) {
    float* row = bn + (size_t)l * H;
    softmax_row<APPROX>(row, H);
    float* cp = c_out + (size_t)(l0 + l) * H;
    for (int h = 0; h < H; ++h) cp[h] = row[h];
  }
}

// ---- host-side dispatch ----------------------------------------------------

inline int round_threads(int n, int cap) {
  int t = ((n + 31) / 32) * 32;
  return t > cap ? cap : t;
}

template <typename T>
cudaError_t launch_votes(const void* u, const float* c, float* s,
                         float* partial, int B, int L, int H, int C,
                         int chunk_rows, int chunks, cudaStream_t st) {
  const int HC = H * C;
  stage_votes_kernel<T><<<dim3(B, chunks), round_threads(HC, kVotesMaxThreads),
                          0, st>>>(static_cast<const T*>(u), c, partial, B, L,
                                   H, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = B * HC;
  stage_votes_reduce_kernel<<<(n + kReduceThreads - 1) / kReduceThreads,
                              kReduceThreads, 0, st>>>(partial, s, chunks, n);
  return cudaGetLastError();
}

template <typename T, bool FOLD, bool APPROX>
cudaError_t launch_update_t(const void* u, const float* v, float* db,
                            const float* b, float* b_out, float* c_out, int B,
                            int L, int H, int C, cudaStream_t st) {
  const int HC = H * C;
  int rows = kUpdateElems / HC;
  if (rows < 1) rows = 1;
  if (rows > L) rows = L;
  const size_t smem = (size_t)rows * (HC + H) * sizeof(float);
  auto kernel = stage_update_kernel<T, FOLD, APPROX>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (L + rows - 1) / rows;
  kernel<<<blocks, round_threads(rows * HC, kUpdateMaxThreads), smem, st>>>(
      static_cast<const T*>(u), v, db, b, b_out, c_out, B, L, H, C, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_update(const void* u, const float* s, float* v, float* db,
                          const float* b, float* b_out, float* c_out, int B,
                          int L, int H, int C, bool approx, bool fold,
                          cudaStream_t st) {
  const int BH = B * H;
  const int blocks = (BH + kReduceThreads - 1) / kReduceThreads;
  if (approx) {
    stage_squash_kernel<true><<<blocks, kReduceThreads, 0, st>>>(s, v, BH, C);
  } else {
    stage_squash_kernel<false><<<blocks, kReduceThreads, 0, st>>>(s, v, BH, C);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (fold) {
    return approx ? launch_update_t<T, true, true>(u, v, db, b, b_out, c_out,
                                                   B, L, H, C, st)
                  : launch_update_t<T, true, false>(u, v, db, b, b_out, c_out,
                                                    B, L, H, C, st);
  }
  return launch_update_t<T, false, false>(u, v, db, b, b_out, c_out, B, L, H,
                                          C, st);
}

}  // namespace

extern "C" {

// STAGE 1: s (B,H,C) = Σ_l c (L,H) · û (B,L,H,C); û fp32 (dtype 0) or bf16
// (1); partial is (chunks, B, H, C) scratch, chunks = ceil(L / chunk_rows).
int routing_stage_votes(const void* u, int dtype, const float* c, float* s,
                        float* partial, int B, int L, int H, int C,
                        int chunk_rows, int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_votes<float>(u, c, s, partial, B, L, H, C,
                                            chunk_rows, chunks, st);
    case 1: return (int)launch_votes<__nv_bfloat16>(u, c, s, partial, B, L, H,
                                                    C, chunk_rows, chunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// STAGE 2: v (B,H,C) = squash(s), then fold = 0: db (L,H) = Σ_{b,c} û·v;
// fold = 1: b_out = b + that, c_out = softmax_H(b_out) (b, b_out, c_out
// (L,H); db unused).
int routing_stage_update(const void* u, int dtype, const float* s, float* v,
                         float* db, const float* b, float* b_out,
                         float* c_out, int B, int L, int H, int C,
                         int use_approx, int fold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_update<float>(u, s, v, db, b, b_out, c_out, B,
                                             L, H, C, use_approx != 0,
                                             fold != 0, st);
    case 1: return (int)launch_update<__nv_bfloat16>(
        u, s, v, db, b, b_out, c_out, B, L, H, C, use_approx != 0, fold != 0,
        st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
