// EM-routing stage kernels for Hopper (sm_90a), compiled into the port's one
// library (repro_torch/kernels/cudalib.py builds every source with nvcc) and
// bound through a plain C interface.
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernels
//   repro/kernels/routing/kernel.py::em_stage_stats (_em_stats_kernel) — the
//     M-step sufficient statistics Σ_l r·a, Σ_l r·a·v and Σ_l r·a·v² in one
//     pass over the votes;
//   repro/kernels/routing/kernel.py::em_stage_estep (_em_estep_kernel) — the
//     E-step responsibilities r = softmax_H(bias − ½·Σ_c (v−μ)²·(1/σ²)).
// kernels/routing/ops.py::em_routing_fused runs the host M-step arithmetic
// between the two, once per iteration.
//
// Both are bound by bytes on this card: each reads the votes once (73.7 MB
// fp32 at Caps-MN1, B=100) and does about 5 (statistics) or 4 (E-step) fp32
// operations per vote element, far below the ~20 FLOP/byte at which fp32
// arithmetic (67 TFLOP/s) would take over from HBM (3.35 TB/s).  The bound
// is the votes plus the small operands over 3.35 TB/s; the measured times
// against it are in PERF.md.
//
// The TPU grid walks the L-tiles in order on one core and accumulates the
// statistics in the resident output block.  EM carries no per-tile state (no
// int8 scale, no early-exit flag), so unlike routing.cu the grid here does
// not follow the reference's L-tiles; it is chosen to fill 132 SMs:
//
//   stats kernel   one block per (batch row b, L-chunk).  kernel.py's
//                  em_stats_chunks cuts L so that B·chunks is near 8 blocks
//                  per SM (11 chunks of 105 rows at Caps-MN1, B=100: 1100
//                  blocks).  Threads run over h·c (160 at Caps-MN1, 992 at
//                  Caps-EN3), so a warp reads consecutive votes of one row;
//                  each thread sums its chunk's rows in order and writes one
//                  slot of a (chunks, B, H, 2C+1) partial buffer.
//   reduce kernel  one thread per output element sums the partials in chunk
//                  order.  The sums are deterministic, with no float atomics,
//                  and the launch boundary is the grid-wide barrier.
//   E-step kernel  each (b, l) row is independent: the softmax is over H,
//                  which EM never shards, so there is no cross-block sum.  A
//                  block takes kEstepElems / (H·C) consecutive rows, one
//                  contiguous range of votes read coalesced; it writes
//                  (v−μ)²·(1/σ²) per element to shared memory, then Σ_c and
//                  the bias per (row, h), then the max-subtracted softmax per
//                  row, and stores its rows of r contiguously.  H = 62
//                  (Caps-EN3) and H = 11 (Caps-CF3) are not powers of two and
//                  a row of r is not 16-byte aligned, so every loop is
//                  masked and every load is scalar.
//
// Arithmetic follows the reference kernels in fp32, each product and sum
// rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn) so that nvcc's FMA
// contraction cannot make it differ from the plain PyTorch version; only the
// order of the sums over L and over C differs.  The softmax uses expf with
// the row max subtracted and IEEE division.  The library is built without
// --use_fast_math: 1/σ² reaches 1e9 on padded lanes (σ² = eps), so the
// logits are large.

#include <cuda_runtime.h>

namespace {

constexpr int kStatsMaxThreads = 1024;
constexpr int kReduceThreads = 256;
constexpr int kEstepThreads = 256;
constexpr int kEstepElems = 4096;  // votes per E-step block: 16 KB of terms
constexpr int kDefaultSmem = 48 * 1024;

// ---- M-step statistics: one block per (b, L-chunk) ------------------------
//
// partial[j, b, h, :] = (Σ rw, Σ rw·v[c] for c < C, Σ rw·v[c]² for c < C)
// over the rows l of chunk j, rw = r[b,l,h]·a_in[b,l].  a_in is read by
// stride (a_sb, a_sl), so a broadcast view (stride 0 along L) needs no copy.

__global__ void __launch_bounds__(kStatsMaxThreads)
em_stats_kernel(const float* __restrict__ votes, const float* __restrict__ r,
                const float* __restrict__ a_in, int a_sb, int a_sl,
                float* __restrict__ partial, int B, int L, int H, int C,
                int chunk_rows) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int HC = H * C;
  const int slot = 2 * C + 1;
  const int l0 = j * chunk_rows;
  const int l1 = min(L, l0 + chunk_rows);
  float* out = partial + ((size_t)j * B + b) * H * slot;
  for (int hc = threadIdx.x; hc < HC; hc += blockDim.x) {
    const int h = hc / C, c = hc - h * C;
    const float* vp = votes + ((size_t)b * L + l0) * HC + hc;
    const float* rp = r + ((size_t)b * L + l0) * H + h;
    const float* ap = a_in + (size_t)b * a_sb + (size_t)l0 * a_sl;
    float s_rw = 0.0f, s_v = 0.0f, s_v2 = 0.0f;
#pragma unroll 4
    for (int l = l0; l < l1; ++l) {
      const float w = __fmul_rn(__ldg(rp), __ldg(ap));
      const float v = __ldg(vp);
      s_rw = __fadd_rn(s_rw, w);
      s_v = __fadd_rn(s_v, __fmul_rn(w, v));
      s_v2 = __fadd_rn(s_v2, __fmul_rn(w, __fmul_rn(v, v)));
      vp += HC;
      rp += H;
      ap += a_sl;
    }
    float* o = out + (size_t)h * slot;
    if (c == 0) o[0] = s_rw;
    o[1 + c] = s_v;
    o[1 + C + c] = s_v2;
  }
}

// ---- the chunk partials summed in chunk order -----------------------------

__global__ void __launch_bounds__(kReduceThreads)
em_stats_reduce_kernel(const float* __restrict__ partial,
                       float* __restrict__ rsum, float* __restrict__ rv,
                       float* __restrict__ rv2, int chunks, int B, int H,
                       int C) {
  const int slot = 2 * C + 1;
  const int n = B * H * slot;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.0f;
  for (int j = 0; j < chunks; ++j)
    s = __fadd_rn(s, partial[(size_t)j * n + idx]);
  const int bh = idx / slot, k = idx - bh * slot;
  if (k == 0) {
    rsum[bh] = s;
  } else if (k <= C) {
    rv[(size_t)bh * C + k - 1] = s;
  } else {
    rv2[(size_t)bh * C + k - 1 - C] = s;
  }
}

// ---- E-step: rows_per_block consecutive (b, l) rows per block -------------

__global__ void __launch_bounds__(kEstepThreads)
em_estep_kernel(const float* __restrict__ votes, const float* __restrict__ mu,
                const float* __restrict__ isig, const float* __restrict__ bias,
                float* __restrict__ r, int n_rows, int L, int H, int C,
                int rows_per_block) {
  extern __shared__ float sm[];  // rows·H·C terms, then rows·H logits
  const int HC = H * C;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n_rows - row0);
  float* term = sm;
  float* logit = sm + (size_t)rows_per_block * HC;

  // (v − μ)²·(1/σ²) for every vote of the block's rows
  const float* vp = votes + (size_t)row0 * HC;
  const int n_el = rows * HC;
  for (int i = threadIdx.x; i < n_el; i += blockDim.x) {
    const int rr = i / HC, hc = i - rr * HC;
    const size_t p = (size_t)((row0 + rr) / L) * HC + hc;
    const float d = __fsub_rn(__ldg(vp + i), __ldg(mu + p));
    term[i] = __fmul_rn(__fmul_rn(d, d), __ldg(isig + p));
  }
  __syncthreads();

  // logit[row, h] = bias[b, h] − ½·Σ_c term
  const int n_lh = rows * H;
  for (int i = threadIdx.x; i < n_lh; i += blockDim.x) {
    const int rr = i / H, h = i - rr * H;
    const float* tp = term + (size_t)rr * HC + (size_t)h * C;
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s = __fadd_rn(s, tp[c]);
    const int b = (row0 + rr) / L;
    logit[i] = __fsub_rn(__ldg(bias + (size_t)b * H + h), __fmul_rn(0.5f, s));
  }
  __syncthreads();

  // softmax over H, one thread per row
  for (int rr = threadIdx.x; rr < rows; rr += blockDim.x) {
    float* row = logit + (size_t)rr * H;
    float m = row[0];
    for (int h = 1; h < H; ++h) m = fmaxf(m, row[h]);
    float sum = 0.0f;
    for (int h = 0; h < H; ++h) {
      const float e = expf(__fsub_rn(row[h], m));
      row[h] = e;
      sum = __fadd_rn(sum, e);
    }
    for (int h = 0; h < H; ++h) row[h] = __fdiv_rn(row[h], sum);
  }
  __syncthreads();

  float* rp = r + (size_t)row0 * H;
  for (int i = threadIdx.x; i < n_lh; i += blockDim.x) rp[i] = logit[i];
}

}  // namespace

extern "C" {

// M-step statistics: rsum (B,H), rv and rv2 (B,H,C) from votes (B,L,H,C),
// r (B,L,H) and a_in read at a_in[b·a_sb + l·a_sl]; partial is
// (chunks, B, H, 2C+1) scratch with chunks = ceil(L / chunk_rows).
int em_stage_stats(const float* votes, const float* r, const float* a_in,
                   int a_sb, int a_sl, float* rsum, float* rv, float* rv2,
                   float* partial, int B, int L, int H, int C, int chunk_rows,
                   int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HC = H * C;
  int threads = ((HC + 31) / 32) * 32;
  if (threads > kStatsMaxThreads) threads = kStatsMaxThreads;
  em_stats_kernel<<<dim3(B, chunks), threads, 0, s>>>(
      votes, r, a_in, a_sb, a_sl, partial, B, L, H, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * H * (2 * C + 1);
  em_stats_reduce_kernel<<<(n + kReduceThreads - 1) / kReduceThreads,
                           kReduceThreads, 0, s>>>(partial, rsum, rv, rv2,
                                                   chunks, B, H, C);
  return (int)cudaGetLastError();
}

// E-step: r (B,L,H) from votes (B,L,H,C), mu and isig (B,H,C), bias (B,H).
int em_stage_estep(const float* votes, const float* mu, const float* isig,
                   const float* bias, float* r, int B, int L, int H, int C,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HC = H * C;
  const int n_rows = B * L;
  int rows_per_block = kEstepElems / HC;
  if (rows_per_block < 1) rows_per_block = 1;
  const size_t smem = (size_t)rows_per_block * (HC + H) * sizeof(float);
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        em_estep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  em_estep_kernel<<<blocks, kEstepThreads, smem, s>>>(
      votes, mu, isig, bias, r, n_rows, L, H, C, rows_per_block);
  return (int)cudaGetLastError();
}

}  // extern "C"
