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
//                  which EM never shards, so there is no cross-block sum and
//                  no block-wide phase.  A lane owns one (row, h) — where H
//                  > 32 (Caps-EN3, H = 62) one h of each 32 — and a warp
//                  takes a pass of R = 32 / H consecutive rows at once (one
//                  row where H > 32), so its lanes read one contiguous range
//                  of votes and write one contiguous range of r.  Warp w of
//                  a persistent grid (two 256-thread blocks an SM) takes the
//                  passes [w·P/W, (w+1)·P/W) of the P = ceil(B·L / R): the
//                  rows split evenly, a batch row after another.  Where C
//                  divides into fours (every Table-1 shape: C = 16) and the
//                  operands are 16-byte aligned, a lane reads its C votes
//                  as 16-byte loads, four passes of them in flight, and
//                  keeps μ[b,h,:], 1/σ²[b,h,:] and bias[b,h] in registers,
//                  reloading them when its batch row changes; otherwise it
//                  reads element by element (the scalar path, L1 merging
//                  the lanes' neighbouring reads).  Σ_c runs in c order in
//                  the lane; the row's lanes take the max and the sum over
//                  H by shuffles in a fixed tree.  Every thread works in
//                  every step, so the bytes, not the instructions, set the
//                  time; rows staged into shared memory by bulk copies ran
//                  no faster (scripts/estep_variants.py, PERF.md).  The
//                  launch geometry is kernels/routing/ops.py::estep_geometry.
//   wide E-step    H > 256 (more than 8 h a lane): a separate kernel, so
//                  the one above keeps its code.  A warp keeps a row and
//                  walks H in h-passes of 256 (8 h a lane), μ and 1/σ²
//                  read with the votes (16-byte loads where C allows).
//                  Each pass writes its logits to r and folds them into
//                  the row's running max M and running sum S of exp(lg−M)
//                  (an online softmax: S is rescaled by exp(M_old − M_new)
//                  when the max rises); a second sweep over the row, by
//                  the same lanes, turns r into exp(lg − M)/S with the
//                  final M, the plain version's formula.  Only the warp
//                  that owns a row reads or writes it, so writing r twice
//                  races no other warp.
//
// Arithmetic follows the reference kernels in fp32, each product and sum
// rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn) so that nvcc's FMA
// contraction cannot make it differ from the plain PyTorch version; only the
// order of the sums over L, C and H differs.  The softmax uses expf with
// the row max subtracted and IEEE division.  The library is built without
// --use_fast_math: 1/σ² reaches 1e9 on padded lanes (σ² = eps), so the
// logits are large.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStatsMaxThreads = 1024;
constexpr int kReduceThreads = 256;
constexpr int kEstepThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// ---- E-step: a lane a (row, h), a warp a pass of consecutive rows --------
//
// rows_per_pass (R), h_per_lane (NH), vector, passes and warps come from
// ops.py::estep_geometry; the entry point checks them against the shape.

struct EstepArgs {
  const float* votes;
  const float* mu;
  const float* isig;
  const float* bias;
  float* r;
  int B, L, H, C;
  int rows_per_pass, passes, warps;
  int h_passes;  // the wide kernel's passes of 256 h over a row
};

// max and sum over the H lanes h = 0..H-1 of a row group (NH == 1): a tree
// of shuffles down by P2/2, P2/4, …, 1 (P2 the power of two ≥ H), a lane
// taking its partner's value only where the partner is in its group; the
// group's lane 0 holds the result, then every lane of the group gets it.
// Every lane of the warp runs the shuffles; the tree is fixed, so two
// calls agree bitwise.
template <bool MAX>
__device__ __forceinline__ float group_reduce(float x, int h, int H, int p2,
                                              int base) {
  for (int off = p2 >> 1; off > 0; off >>= 1) {
    const float y = __shfl_down_sync(kFull, x, off);
    if (h + off < H) x = MAX ? fmaxf(x, y) : __fadd_rn(x, y);
  }
  return __shfl_sync(kFull, x, base);
}

// the same over all 32 lanes (NH > 1: a row is the whole warp), an
// xor butterfly: every lane gets the same bits
template <bool MAX>
__device__ __forceinline__ float warp_reduce(float x) {
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(kFull, x, o);
    x = MAX ? fmaxf(x, y) : __fadd_rn(x, y);
  }
  return x;
}

// C4 > 0: C = 4·C4 votes a (row, h) as C4 16-byte loads, U passes in
// flight, μ and 1/σ² in registers; C4 == 0: the scalar path, any C.
template <int NH, int C4>
__global__ void __launch_bounds__(kEstepThreads, 2)
em_estep_kernel(const EstepArgs a) {
  constexpr int CA = C4 > 0 ? C4 : 1;
  constexpr int U = (C4 > 0 && NH == 1) ? 4 : 1;  // passes in flight
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (kEstepThreads / 32) + (threadIdx.x >> 5);
  if (w >= a.warps) return;  // whole warps only: the shuffles stay full
  const int H = a.H, C = a.C, HC = H * C, L = a.L;
  const long long n_rows = (long long)a.B * L;
  // NH == 1: lane = sub·H + h; NH > 1: the lane's h are lane + 32·j
  const int sub = NH == 1 ? lane / H : 0;
  const int h0 = NH == 1 ? lane - sub * H : lane;
  const bool lane_on = NH == 1 ? sub < a.rows_per_pass : true;
  int p2 = 1;
  while (p2 < H) p2 <<= 1;
  const int p0 = (int)((long long)w * a.passes / a.warps);
  const int p1 = (int)((long long)(w + 1) * a.passes / a.warps);

  int cur_b = -1;
  float4 m4[NH][CA], s4[NH][CA];  // the vector path's μ and 1/σ² rows
  float bias_h[NH];
  for (int pp = p0; pp < p1; pp += U) {
    float4 x[U][NH][CA];
    if constexpr (C4 > 0) {  // every pass's loads issued before any use
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long row = (long long)(pp + u) * a.rows_per_pass + sub;
        const bool ok = pp + u < p1 && lane_on && row < n_rows;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int h = h0 + 32 * j;
          const bool on = ok && h < H;
          const float4* src = reinterpret_cast<const float4*>(
              a.votes + (size_t)row * HC + (size_t)h * C);
#pragma unroll
          for (int q = 0; q < CA; ++q)
            x[u][j][q] = on ? __ldg(src + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = (long long)(pp + u) * a.rows_per_pass + sub;
      const bool ok = pp + u < p1 && lane_on && row < n_rows;
      const int b = ok ? (int)row / L : cur_b;  // B·L < 2^31: 32-bit
      if (b != cur_b) {  // a new batch row: its μ, 1/σ² and bias
        cur_b = b;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          const int h = h0 + 32 * j;
          if (h >= H) continue;
          const size_t bh = (size_t)b * H + h;
          bias_h[j] = __ldg(a.bias + bh);
          if constexpr (C4 > 0) {
            const float4* mp = reinterpret_cast<const float4*>(a.mu + bh * C);
            const float4* ip = reinterpret_cast<const float4*>(a.isig + bh * C);
#pragma unroll
            for (int q = 0; q < CA; ++q) {
              m4[j][q] = __ldg(mp + q);
              s4[j][q] = __ldg(ip + q);
            }
          }
        }
      }
      // logit = bias − ½·Σ_c (v − μ)²·(1/σ²), Σ_c in c order
      float lg[NH];
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int h = h0 + 32 * j;
        lg[j] = -__int_as_float(0x7f800000);  // -inf: no h here
        if (!ok || h >= H) continue;
        float s = 0.0f;
        if constexpr (C4 > 0) {
#pragma unroll
          for (int q = 0; q < CA; ++q) {
            const float v[4] = {x[u][j][q].x, x[u][j][q].y, x[u][j][q].z,
                                x[u][j][q].w};
            const float m[4] = {m4[j][q].x, m4[j][q].y, m4[j][q].z,
                                m4[j][q].w};
            const float is[4] = {s4[j][q].x, s4[j][q].y, s4[j][q].z,
                                 s4[j][q].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float d = __fsub_rn(v[e], m[e]);
              s = __fadd_rn(s, __fmul_rn(__fmul_rn(d, d), is[e]));
            }
          }
        } else {
          const float* vp = a.votes + (size_t)row * HC + (size_t)h * C;
          const size_t pb = ((size_t)b * H + h) * C;
          for (int c = 0; c < C; ++c) {
            const float d = __fsub_rn(__ldg(vp + c), __ldg(a.mu + pb + c));
            s = __fadd_rn(s, __fmul_rn(__fmul_rn(d, d), __ldg(a.isig + pb + c)));
          }
        }
        lg[j] = __fsub_rn(bias_h[j], __fmul_rn(0.5f, s));
      }
      // softmax over the row's H lanes: max, expf, sum, IEEE division
      float m = lg[0];
#pragma unroll
      for (int j = 1; j < NH; ++j) m = fmaxf(m, lg[j]);
      m = NH == 1 ? group_reduce<true>(m, h0, H, p2, sub * H)
                  : warp_reduce<true>(m);
      float e[NH], sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const bool on = ok && h0 + 32 * j < H;
        e[j] = on ? expf(__fsub_rn(lg[j], m)) : 0.0f;
        sum = __fadd_rn(sum, e[j]);
      }
      sum = NH == 1 ? group_reduce<false>(sum, h0, H, p2, sub * H)
                    : warp_reduce<false>(sum);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int h = h0 + 32 * j;
        if (ok && h < H) a.r[(size_t)row * H + h] = __fdiv_rn(e[j], sum);
      }
    }
  }
}

// ---- wide E-step: H > 256, a warp a row, H in passes of 256 --------------
//
// Rows split over the warps as above with rows_per_pass = 1.  The pass
// hp holds h = 256·hp + 32·j + lane for j < 8.  C4 > 0: C = 4·C4 votes,
// μ and 1/σ² a (row, h) as 16-byte loads; C4 == 0: element by element.
template <int C4>
__global__ void __launch_bounds__(kEstepThreads, 2)
em_estep_wide_kernel(const EstepArgs a) {
  constexpr int NH = 8;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * (kEstepThreads / 32) + (threadIdx.x >> 5);
  if (w >= a.warps) return;  // whole warps only: the shuffles stay full
  const int H = a.H, C = a.C, L = a.L;
  const size_t HC = (size_t)H * C;
  const float kNegInf = -__int_as_float(0x7f800000);
  const int p0 = (int)((long long)w * a.passes / a.warps);
  const int p1 = (int)((long long)(w + 1) * a.passes / a.warps);
  for (int row = p0; row < p1; ++row) {
    const int b = row / L;
    const float* vrow = a.votes + (size_t)row * HC;
    float* rrow = a.r + (size_t)row * H;
    float M = kNegInf, S = 0.0f;
    for (int hp = 0; hp < a.h_passes; ++hp) {
      float lg[NH];
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int h = 256 * hp + 32 * j + lane;
        lg[j] = kNegInf;
        if (h >= H) continue;
        const size_t bh = (size_t)b * H + h;
        float s = 0.0f;
        if constexpr (C4 > 0) {
          const float4* vp = reinterpret_cast<const float4*>(vrow + h * C);
          const float4* mp = reinterpret_cast<const float4*>(a.mu + bh * C);
          const float4* ip = reinterpret_cast<const float4*>(a.isig + bh * C);
#pragma unroll
          for (int q = 0; q < C4; ++q) {
            const float4 x = __ldg(vp + q), m4 = __ldg(mp + q),
                         s4 = __ldg(ip + q);
            const float v[4] = {x.x, x.y, x.z, x.w};
            const float m[4] = {m4.x, m4.y, m4.z, m4.w};
            const float is[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float d = __fsub_rn(v[e], m[e]);
              s = __fadd_rn(s, __fmul_rn(__fmul_rn(d, d), is[e]));
            }
          }
        } else {
          const float* vp = vrow + (size_t)h * C;
          for (int c = 0; c < C; ++c) {
            const float d = __fsub_rn(__ldg(vp + c), __ldg(a.mu + bh * C + c));
            s = __fadd_rn(s, __fmul_rn(__fmul_rn(d, d),
                                       __ldg(a.isig + bh * C + c)));
          }
        }
        lg[j] = __fsub_rn(__ldg(a.bias + bh), __fmul_rn(0.5f, s));
      }
      // fold the pass into the running max and sum (online softmax)
      float m = lg[0];
#pragma unroll
      for (int j = 1; j < NH; ++j) m = fmaxf(m, lg[j]);
      const float M1 = fmaxf(M, warp_reduce<true>(m));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int h = 256 * hp + 32 * j + lane;
        if (h >= H) continue;
        sum = __fadd_rn(sum, expf(__fsub_rn(lg[j], M1)));
        rrow[h] = lg[j];  // unnormalised: rescaled by the second sweep
      }
      sum = warp_reduce<false>(sum);
      S = __fadd_rn(__fmul_rn(S, expf(__fsub_rn(M, M1))), sum);
      M = M1;
    }
    // the second sweep: r = exp(lg − M)/S with the row's final M and S;
    // each lane reads back only the logits it wrote
    for (int hp = 0; hp < a.h_passes; ++hp) {
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int h = 256 * hp + 32 * j + lane;
        if (h < H) rrow[h] = __fdiv_rn(expf(__fsub_rn(rrow[h], M)), S);
      }
    }
  }
}

cudaError_t launch_estep_wide(const EstepArgs& a, int c4, int blocks,
                              cudaStream_t s) {
  switch (c4) {
    case 0: em_estep_wide_kernel<0><<<blocks, kEstepThreads, 0, s>>>(a); break;
    case 1: em_estep_wide_kernel<1><<<blocks, kEstepThreads, 0, s>>>(a); break;
    case 2: em_estep_wide_kernel<2><<<blocks, kEstepThreads, 0, s>>>(a); break;
    case 3: em_estep_wide_kernel<3><<<blocks, kEstepThreads, 0, s>>>(a); break;
    case 4: em_estep_wide_kernel<4><<<blocks, kEstepThreads, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the vector path only for at most two h a lane (its μ and 1/σ² rows fill
// the registers); the scalar path for any
template <int NH>
cudaError_t launch_estep_nh(const EstepArgs& a, int c4, int blocks,
                            cudaStream_t s) {
  if constexpr (NH <= 2) {
    switch (c4) {
      case 0: em_estep_kernel<NH, 0><<<blocks, kEstepThreads, 0, s>>>(a); break;
      case 1: em_estep_kernel<NH, 1><<<blocks, kEstepThreads, 0, s>>>(a); break;
      case 2: em_estep_kernel<NH, 2><<<blocks, kEstepThreads, 0, s>>>(a); break;
      case 3: em_estep_kernel<NH, 3><<<blocks, kEstepThreads, 0, s>>>(a); break;
      case 4: em_estep_kernel<NH, 4><<<blocks, kEstepThreads, 0, s>>>(a); break;
      default: return cudaErrorInvalidValue;
    }
  } else {
    if (c4 != 0) return cudaErrorInvalidValue;
    em_estep_kernel<NH, 0><<<blocks, kEstepThreads, 0, s>>>(a);
  }
  return cudaGetLastError();
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

// E-step: r (B,L,H) from votes (B,L,H,C), mu and isig (B,H,C), bias (B,H),
// at the geometry of ops.py::estep_geometry: rows_per_pass = 32 / H (one
// where H > 32), h_per_lane = ceil(H / 32) ≤ 8 (the kernel is built for 1,
// 2, 4 and 8) and h_passes = 1, or for H > 256 h_per_lane = 8 and h_passes
// = ceil(H / 256) (the wide kernel); vector 4 (C a multiple of 4 up to 16,
// h_per_lane ≤ 2 or the wide kernel, 16-byte aligned operands) or 1,
// warps ≤ passes = ceil(B·L / rows_per_pass) over blocks of 8 warps.
// Returns cudaErrorInvalidValue for a geometry that does not fit the shape.
int em_stage_estep(const float* votes, const float* mu, const float* isig,
                   const float* bias, float* r, int B, int L, int H, int C,
                   int rows_per_pass, int h_per_lane, int vector,
                   int warps, int blocks, int h_passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = H > 256;
  const int nh = wide ? 8 : (H + 31) / 32;
  const long long n_rows = (long long)B * L;
  if (B < 1 || L < 1 || H < 1 || C < 1 || h_per_lane != nh ||
      h_passes != (wide ? (H + 255) / 256 : 1) ||
      rows_per_pass != (H <= 32 ? 32 / H : 1) || warps < 1 ||
      (long long)blocks * (kEstepThreads / 32) < warps ||
      (long long)(blocks - 1) * (kEstepThreads / 32) >= warps) {
    return (int)cudaErrorInvalidValue;
  }
  const long long passes = (n_rows + rows_per_pass - 1) / rows_per_pass;
  if (warps > passes) return (int)cudaErrorInvalidValue;
  int c4 = 0;
  if (vector == 4) {
    const uintptr_t al = reinterpret_cast<uintptr_t>(votes) |
                         reinterpret_cast<uintptr_t>(mu) |
                         reinterpret_cast<uintptr_t>(isig);
    if (C % 4 != 0 || C > 16 || (nh > 2 && !wide) || al % 16 != 0)
      return (int)cudaErrorInvalidValue;
    c4 = C / 4;
  } else if (vector != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const EstepArgs a{votes, mu, isig, bias, r, B, L, H, C, rows_per_pass,
                    (int)passes, warps, h_passes};
  if (wide) return (int)launch_estep_wide(a, c4, blocks, s);
  cudaError_t err;
  switch (nh) {
    case 1: err = launch_estep_nh<1>(a, c4, blocks, s); break;
    case 2: err = launch_estep_nh<2>(a, c4, blocks, s); break;
    case 3:
    case 4: err = launch_estep_nh<4>(a, c4, blocks, s); break;
    case 5: case 6: case 7:
    case 8: err = launch_estep_nh<8>(a, c4, blocks, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
