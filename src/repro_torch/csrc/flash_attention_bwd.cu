// The FlashAttention-2 backward of causal / bidirectional GQA attention for
// Hopper (sm_90a), compiled into the port's one library
// (repro_torch/kernels/cudalib.py) and bound through a plain C interface.
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernels
//   repro/kernels/flash_attention/kernel.py::flash_attention_bwd
//     (_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel):
//     given q, k, v, dO, the forward's lse and delta = Σ_D o·dO (fp32,
//     computed outside the kernels), recompute p = exp(s − lse) with
//     s = q·kᵀ·scale masked to −1e30, dp = dO·vᵀ, ds = p·(dp − delta)·scale;
//     then dq = ds·k (per query head), dv = pᵀ·dO and dk = dsᵀ·q per *query*
//     head, written in q's dtype as (B, Hq, S, D).  The sum over each KV
//     head's query-head group happens outside, in a fixed order, after the
//     per-head rounding to q's dtype, as in the reference.
//
// What bounds it: operations.  At granite-3-2b's training shape (B=8,
// Hq=32, S=1024, D=64, causal) the backward is 2.5× the forward's
// products, about 86 GFLOP a layer: 0.087 ms at the 989 TFLOP/s bf16
// tensor-core rate.  Both kernels recompute s and dp (7 products against
// the 5 of a backward that accumulates dq with atomics), and each score
// takes one exp2 in each kernel.  Its bytes, each input read and each
// output written once, take 0.05 ms at 3.35 TB/s.
//
// Design.  The TPU grids run their innermost axis in order and keep the
// accumulators in VMEM scratch.  Here each block owns a whole reduction,
// so nothing carries between blocks and no atomics are needed: two calls
// agree bitwise.
//
// bf16: two tensor-core kernels (mma.sync.m16n8k16, bf16 in, fp32
// accumulate; the building blocks in flash_tc.cuh), 4 warps a block, each
// warp owning m_tiles<D>() 16-row tiles (two at D ≤ 64, one above; D = 112
// and 160 are multiples of 16 like the rest, so every k-step, 16-byte
// chunk and padded row holds as in the forward):
//   dq:  one block per (b, h, q-tile of 64·m_tiles rows) loops over the
//        k-tiles up to the diagonal, K and V double-buffered with cp.async,
//        the q and dO fragments in registers at D ≤ 64: S = Q·Kᵀ and dP =
//        dO·Vᵀ on mma, p = 2^(s·scale·log2e − lse·log2e) (one FFMA and
//        ex2.approx), ds = p·(dp − delta) in registers, and dQ += dS·K with
//        dS rounded to bf16 in registers into the A operand and K read
//        through ldmatrix.trans; the scale applies once at the end.  At
//        D ≤ 64 (two m-tiles) and at D = 256 (a 128-register accumulator)
//        a k-tile is taken in two halves of 32 keys, so the score
//        fragments fit beside the accumulators.
//   dkv: one block per (b, h_q, k-tile of 64·m_tiles keys) loops over the
//        q-tiles from the diagonal on (causal).  It computes the transposed
//        products Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so pᵀ and dsᵀ come out in the
//        accumulator layout, and those fragments, rounded to bf16, are the
//        A operands of dV += Pᵀ·dO and dK += dSᵀ·Q (dO and Q through
//        ldmatrix.trans): no shared-memory transpose.  K and V load once;
//        Q, dO and the q-tile's lse and delta stream through a cp.async
//        double buffer; the q-tile is taken in two halves of 32 rows.
//        At D = 256 dk and dv would hold 256 fp32 a lane: two blocks share
//        a k-tile, each recomputing pᵀ and dsᵀ over the whole head dim and
//        accumulating half of dk's and dv's columns (dkv_splits).
// Shared memory at D=64: 74–75 KB a block in each kernel (the block's own
// pair, q and dO or k and v, at 128 rows, and the streamed pair
// double-buffered at 64 rows).  p and ds round to bf16 once before their
// products, as the library's backward does; the gate for these kernels is
// chip_smoke.py's library-anchored one.
//
// fp32: flash_bwd_dq_f32_kernel and flash_bwd_dkv_f32_kernel, the same two
// reductions on the tensor cores in split TF32 (flash_tc.cuh: each fp32
// product three mma.sync.m16n8k8 on TF32 big and small parts, fp32
// accumulation, fp32-level error), replacing the first, CUDA-core kernels,
// which staged every tile element by element and transposed, fed their
// FFMA from two shared-memory loads a 16 and passed p and ds through
// shared memory.  What bounds them: operations at 495/3 = 165 TFLOP/s of
// fp32 products (0.521 ms at (4, 32, 4, 1024, 128) causal, by the 2.5×
// count; 1.283 at the CUDA cores' 67).  The bf16 kernels' structure, in
// fp32 tiles of D + 4 floats a row:
//   dq:  a block of 8 warps (4 at D = 256) owns 128 (64) query rows, q and
//        dO staged once; K and V stream in steps of 64 keys (32 at D = 112
//        and 128, 16 above) through a cp.async double buffer; s = q·kᵀ and
//        dp = dO·vᵀ from 4-byte fragment loads, ds = p·(dp − delta) in
//        registers, dq += ds·k with ds as the A operand in registers (the
//        key relabelling) and K read as 8-byte pairs (the column
//        relabelling), stored as 16-byte runs; the scale once at the end.
//   dkv: a block of 8 warps (4 at D = 256) owns 128 (64) keys, K and V
//        staged once; q, dO and their lse and delta stream in steps of 32
//        rows (16 above D = 128; at most 32, where the step's scores
//        beside dk and dv spilled) from the diagonal on (causal); the
//        transposed products sᵀ = k·qᵀ and dpᵀ = v·dOᵀ give pᵀ and dsᵀ in
//        the accumulator layout, so they are the A operands of dv += pᵀ·dO
//        and dk += dsᵀ·q in registers.  Above D = 128 dk and dv (D/2 fp32
//        a lane each) would leave no room for the split fragments: two
//        blocks share a key tile, each recomputing sᵀ and dpᵀ over all of
//        D and accumulating half of dk's and dv's columns.
// The steps are the largest that fit the block's shared memory beside
// the resident tiles (kernel.py::f32_geometry models them): 202,752 and
// 203,264 bytes at D = 128.  Copies take 16 bytes, or 4 where a base
// pointer is only 4-byte aligned.  The split happens at each fragment
// load (4 operations an element).  The tensor cores truncate as they
// accumulate, so dq, dk and dv sum each 32 rows or keys, and above D =
// 128 the score products each half of D, into a fresh accumulator added
// to the running one in fp32 (flash_tc.cuh::add_to, set_or_add).
//
// In every kernel rows and keys past S are zero-filled and masked, so any S
// runs.
//
// Sliding window (window = W > 0, causal only; 0: none), as in the forward:
// key col counts for row row iff row − W < col <= row.  The dq kernels
// start their k-tile loop at the tile holding the q-tile's first row's
// first key; the dk/dv kernels end their q-tile loop at the tile holding
// the k-tile's last key's last row (key + W − 1), so the q-tile range of a
// k-tile has two ends.  A warp skips a tile (or chunk) wholly outside its
// own rows' or keys' band, the band's lower edge joins the masked-tile
// test, and p is 0 outside it.  At W >= S the result is the causal one
// bitwise.
//
// Cross attention (causal = 0, Sk ≠ Sq allowed), as in the forward: q, dO,
// dq, lse and delta have Sq rows, k, v and the per-query-head dk_h, dv_h
// Sk.  The dq kernels' q-tile grid and their row masks count Sq, their
// k-tile loop, loads and column masks Sk; the dk/dv kernels' k-tile grid
// and key masks count Sk, their q-tile loop, loads and row masks Sq.
// Causal attention needs Sk = Sq, so there both are the one S they were.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

namespace tc = flash_tc;
using tc::bf16;

// ---- fp32: split TF32 on the tensor cores ----------------------------------

using tc::kSmemOptIn;

// The two kernels' geometry: two resident tiles (q and dO; k and v) of
// 16·warps rows, the streamed pair (k and v; q and dO) in steps of
// `step` rows, and for the dk/dv kernel the step's lse and delta
template <int D>
__host__ __device__ constexpr int dq_warps() {
  return tc::f32_warps<D>(2, 0);
}
template <int D>
__host__ __device__ constexpr int dq_step() {
  return tc::f32_step<D>(2, 0);
}
template <int D>
__host__ __device__ constexpr int dkv_warps() {
  return tc::f32_warps<D>(2, 2);
}
// at most 32 rows: the step's sᵀ and dpᵀ (QS/2 registers a lane each)
// beside dk and dv spilled at 64 (D = 64)
template <int D>
__host__ __device__ constexpr int dkv_step() {
  return tc::f32_step<D>(2, 2) < 32 ? tc::f32_step<D>(2, 2) : 32;
}
template <int D>
constexpr size_t dq_f32_smem() {
  return tc::f32_smem<D>(2, dq_warps<D>(), dq_step<D>(), 0);
}
template <int D>
constexpr size_t dkv_f32_smem() {
  return tc::f32_smem<D>(2, dkv_warps<D>(), dkv_step<D>(), 2);
}
// Blocks a key tile's dk and dv columns are split over: above D = 128 the
// two fp32 accumulators (D/2 a lane each) would crowd out the split
// fragments, so each of two blocks recomputes sᵀ and dpᵀ over the whole
// head dim and accumulates half of dk's and dv's columns
template <int D>
__host__ __device__ constexpr int dkv_f32_splits() {
  return D > 128 ? 2 : 1;
}
static_assert(dq_warps<128>() == 8 && dq_step<128>() == 32 &&
                  dq_step<160>() == 16 && dq_warps<256>() == 4 &&
                  dq_step<256>() == 16 && dq_f32_smem<128>() == 202752 &&
                  dkv_f32_smem<128>() == 203264 &&
                  dkv_f32_smem<256>() == 199936,
              "kernel.py::f32_geometry models the fp32 backward's geometry");

// one block an SM asked of ptxas explicitly in both kernels: faster than
// no count from D = 32 up, level at 16 (scripts/flash_f32_variants.py,
// PERF.md §6)
template <int D>
__global__ void __launch_bounds__(32 * dq_warps<D>(), 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Hq, int Hkv, int Sq,
                        int Sk, float scale, int causal, int window,
                        int aligned) {
  constexpr int W = dq_warps<D>();
  constexpr int NT = 32 * W;
  constexpr int BQ = 16 * W;          // query rows a block, 16 a warp
  constexpr int KS = dq_step<D>();    // keys a step
  constexpr int LD = tc::ld_f32<D>();
  constexpr int NK = KS / 8;
  constexpr int KC = NK < 4 ? NK : 4;  // 8-key steps a chunk of dq's sum
  constexpr int KD = D / 8;
  constexpr int KDC = tc::score_chunk<D>();  // k-steps a chunk of s, dp
  static_assert(KD % KDC == 0, "whole score chunks");
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [BQ][LD]     q tile
  float* dos = qs + BQ * LD;          // [BQ][LD]     dO tile
  float* ks = dos + BQ * LD;          // [2][KS][LD]  k steps
  float* vs = ks + 2 * KS * LD;       // [2][KS][LD]  v steps

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16;     // this warp's first row in the tile
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                      // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const float* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float sl2 = scale * tc::kLog2e;
  const float* qa = qs + (wr + g) * LD + t;   // A (k = d): this warp's rows
  const float* doa = dos + (wr + g) * LD + t;
  const float* kb = ks + g * LD + t;          // B (k = d): key rows
  const float* vb = vs + g * LD + t;
  const float* kbp = ks + 2 * t * LD + 2 * g;  // B pairs (k = keys)

  const int n_kt_all = (Sk + KS - 1) / KS;
  // causal: steps starting past this q-tile's last row are skipped
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / KS + 1) : n_kt_all;
  // window: steps ending before the q-tile's first row's window too
  const int it0 = window > 0 ? max(0, q0 - window + 1) / KS : 0;
  const int w_lo = q0 + wr, w_hi = q0 + wr + 15;  // this warp's rows
  tc::load_rows_f32<D, BQ, NT>(qs, q + qoff * D, q0, Sq, tid, aligned);
  tc::load_rows_f32<D, BQ, NT>(dos, dout + qoff * D, q0, Sq, tid, aligned);
  tc::load_rows_f32<D, KS, NT>(ks, kp, it0 * KS, Sk, tid, aligned);
  tc::load_rows_f32<D, KS, NT>(vs, vp, it0 * KS, Sk, tid, aligned);
  tc::cp_async_commit();

  float lse2[2], dl[2];               // rows g and g + 8 (0 past Sq)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    lse2[r] = row < Sq ? lse[qoff + row] * tc::kLog2e : 0.f;
    dl[r] = row < Sq ? delta[qoff + row] : 0.f;
  }
  float acc[ND][4];                   // dq, rows g and g + 8
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * KS;
    const int nb = (it - it0) & 1;    // this step's buffer
    if (it + 1 < n_kt) {              // prefetch the next step
      tc::load_rows_f32<D, KS, NT>(ks + (nb ^ 1) * KS * LD, kp, k0 + KS, Sk,
                                   tid, aligned);
      tc::load_rows_f32<D, KS, NT>(vs + (nb ^ 1) * KS * LD, vp, k0 + KS, Sk,
                                   tid, aligned);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    // causal: a step wholly past this warp's last row adds nothing;
    // window: nor one wholly before its first row's window
    if ((!causal || k0 <= w_hi) &&
        (window == 0 || k0 + KS - 1 > w_lo - window)) {
      const int off = nb * KS * LD;
      float s[NK][4], dp[NK][4];      // 16 rows × KS keys
#pragma unroll
      for (int d0 = 0; d0 < KD; d0 += KDC) {
        float ps[NK][4] = {}, pd[NK][4] = {};  // a chunk's sums
#pragma unroll
        for (int kk = d0; kk < d0 + KDC; ++kk) {
          const tc::Frag<4> aq = tc::lda_f32<LD>(qa + 8 * kk);
          const tc::Frag<4> ado = tc::lda_f32<LD>(doa + 8 * kk);
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            tc::mma3(ps[n], aq, tc::ldb_f32(kb + off + 8 * n * LD + 8 * kk));
            tc::mma3(pd[n], ado, tc::ldb_f32(vb + off + 8 * n * LD + 8 * kk));
          }
        }
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          tc::set_or_add(s[n], ps[n], d0 == 0);
          tc::set_or_add(dp[n], pd[n], d0 == 0);
        }
      }

      // ds = p·(dp − delta), unscaled, into s; masked on the diagonal, the
      // window's edge and the ragged step (rows past Sq are not stored)
      const bool edge = k0 + KS > Sk || (causal && k0 + KS - 1 > w_lo) ||
                        (window > 0 && k0 <= w_hi - window);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = tc::ex2(fmaf(s[n][e], sl2, -lse2[r]));
          if (edge) {
            const int row = q0 + wr + g + 8 * r;
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (col >= Sk || (causal && col > row) ||
                (window > 0 && col <= row - window))
              p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - dl[r]);
        }

      // dq += ds · k in split TF32, ds from registers: the sum over each
      // chunk of up to 32 keys in a fresh accumulator, added in fp32 (the
      // tensor cores truncate as they accumulate; tc::add_to)
#pragma unroll
      for (int c0 = 0; c0 < NK; c0 += KC) {
        tc::Frag<4> da[KC];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) da[kk] = tc::a_from_c_f32(s[c0 + kk]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          float part[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
            tc::Frag<2> lo, hi;
            tc::ldb_pair_f32<LD>(lo, hi,
                                 kbp + off + 8 * (c0 + kk) * LD + 16 * dn);
            tc::mma3(part[0], da[kk], lo);
            tc::mma3(part[1], da[kk], hi);
          }
          tc::add_to(acc[2 * dn], part[0]);
          tc::add_to(acc[2 * dn + 1], part[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  float* dqp = dq + qoff * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= Sq) continue;
    // columns 16·dn + 4t .. + 3 (the column relabelling)
#pragma unroll
    for (int dn = 0; dn < D / 16; ++dn)
      *reinterpret_cast<float4*>(dqp + (size_t)row * D + 16 * dn + 4 * t) =
          make_float4(acc[2 * dn][2 * r] * scale,
                      acc[2 * dn + 1][2 * r] * scale,
                      acc[2 * dn][2 * r + 1] * scale,
                      acc[2 * dn + 1][2 * r + 1] * scale);
  }
}

// q, dO, lse and delta of the rows from q0 into one buffer of the dk/dv
// kernel
template <int D, int QS, int NT>
__device__ __forceinline__ void load_q_side_f32(float* qs, float* dos,
                                                float* ls, float* dls,
                                                const float* q,
                                                const float* dout,
                                                const float* lse,
                                                const float* delta, int q0,
                                                int S, int tid,
                                                bool aligned) {
  static_assert(NT >= 2 * QS, "lse and delta: a row a thread each");
  tc::load_rows_f32<D, QS, NT>(qs, q, q0, S, tid, aligned);
  tc::load_rows_f32<D, QS, NT>(dos, dout, q0, S, tid, aligned);
  const int r = tid % QS;
  const bool ok = q0 + r < S;
  const size_t src = ok ? q0 + r : 0;
  if (tid < QS)
    tc::cp_async4(ls + r, lse + src, ok);
  else if (tid < 2 * QS)
    tc::cp_async4(dls + r, delta + src, ok);
}

template <int D>
__global__ void __launch_bounds__(32 * dkv_warps<D>(), 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk_h, float* __restrict__ dv_h,
                         int Hq, int Hkv, int Sq, int Sk, float scale,
                         int causal, int window, int aligned) {
  constexpr int W = dkv_warps<D>();
  constexpr int NT = 32 * W;
  constexpr int BK = 16 * W;          // keys a block, 16 a warp
  constexpr int QS = dkv_step<D>();   // query rows a step
  constexpr int LD = tc::ld_f32<D>();
  constexpr int NQ = QS / 8;          // 8-row n-tiles of a step's scores
  constexpr int KC = NQ < 4 ? NQ : 4;  // 8-row steps a chunk of the sums
  constexpr int KD = D / 8;
  constexpr int KDC = tc::score_chunk<D>();  // k-steps a chunk of sᵀ, dpᵀ
  static_assert(KD % KDC == 0, "whole score chunks");
  constexpr int DS = dkv_f32_splits<D>();
  constexpr int DO = D / DS;          // dk, dv columns this block owns
  constexpr int ND = DO / 8;
  static_assert(BK % QS == 0, "causal steps start at the k-tile's first");
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [BK][LD]     k tile
  float* vs = ks + BK * LD;           // [BK][LD]     v tile
  float* qs = vs + BK * LD;           // [2][QS][LD]  q steps
  float* dos = qs + 2 * QS * LD;      // [2][QS][LD]  dO steps
  float* ls = dos + 2 * QS * LD;      // [2][QS]      lse
  float* dls = ls + 2 * QS;           // [2][QS]      delta

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16;     // this warp's first key in the tile
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x / DS * BK;  // causal: first k-tiles heaviest
  const int c_lo = blockIdx.x % DS * DO;  // this block's first dk/dv column
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const float* qp = q + qoff * D;
  const float* dop = dout + qoff * D;
  const float* lp = lse + qoff;
  const float* dlp = delta + qoff;
  const float sl2 = scale * tc::kLog2e;
  const float* ka = ks + (wr + g) * LD + t;   // A (k = d): this warp's keys
  const float* va = vs + (wr + g) * LD + t;
  const float* qb = qs + g * LD + t;          // B (k = d): q rows
  const float* dob = dos + g * LD + t;
  const float* qbp = qs + 2 * t * LD + 2 * g + c_lo;  // B pairs (k = rows)
  const float* dobp = dos + 2 * t * LD + 2 * g + c_lo;

  // causal: steps whose last row lies before this k-tile are skipped;
  // window: so are those starting past its last key's last row
  const int n_qt = window > 0
      ? min((Sq + QS - 1) / QS, (k0 + BK - 1 + window - 1) / QS + 1)
      : (Sq + QS - 1) / QS;
  const int qi0 = causal ? k0 / QS : 0;
  const int k_lo = k0 + wr, k_hi = k0 + wr + 15;  // this warp's keys
  const float* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  tc::load_rows_f32<D, BK, NT>(ks, kp, k0, Sk, tid, aligned);
  tc::load_rows_f32<D, BK, NT>(vs, vp, k0, Sk, tid, aligned);
  load_q_side_f32<D, QS, NT>(qs, dos, ls, dls, qp, dop, lp, dlp, qi0 * QS,
                             Sq, tid, aligned);
  tc::cp_async_commit();

  float dk[ND][4], dv[ND][4];         // keys g and g + 8
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qi = qi0; qi < n_qt; ++qi) {
    const int buf = (qi - qi0) & 1;
    if (qi + 1 < n_qt) {              // prefetch the next step
      load_q_side_f32<D, QS, NT>(qs + (buf ^ 1) * QS * LD,
                                 dos + (buf ^ 1) * QS * LD,
                                 ls + (buf ^ 1) * QS, dls + (buf ^ 1) * QS,
                                 qp, dop, lp, dlp, (qi + 1) * QS, Sq, tid,
                                 aligned);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qi * QS;
    const int off = buf * QS * LD;
    const float* lt = ls + buf * QS;
    const float* dlt = dls + buf * QS;
    // causal: a step wholly before this warp's first key adds nothing,
    // window: nor one wholly past its last key's window; rows past Sq
    // must not reach dk, dv; causal keys past a row, and keys at or before
    // row − window, are masked
    const bool skip = (causal && q0 + QS - 1 < k_lo) ||
                      (window > 0 && q0 - k_hi >= window);
    const bool edge = q0 + QS > Sq || (causal && k_hi > q0) ||
                      (window > 0 && q0 + QS - 1 - k_lo >= window);
    if (!skip) {
      float st[NQ][4], dpt[NQ][4];    // 16 keys × QS q rows
#pragma unroll
      for (int d0 = 0; d0 < KD; d0 += KDC) {
        float ps[NQ][4] = {}, pd[NQ][4] = {};  // a chunk's sums
#pragma unroll
        for (int kk = d0; kk < d0 + KDC; ++kk) {
          const tc::Frag<4> ak = tc::lda_f32<LD>(ka + 8 * kk);
          const tc::Frag<4> av = tc::lda_f32<LD>(va + 8 * kk);
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            tc::mma3(ps[n], ak, tc::ldb_f32(qb + off + 8 * n * LD + 8 * kk));
            tc::mma3(pd[n], av, tc::ldb_f32(dob + off + 8 * n * LD + 8 * kk));
          }
        }
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          tc::set_or_add(st[n], ps[n], d0 == 0);
          tc::set_or_add(dpt[n], pd[n], d0 == 0);
        }
      }

      // pᵀ into st and dsᵀ = pᵀ·(dpᵀ − delta), unscaled, into dpt
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qr = 8 * n + 2 * t + c;        // row in the step
          const float l2 = lt[qr] * tc::kLog2e, dlv = dlt[qr];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            float p = tc::ex2(fmaf(st[n][e], sl2, -l2));
            if (edge) {
              const int key = k0 + wr + g + 8 * r;
              const int row = q0 + qr;
              if (row >= Sq || (causal && key > row) ||
                  (window > 0 && key <= row - window))
                p = 0.f;
            }
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - dlv);
          }
        }

      // dv += pᵀ · dO and dk += dsᵀ · q in split TF32, pᵀ and dsᵀ from
      // registers, each chunk of up to 32 rows summed apart and added in
      // fp32, as dq's
#pragma unroll
      for (int c0 = 0; c0 < NQ; c0 += KC) {
        tc::Frag<4> pa[KC], da[KC];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          pa[kk] = tc::a_from_c_f32(st[c0 + kk]);
          da[kk] = tc::a_from_c_f32(dpt[c0 + kk]);
        }
#pragma unroll
        for (int dn = 0; dn < DO / 16; ++dn) {
          float pv[2][4] = {}, pk[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
            const int r = 8 * (c0 + kk) * LD + 16 * dn;
            tc::Frag<2> lo, hi;
            tc::ldb_pair_f32<LD>(lo, hi, dobp + off + r);
            tc::mma3(pv[0], pa[kk], lo);
            tc::mma3(pv[1], pa[kk], hi);
            tc::ldb_pair_f32<LD>(lo, hi, qbp + off + r);
            tc::mma3(pk[0], da[kk], lo);
            tc::mma3(pk[1], da[kk], hi);
          }
          tc::add_to(dv[2 * dn], pv[0]);
          tc::add_to(dv[2 * dn + 1], pv[1]);
          tc::add_to(dk[2 * dn], pk[0]);
          tc::add_to(dk[2 * dn + 1], pk[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  const size_t koff = (size_t)(b * Hq + h) * Sk;   // this head's dk_h rows
  float* dkp = dk_h + koff * D;
  float* dvp = dv_h + koff * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wr + g + 8 * r;
    if (key >= Sk) continue;
    // columns c_lo + 16·dn + 4t .. + 3 (the column relabelling)
#pragma unroll
    for (int dn = 0; dn < DO / 16; ++dn) {
      const size_t o4 = (size_t)key * D + c_lo + 16 * dn + 4 * t;
      *reinterpret_cast<float4*>(dkp + o4) =
          make_float4(dk[2 * dn][2 * r] * scale,
                      dk[2 * dn + 1][2 * r] * scale,
                      dk[2 * dn][2 * r + 1] * scale,
                      dk[2 * dn + 1][2 * r + 1] * scale);
      *reinterpret_cast<float4*>(dvp + o4) =
          make_float4(dv[2 * dn][2 * r], dv[2 * dn + 1][2 * r],
                      dv[2 * dn][2 * r + 1], dv[2 * dn + 1][2 * r + 1]);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk_h,
               void* dv_h, int B, int Hq, int Hkv, int Sq, int Sk, float scale,
               int causal, int window, int aligned, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_f32_smem<D>();
  constexpr size_t smem_dkv = dkv_f32_smem<D>();
  static_assert(smem_dq <= kSmemOptIn && smem_dkv <= kSmemOptIn,
                "the fp32 backward's tiles fit one block");
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_f32_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dkv);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int bq = 16 * dq_warps<D>(), bk = 16 * dkv_warps<D>();
  const dim3 grid_q((Sq + bq - 1) / bq, Hq, B);   // q-tiles (dq)
  const dim3 grid_k((Sk + bk - 1) / bk * dkv_f32_splits<D>(), Hq, B);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  flash_bwd_dq_f32_kernel<D><<<grid_q, 32 * dq_warps<D>(), smem_dq, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<float*>(dq), Hq, Hkv, Sq, Sk,
      scale, causal, window, aligned);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_f32_kernel<D>
      <<<grid_k, 32 * dkv_warps<D>(), smem_dkv, stream>>>(
          qp, kp, vp, dop, lse, delta, static_cast<float*>(dk_h),
          static_cast<float*>(dv_h), Hq, Hkv, Sq, Sk, scale, causal, window,
          aligned);
  return (int)cudaGetLastError();
}

int launch_f32_dim(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk_h, void* dv_h, int B, int Hq, int Hkv,
                   int Sq, int Sk, int D, float scale, int causal, int w,
                   int al, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_f32<16>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, al, s);
    case 32:
      return launch_f32<32>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, al, s);
    case 64:
      return launch_f32<64>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, al, s);
    case 112:
      return launch_f32<112>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B,
                             Hq, Hkv, Sq, Sk, scale, causal, w, al, s);
    case 128:
      return launch_f32<128>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B,
                             Hq, Hkv, Sq, Sk, scale, causal, w, al, s);
    case 160:
      return launch_f32<160>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B,
                             Hq, Hkv, Sq, Sk, scale, causal, w, al, s);
    case 256:
      return launch_f32<256>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B,
                             Hq, Hkv, Sq, Sk, scale, causal, w, al, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---- bf16: the tensor-core kernels -----------------------------------------

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq,
                       int Hq, int Hkv, int Sq, int Sk, float scale,
                       int causal, int window) {
  constexpr int MQ = tc::m_tiles<D>();
  constexpr int BQ = tc::kWarps * 16 * MQ;  // query rows a block
  // keys a chunk of a k-tile: 32 at D = 256 too, so its score fragments
  // fit beside the 128 registers of the dq accumulator
  constexpr int KC = D > 160 ? 32 : 64 / MQ;
  constexpr int NK = KC / 8;          // 8-key tiles of a chunk
  constexpr int LD = tc::ld<D>();
  constexpr int TILE = tc::tile<D>();
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr bool kRegQ = D <= 64;     // q, dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD] q tile
  bf16* dos = qs + MQ * TILE;                     // [BQ][LD] dO tile
  bf16* ks = dos + MQ * TILE;                     // [2][64][LD] k tiles
  bf16* vs = ks + 2 * TILE;                       // [2][64][LD] v tiles

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16 * MQ;  // this warp's first row in the tile
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                      // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const bf16* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bf16* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float sl2 = scale * tc::kLog2e;
  // this lane's ldmatrix addresses (a k-tile buffer adds 2·TILE bytes)
  const uint32_t qa = tc::smem_u32(qs) + tc::a_lane(lane, LD) +
                      tc::at(wr, 0, LD);
  const uint32_t doa = qa + 2 * MQ * TILE;
  const uint32_t kbn = tc::smem_u32(ks) + tc::bn_lane(lane, LD);
  const uint32_t vbn = tc::smem_u32(vs) + tc::bn_lane(lane, LD);
  const uint32_t kbk = tc::smem_u32(ks) + tc::bk_lane(lane, LD);

  const int n_kt_all = (Sk + tc::kRows - 1) / tc::kRows;
  // causal: k-tiles starting past this q-tile's last row are skipped
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / tc::kRows + 1)
                          : n_kt_all;
  // window: k-tiles ending before the q-tile's first row's window too
  const int it0 = window > 0 ? max(0, q0 - window + 1) / tc::kRows : 0;
  const int w_lo = q0 + wr, w_hi = q0 + wr + 16 * MQ - 1;  // this warp's
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    tc::load_tile<D>(qs + i * TILE, q + qoff * D, q0 + i * tc::kRows, Sq,
                     tid);
    tc::load_tile<D>(dos + i * TILE, dout + qoff * D, q0 + i * tc::kRows, Sq,
                     tid);
  }
  tc::load_tile<D>(ks, kp, it0 * tc::kRows, Sk, tid);
  tc::load_tile<D>(vs, vp, it0 * tc::kRows, Sk, tid);
  tc::cp_async_commit();

  float lse2[MQ][2], dl[MQ][2];       // rows g and g + 8 (0 past Sq)
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + 16 * i + g + 8 * r;
      lse2[i][r] = row < Sq ? lse[qoff + row] * tc::kLog2e : 0.f;
      dl[i][r] = row < Sq ? delta[qoff + row] : 0.f;
    }
  uint32_t qf[kRegQ ? MQ : 1][kRegQ ? KD : 1][4];
  uint32_t dof[kRegQ ? MQ : 1][kRegQ ? KD : 1][4];
  float acc[MQ][ND][4];               // dq, rows g and g + 8 of each m-tile
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;

  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * tc::kRows;
    const int nb = (it - it0) & 1;    // this k-tile's buffer
    if (it + 1 < n_kt) {              // prefetch the next k-tile
      tc::load_tile<D>(ks + (nb ^ 1) * TILE, kp, k0 + tc::kRows, Sk, tid);
      tc::load_tile<D>(vs + (nb ^ 1) * TILE, vp, k0 + tc::kRows, Sk, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kRegQ) {
      if (it == it0) {
#pragma unroll
        for (int i = 0; i < MQ; ++i)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk) {
            tc::ldsm_x4(qf[i][kk], qa + tc::at(16 * i, 16 * kk, LD));
            tc::ldsm_x4(dof[i][kk], doa + tc::at(16 * i, 16 * kk, LD));
          }
      }
    }
    const uint32_t buf = nb * 2 * TILE;

#pragma unroll
    for (int c0 = 0; c0 < tc::kRows; c0 += KC) {
      // causal: a chunk wholly past this warp's last row adds nothing;
      // window: nor one wholly before its first row's window
      if (causal && k0 + c0 > w_hi) continue;
      if (window > 0 && k0 + c0 + KC - 1 <= w_lo - window) continue;
      float s[MQ][NK][4], dp[MQ][NK][4];  // 16 rows × KC keys an m-tile
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][n][e] = dp[i][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[MQ][4], ado[MQ][4];
#pragma unroll
        for (int i = 0; i < MQ; ++i) {
          if constexpr (kRegQ) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              aq[i][x] = qf[i][kk][x];
              ado[i][x] = dof[i][kk][x];
            }
          } else {
            tc::ldsm_x4(aq[i], qa + tc::at(16 * i, 16 * kk, LD));
            tc::ldsm_x4(ado[i], doa + tc::at(16 * i, 16 * kk, LD));
          }
        }
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, kbn + buf + tc::at(c0 + 16 * np, 16 * kk, LD));
#pragma unroll
          for (int i = 0; i < MQ; ++i) {
            tc::mma(s[i][2 * np], aq[i], bb[0], bb[1]);
            tc::mma(s[i][2 * np + 1], aq[i], bb[2], bb[3]);
          }
          tc::ldsm_x4(bb, vbn + buf + tc::at(c0 + 16 * np, 16 * kk, LD));
#pragma unroll
          for (int i = 0; i < MQ; ++i) {
            tc::mma(dp[i][2 * np], ado[i], bb[0], bb[1]);
            tc::mma(dp[i][2 * np + 1], ado[i], bb[2], bb[3]);
          }
        }
      }

      // ds = p·(dp − delta), unscaled, into s; masked on the diagonal and
      // the ragged tile (each row's dq is its own: rows past Sq need none)
      const bool edge = k0 + c0 + KC > Sk ||
                        (causal && k0 + c0 + KC - 1 > w_lo) ||
                        (window > 0 && k0 + c0 <= w_hi - window);
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = tc::ex2(fmaf(s[i][n][e], sl2, -lse2[i][r]));
            if (edge) {
              const int row = q0 + wr + 16 * i + g + 8 * r;
              const int col = k0 + c0 + 8 * n + 2 * t + (e & 1);
              if (col >= Sk || (causal && col > row) ||
                  (window > 0 && col <= row - window))
                p = 0.f;
            }
            s[i][n][e] = p * (dp[i][n][e] - dl[i][r]);
          }

      // dq += ds · k, ds rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        uint32_t da[MQ][4];
#pragma unroll
        for (int i = 0; i < MQ; ++i)
          tc::a_from_c(da[i], s[i][2 * kk], s[i][2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, kbk + buf + tc::at(c0 + 16 * kk, 16 * dn, LD));
#pragma unroll
          for (int i = 0; i < MQ; ++i) {
            tc::mma(acc[i][2 * dn], da[i], bb[0], bb[1]);
            tc::mma(acc[i][2 * dn + 1], da[i], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  bf16* dqp = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < MQ; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wr + 16 * i + g + 8 * r;
      if (row >= Sq) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(dqp + (size_t)row * D + 8 * n + 2 * t) =
            tc::pack_bf16(acc[i][n][2 * r] * scale,
                          acc[i][n][2 * r + 1] * scale);
    }
}

// Blocks a k-tile's dk and dv columns are split over: above D = 160 the
// two accumulators (D/2 fp32 a lane each, 256 at D = 256) would not fit
// the 255 registers of a lane, so each of two blocks recomputes pᵀ and
// dsᵀ of the k-tile over the whole head dim and accumulates half of the
// columns of dk and dv
template <int D>
__host__ __device__ constexpr int dkv_splits() {
  return D > 160 ? 2 : 1;
}

// q rows a chunk of the dk/dv kernel's transposed products.  At D = 112
// and 160 the dk and dv accumulators (D/2 fp32 a lane each) and a 32-row
// chunk's scores spill 8 and 24 bytes; 16-row chunks spill none at 112
// and more at 160, and were slower at both (PERF.md §6)
constexpr int kQChunk = 32;

// q, dO, lse and delta of the q-tile from row q0 into one buffer
template <int D>
__device__ __forceinline__ void load_q_side(bf16* qs, bf16* dos, float* ls,
                                            float* dls, const bf16* q,
                                            const bf16* dout,
                                            const float* lse,
                                            const float* delta, int q0,
                                            int S, int tid) {
  tc::load_tile<D>(qs, q, q0, S, tid);
  tc::load_tile<D>(dos, dout, q0, S, tid);
  const int r = tid & (tc::kRows - 1);
  const bool ok = q0 + r < S;
  const size_t src = ok ? q0 + r : 0;
  if (tid < tc::kRows)
    tc::cp_async4(ls + r, lse + src, ok);
  else
    tc::cp_async4(dls + r, delta + src, ok);
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk_h, bf16* __restrict__ dv_h,
                        int Hq, int Hkv, int Sq, int Sk, float scale,
                        int causal, int window) {
  static_assert(tc::kThreads == 2 * tc::kRows, "lse and delta: a row each");
  constexpr int MK = tc::m_tiles<D>();
  constexpr int BK = tc::kWarps * 16 * MK;  // keys a block
  constexpr int LD = tc::ld<D>();
  constexpr int TILE = tc::tile<D>();
  constexpr int KD = D / 16;
  constexpr int DS = dkv_splits<D>();
  constexpr int DO = D / DS;          // dk, dv columns this block owns
  constexpr int ND = DO / 8;
  constexpr int NC = kQChunk / 8;     // 8-column tiles of a chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD] k tile
  bf16* vs = ks + MK * TILE;                      // [BK][LD] v tile
  bf16* qs = vs + MK * TILE;                      // [2][64][LD] q tiles
  bf16* dos = qs + 2 * TILE;                      // [2][64][LD] dO tiles
  float* ls = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][64] lse
  float* dls = ls + 2 * tc::kRows;                       // [2][64] delta

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16 * MK;  // this warp's first key in the tile
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x / DS * BK;  // causal: first k-tiles heaviest
  const int c_lo = blockIdx.x % DS * DO;  // this block's first dk/dv column
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const bf16* qp = q + qoff * D;
  const bf16* dop = dout + qoff * D;
  const float* lp = lse + qoff;
  const float* dlp = delta + qoff;
  const float sl2 = scale * tc::kLog2e;
  // this lane's ldmatrix addresses (a q-tile buffer adds 2·TILE bytes)
  const uint32_t ka = tc::smem_u32(ks) + tc::a_lane(lane, LD) +
                      tc::at(wr, 0, LD);
  const uint32_t va = ka + 2 * MK * TILE;
  const uint32_t qbn = tc::smem_u32(qs) + tc::bn_lane(lane, LD);
  const uint32_t dobn = qbn + 4 * TILE;
  const uint32_t qbk = tc::smem_u32(qs) + tc::bk_lane(lane, LD);
  const uint32_t dobk = qbk + 4 * TILE;

  // causal: q-tiles whose last row lies before this k-tile are skipped;
  // window: so are those starting past its last key's last row
  const int n_qt = window > 0
      ? min((Sq + tc::kRows - 1) / tc::kRows,
            (k0 + BK - 1 + window - 1) / tc::kRows + 1)
      : (Sq + tc::kRows - 1) / tc::kRows;
  const int qi0 = causal ? k0 / tc::kRows : 0;
  const int k_lo = k0 + wr, k_hi = k0 + wr + 16 * MK - 1;  // this warp's
  const bf16* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bf16* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
#pragma unroll
  for (int i = 0; i < MK; ++i) {
    tc::load_tile<D>(ks + i * TILE, kp, k0 + i * tc::kRows, Sk, tid);
    tc::load_tile<D>(vs + i * TILE, vp, k0 + i * tc::kRows, Sk, tid);
  }
  load_q_side<D>(qs, dos, ls, dls, qp, dop, lp, dlp, qi0 * tc::kRows, Sq,
                 tid);
  tc::cp_async_commit();

  float dk[MK][ND][4], dv[MK][ND][4];  // keys g and g + 8 of each m-tile
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][n][e] = dv[i][n][e] = 0.f;

  for (int qi = qi0; qi < n_qt; ++qi) {
    const int buf = (qi - qi0) & 1;
    if (qi + 1 < n_qt) {              // prefetch the next q-tile
      load_q_side<D>(qs + (buf ^ 1) * TILE, dos + (buf ^ 1) * TILE,
                     ls + (buf ^ 1) * tc::kRows, dls + (buf ^ 1) * tc::kRows,
                     qp, dop, lp, dlp, (qi + 1) * tc::kRows, Sq, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qi * tc::kRows;
    const uint32_t qb = buf * 2 * TILE;
    const float* lt = ls + buf * tc::kRows;
    const float* dlt = dls + buf * tc::kRows;
    // causal: a q-tile wholly before this warp's first key adds nothing,
    // window: nor one wholly past its last key's window; rows past Sq
    // must not reach dk, dv; causal keys past a row, and keys at or before
    // row − window, are masked
    const bool skip = (causal && q0 + tc::kRows - 1 < k_lo) ||
                      (window > 0 && q0 - k_hi >= window);
    const bool edge = q0 + tc::kRows > Sq || (causal && k_hi > q0) ||
                      (window > 0 && q0 + tc::kRows - 1 - k_lo >= window);

#pragma unroll
    for (int c0 = 0; c0 < tc::kRows; c0 += kQChunk) {
      if (skip) break;
      float st[MK][NC][4], dpt[MK][NC][4];  // 16 keys × 32 q rows each
#pragma unroll
      for (int i = 0; i < MK; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][n][e] = dpt[i][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[MK][4], av[MK][4];  // this warp's keys, A fragments
#pragma unroll
        for (int i = 0; i < MK; ++i) {
          tc::ldsm_x4(ak[i], ka + tc::at(16 * i, 16 * kk, LD));
          tc::ldsm_x4(av[i], va + tc::at(16 * i, 16 * kk, LD));
        }
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, qbn + qb + tc::at(c0 + 16 * np, 16 * kk, LD));
#pragma unroll
          for (int i = 0; i < MK; ++i) {
            tc::mma(st[i][2 * np], ak[i], bb[0], bb[1]);
            tc::mma(st[i][2 * np + 1], ak[i], bb[2], bb[3]);
          }
          tc::ldsm_x4(bb, dobn + qb + tc::at(c0 + 16 * np, 16 * kk, LD));
#pragma unroll
          for (int i = 0; i < MK; ++i) {
            tc::mma(dpt[i][2 * np], av[i], bb[0], bb[1]);
            tc::mma(dpt[i][2 * np + 1], av[i], bb[2], bb[3]);
          }
        }
      }

      // pᵀ into st and dsᵀ = pᵀ·(dpᵀ − delta), unscaled, into dpt
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qr = c0 + 8 * n + 2 * t + c;        // row in the tile
          const float l2 = lt[qr] * tc::kLog2e, dl = dlt[qr];
#pragma unroll
          for (int i = 0; i < MK; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + c;
              float p = tc::ex2(fmaf(st[i][n][e], sl2, -l2));
              if (edge) {
                const int key = k0 + wr + 16 * i + g + 8 * r;
                const int row = q0 + qr;
                if (row >= Sq || (causal && key > row) ||
                    (window > 0 && key <= row - window))
                  p = 0.f;
              }
              st[i][n][e] = p;
              dpt[i][n][e] = p * (dpt[i][n][e] - dl);
            }
        }

      // dv += pᵀ · dO and dk += dsᵀ · q, both rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        uint32_t pa[MK][4], da[MK][4];
#pragma unroll
        for (int i = 0; i < MK; ++i) {
          tc::a_from_c(pa[i], st[i][2 * kk], st[i][2 * kk + 1]);
          tc::a_from_c(da[i], dpt[i][2 * kk], dpt[i][2 * kk + 1]);
        }
#pragma unroll
        for (int dn = 0; dn < DO / 16; ++dn) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb,
                        dobk + qb + tc::at(c0 + 16 * kk, c_lo + 16 * dn, LD));
#pragma unroll
          for (int i = 0; i < MK; ++i) {
            tc::mma(dv[i][2 * dn], pa[i], bb[0], bb[1]);
            tc::mma(dv[i][2 * dn + 1], pa[i], bb[2], bb[3]);
          }
          tc::ldsm_x4_t(bb,
                        qbk + qb + tc::at(c0 + 16 * kk, c_lo + 16 * dn, LD));
#pragma unroll
          for (int i = 0; i < MK; ++i) {
            tc::mma(dk[i][2 * dn], da[i], bb[0], bb[1]);
            tc::mma(dk[i][2 * dn + 1], da[i], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  const size_t koff = (size_t)(b * Hq + h) * Sk;   // this head's dk_h rows
  bf16* dkp = dk_h + koff * D;
  bf16* dvp = dv_h + koff * D;
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + wr + 16 * i + g + 8 * r;
      if (key >= Sk) continue;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const size_t off = (size_t)key * D + c_lo + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(dkp + off) =
            tc::pack_bf16(dk[i][n][2 * r] * scale,
                          dk[i][n][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvp + off) =
            tc::pack_bf16(dv[i][n][2 * r], dv[i][n][2 * r + 1]);
      }
    }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk_h,
              void* dv_h, int B, int Hq, int Hkv, int Sq, int Sk, float scale,
              int causal, int window, cudaStream_t stream) {
  constexpr int M = tc::m_tiles<D>();
  // dq: q and dO (M staged tiles each), two k and two v tiles; dk/dv: k
  // and v (M each), two q and two dO tiles, two lse and two delta rows
  constexpr size_t smem_dq = (2 * M + 4) * tc::tile<D>() * sizeof(bf16);
  constexpr size_t smem_dkv = (2 * M + 4) * tc::tile<D>() * sizeof(bf16) +
                              4 * tc::kRows * sizeof(float);
  // D = 160: 129,024 and 130,048 bytes; D = 256: 202,752 and 203,776
  static_assert(smem_dkv <= kSmemOptIn, "the bf16 tiles fit one block");
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_dkv);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int rows = tc::kWarps * 16 * M;   // rows (dq) or keys (dk/dv) a block
  const dim3 grid_q((Sq + rows - 1) / rows, Hq, B);
  const dim3 grid_k((Sk + rows - 1) / rows * dkv_splits<D>(), Hq, B);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  flash_bwd_dq_tc_kernel<D><<<grid_q, tc::kThreads, smem_dq, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq), Hq, Hkv, Sq, Sk,
      scale, causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_tc_kernel<D><<<grid_k, tc::kThreads, smem_dkv, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk_h),
      static_cast<bf16*>(dv_h), Hq, Hkv, Sq, Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

int launch_tc_dim(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk_h, void* dv_h, int B, int Hq, int Hkv,
                  int Sq, int Sk, int D, float scale, int causal, int w,
                  cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_tc<16>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, Sq, Sk, scale, causal, w, s);
    case 32:
      return launch_tc<32>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, Sq, Sk, scale, causal, w, s);
    case 64:
      return launch_tc<64>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                           Hkv, Sq, Sk, scale, causal, w, s);
    case 112:
      return launch_tc<112>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    case 128:
      return launch_tc<128>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    case 160:
      return launch_tc<160>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    case 256:
      return launch_tc<256>(q, k, v, dout, lse, delta, dq, dk_h, dv_h, B, Hq,
                            Hkv, Sq, Sk, scale, causal, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dq (B,Hq,Sq,D), and dk_h, dv_h (B,Hq,Sk,D) per query head, from q
// (B,Hq,Sq,D), k, v (B,Hkv,Sk,D), dO (B,Hq,Sq,D), all contiguous and of one
// dtype (0 fp32: the split-TF32 kernels, 4-byte aligned; 1 bf16: the bf16
// kernels, 16-byte aligned), and lse, delta (B,Hq,Sq) fp32; D in {16, 32,
// 64, 112, 128, 160, 256} (above 256: flash_attention_wide.cu; the wrapper
// zero-pads any other D up to 256 to the next one); Sk = Sq where causal.
// window > 0 (causal only): the sliding window; 0: none.  Launches the dq
// kernel, then the dk/dv kernel.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, void* dk_h, void* dv_h, int dtype, int B,
                        int Hq, int Hkv, int Sq, int Sk, int D, float scale,
                        int causal, int window, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || window < 0 ||
      (window > 0 && !causal) || (causal && Sk != Sq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (dtype) {
    case 0: {
      // a view's base may be only 4-byte aligned: 4-byte copies then
      const int aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                           (uintptr_t)dout) % 16 == 0;
      return launch_f32_dim(q, k, v, dout, l, dl, dq, dk_h, dv_h, B, Hq, Hkv,
                            Sq, Sk, D, scale, causal, window, aligned, s);
    }
    case 1:
      return launch_tc_dim(q, k, v, dout, l, dl, dq, dk_h, dv_h, B, Hq, Hkv,
                           Sq, Sk, D, scale, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
