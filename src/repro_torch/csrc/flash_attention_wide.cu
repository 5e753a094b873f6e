// Causal (optionally sliding-window) / bidirectional GQA attention at head
// dims above 256 for Hopper (sm_90a): the forward, with or without its
// log-sum-exp, and the FlashAttention-2 backward, compiled into the port's
// one library (repro_torch/kernels/cudalib.py) and bound through a plain C
// interface.
//
// Source note
// -----------
// Replaces, for D > 256, the JAX package's Pallas TPU kernels
//   repro/kernels/flash_attention/kernel.py::flash_attention
//     (_flash_kernel) and ::flash_attention_fwd_lse (_flash_fwd_lse_kernel):
//     o = softmax(q·kᵀ·scale, masked) · v with an fp32 running max m, sum l
//     and accumulator, the −1e30 mask value, the l == 0 → 1 guard, and lse
//     = m + log(l) per row;
//   ...::flash_attention_bwd (_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel):
//     p = exp(s − lse), dp = dO·vᵀ, ds = p·(dp − delta)·scale, dq = ds·k,
//     and dv = pᵀ·dO, dk = dsᵀ·q per *query* head (the group sum happens
//     outside, as for the other head dims).
// The reference's kernels hold a (block, D) tile of q, k and v in VMEM for
// any D.  Here the kernels of flash_attention.cu and flash_attention_bwd.cu
// stage whole rows of D in shared memory and keep a row's accumulator in
// registers, which at D = 256 already takes 222,208 (forward) and 226,816
// (backward) of the 232,448 bytes a block may have; so above 256 the work
// is split another way, and any D runs with no padding.
//
// bf16 forward: wide_fwd_tc_kernel, FlashAttention-2 on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, fp32 accumulation; the building
// blocks of flash_tc.cuh).  A block of 8 warps owns 64 query rows of one
// (b, h) and loops over the 64-key k-tiles itself.  The warps are 4 row
// groups of 16 rows × 2 halves of the head dim:
//   * s = q·kᵀ: each warp of a row group's pair runs the k-steps of its
//     half of D for its 16 rows × 64 keys; the two partial tiles meet in
//     shared memory (a 4 KB slot a warp, a named barrier for the pair),
//     and each warp adds its partner's to its own, so both hold the same
//     sum bitwise (fp32 addition commutes) in a fixed order: one score
//     product per (q-tile, k-tile) pair, whatever D;
//   * both warps then run the same mask and online softmax (row max and
//     sum over the 4 lanes of a fragment row by shuffles, exp2 with
//     scale·log2(e) folded into one FFMA, as flash_attention.cu), round p
//     to bf16 in registers and multiply it by their half of v's columns:
//     o is split over the pair, at most 16 pairs of 8-column tiles a warp
//     (128 fp32 registers at D = 512, 80 at D = 320);
//   * l sums the unrounded p, as the D ≤ 256 bf16 kernel and the library
//     call do; m, l, alpha, lse = m·ln 2 + log(l) and o = acc / l stay
//     fp32, with the −1e30 start and the l == 0 → 1 guard.
// A warp's share is fixed at compile time: NP column pairs (NP k-steps of
// the score product, 2·NP 8-column tiles of o), so a piece of D is 32·NP
// columns, zero past D, and every loop over k-steps and pairs unrolls with
// its shared-memory offsets as immediates (a first version with runtime
// trip counts and a guard on each pair left ldmatrix's latency exposed
// and was markedly slower).  Instantiated at NP = 9, 10, 12 and 16: pieces
// of 288, 320, 384 and 512 columns.
// q, k and v are staged bf16 in shared memory, [64][32·NP + 8] each (the
// row stride ≡ 16 mod 32 bytes, so ldmatrix is free of bank conflicts): q
// once a block, k and v through one buffer each.  Two block barriers a
// tile: the one that opens it (k has landed; every warp is done with the
// last tile's v) issues this tile's v, which loads while the scores and
// the softmax run; the one before p·v (v has landed; every warp is done
// with k) issues the next k-tile, which loads while p·v runs.  With the 32
// KB of partial scores a block takes 384·(32·NP + 8) + 32,768 bytes:
// 158,720 at D = 320, and 232,448, all a block may have, at D = 512.
// Above 512 the head dim is cut into `pieces` (kernel.py::
// wide_fwd_geometry computes the geometry and passes it in): the grid
// holds a block for each output piece of each q-tile, and the score
// product streams q and k through the same buffers piece by piece, q
// restaged for every k-tile, so each output piece recomputes the scores
// (2 pieces at D = 1024: two score products per tile pair).  D not a
// multiple of 8 leaves rows that are not 16-byte aligned (D = 257, 300):
// they are staged element by element with plain loads and stores, at the
// same points of the loop, and the same barriers publish them.  Rows past
// S, keys past Sk and columns past D are zero-filled; masked scores are
// −inf, so a row the window leaves without a key in a tile keeps its
// running max and gets p = 0.
//
// bf16 backward: wide_dq_tc_kernel and wide_dkv_tc_kernel, the
// FlashAttention-2 backward on the tensor cores, two deterministic kernels
// with no atomics (dq; dk and dv per query head).  The rounding is the D ≤
// 256 bf16 backward's: p = 2^(s·scale·log2e − lse·log2e) (0 where masked,
// the reference's −1e30) and the unscaled ds = p·(dp − delta) round to bf16
// once, in registers, before their products; the scale multiplies the sums
// of dq and dk; lse and delta (bwd_delta's, computed outside) are read in
// fp32.  8 warps a block, as the forward's 4 groups × 2 halves, but the
// halves split the *other* tile's 64 rows instead of D, so the pair trades
// bf16 fragments, never fp32 partial sums:
//   * dq: a block owns 64 query rows of one (b, h); warp (rg, half) runs s
//     = q·kᵀ and dp = dO·vᵀ for its 16 rows × the k-tile's keys 32·half..
//     over the whole head dim, forms ds, rounds it into the A fragments of
//     dq's product and writes them to its 1 KB slot; after the pair barrier
//     each warp reads the tile's four fragments (16 rows × 64 keys) and
//     runs dq += ds·k, k read transposed, for its half of the columns.  One
//     score computation per (q-tile, k-tile) pair for any D ≤ 512;
//   * dk/dv: a block owns 64 keys of one (b, query head) and half of the
//     columns of dk and dv (two blocks a k-tile up to D = 512, ceil(D /
//     256) above, each recomputing the scores, as dkv_splits does at D =
//     256: the two accumulators, 2·D/2 fp32 a key row, would not fit a
//     lane's registers whole); warp (kg, half) runs the transposed products
//     sᵀ = k·qᵀ and dpᵀ = v·dOᵀ for its 16 keys × the q-tile's rows
//     32·half.., so pᵀ and dsᵀ come out in the accumulator layout (a q
//     row's lse and delta indexed by the fragment's column) and become the
//     A operands of dv += pᵀ·dO and dk += dsᵀ·q through a_from_c, traded
//     through a 2 KB slot, dO and q read transposed.
// A warp's share is fixed at compile time, NP as in the forward (the score
// product 2·NP k-steps of a 32·NP-column piece, dq 2·NP 8-column tiles, dk
// and dv NP each; 9 tiles at NP = 9, the last loaded with an x4 ldmatrix
// that reads 8 columns of the row beyond it).  Up to NP = 12 (384 columns)
// q, dO, k and v are held whole, [64][32·NP + 8] bf16 each: the dq kernel
// keeps q and dO for the block and issues the next k-tile's v once every
// warp is done with v (it loads while the scores and dq run) and its k
// after dq (it loads while the next dp runs); the dk/dv kernel keeps k and
// v and streams the q-tile's dO with delta and q with lse (cp.async) the
// same way, dO's after dv, q's after dk.  Above, the dq kernel's k and v
// take turns in one tile, and so do the dk/dv kernel's dO and q, dO's
// output piece restaged over q for dv (3 tiles each), with no load in
// flight during the products.  Above D = 512 the score products stream
// every operand piece by piece (the dq kernel's q and dO, the dk/dv
// kernel's k and v, q restaged at its output piece), and each dq piece
// recomputes the scores (two at D = 1024).  D not a multiple of 8 stages
// rows element by element, as the forward, and carries ds as two bf16
// terms, hi + lo (each a product into dq and dk, one B fragment load for
// both): there the library has no fused bf16 backward and computes in
// fp32, and on an H100 one term left dq's error over chip_smoke.py's
// library-anchored gate (at D = 300 a mean 1.59× the library's, at D = 257
// a max 2.6×; with two, within 1.03–1.80×).  Shared memory, in dq_tc_smem
// and dkv_tc_smem: at D = 320 176,128 and 184,832 bytes.
//
// fp32 forward and backward: wide_fwd_f32_kernel, wide_dq_f32_kernel and
// wide_dkv_f32_kernel, FlashAttention-2 on the CUDA cores in fp32 FFMA
// (no TF32 on the wide route: it keeps fp32 round-off; the fp32 kernels
// at D ≤ 256 run split TF32 on the tensor cores).  256 threads a
// block, 64-row q- and k-tiles as above:
//   * a block owns one tile and one output piece of 64·G columns (G float4
//     column groups a thread, 5, 6 or 8: pieces of 320, 384 or 512
//     columns, one up to D = 512) of o, dq, dv or dk: the dk/dv kernel's
//     grid holds a block for each piece of dv and one for each of dk, so
//     a thread holds one accumulator whatever D, at the geometries
//     kernel.py::wide_f32_fwd_geometry and wide_f32_bwd_geometry pass in;
//   * the score products run once per tile pair, over D (above 512 over
//     the block's piece of it, below) in steps that cp.async streams 16
//     bytes at a time through a ring of four slots, row strides ≡ 4 mod
//     32 floats (free of bank conflicts): the forward's two halves of the
//     block each take half of a 32-column step of q and k and add their
//     partial 64 × 64 scores in shared memory; so do the dv blocks for sᵀ
//     = k·qᵀ, the only product dv needs; in the dq and dk blocks half 0
//     runs s (or sᵀ) and half 1 dp (or dpᵀ) over 16-column steps of the
//     four operands.  A thread holds an 8 × 4 tile of a half's scores:
//     per 4 columns 12 float4 loads feed 128 FFMA;
//   * the accumulating products (o += p·v, dq += ds·k, dv += pᵀ·dO, dk +=
//     dsᵀ·q) hold the output piece in registers, a 4-row × 4·G-column tile
//     a thread (16·G fp32, 128 at G = 8): per key 1 + G float4 loads feed
//     16·G FFMA.  Their operand's piece (v, k, dO or q) streams through
//     the same ring, 16 rows a step after the tile pair's score steps, so
//     loads run in both phases;
//   * the forward's online softmax runs a warp a row over the summed
//     scores (expf, the −1e30 mask, the l == 0 → 1 guard, lse = m +
//     log(l), the running m and l in shared memory); the backward forms p
//     = exp(s·scale − lse) and ds = p·(dp − delta)·scale elementwise
//     (ds carries the scale, so dq and dk need none).
// Above D = 512 the pieces of a tile form a thread-block cluster: each
// block runs the score products over its own piece's columns and adds
// the cluster's partial tiles, in rank order, through distributed shared
// memory, so the scores still run once per tile pair (up to 8 pieces, D =
// 4096; beyond, each piece reruns them over all of D).  Only the first
// forward piece writes lse.
// Rows of D not a multiple of 4 (D = 257, 300) are not 16-byte aligned:
// they are copied element by element, by 4-byte cp.async at the same
// points, and stored element by element.  Sums run in a fixed order and
// no kernel here uses atomics: two calls agree bitwise.
//
// What bounds them: operations.  The forward at (B=4, Hq=16, S=1024,
// D=512, causal) is 4·B·Hq·D·S²/2 = 68.8 GFLOP of multiply-adds, 0.07 ms
// at the 989 TFLOP/s bf16 tensor-core rate and 1.03 ms at the 67 TFLOP/s
// fp32 CUDA-core rate the fp32 kernels run at.  Up to D = 512 the fp32
// backward runs 8 D-wide products a tile pair: the dq blocks s, dp and
// dq, the dv blocks s and dv, the dk blocks s, dp and dk (the function
// needs 5; a split into dq and dk/dv with no atomics, 7).
//
// Masks, tile ranges, the sliding window (W > 0, causal only: key col
// counts for row row iff row − W < col <= row) and cross attention (Sk ≠
// Sq, bidirectional) are those of the fp32 kernels in flash_attention.cu
// and flash_attention_bwd.cu.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;                // query rows or keys a tile
constexpr float kNegInf = -1e30f;     // the reference's mask value

__device__ __forceinline__ bool in_band(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) &&
         (window == 0 || col > row - window);
}

// ---- the bf16 forward on the tensor cores ---------------------------------

namespace tc = flash_tc;

constexpr int kTcWarps = 8;               // 4 row groups × 2 halves of D
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kXchg = 8 * 32 * 4;         // floats of a warp's partial s
constexpr size_t kSmemOptIn = 232448;     // the H100's opt-in bytes a block

static_assert(tc::kRows == kT, "64-row q- and k-tiles");

// shared memory of a block whose warps hold NP column pairs each (pieces
// of 32·NP columns): the q, k and v tiles and every warp's partial scores
__host__ __device__ constexpr size_t tc_smem(int NP) {
  return 3 * sizeof(bf16) * kT * (32 * NP + 8) +
         sizeof(float) * kTcWarps * kXchg;
}
static_assert(tc_smem(10) == 158720 && tc_smem(16) == kSmemOptIn,
              "a 320-column piece takes 158,720 bytes, a 512-column one "
              "all a block may have");

// the two warps of row group rg (warps rg and rg + 4) wait for each other
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + rg), "n"(64) : "memory");
}

// Rows r0..r0+63, columns c0..c0 + W − 1 of a contiguous (S, D) bf16
// matrix into a [64][LD] tile (LD = W + 8 unless given); rows past S and
// columns past D are zero.  D a multiple of 8 (`aligned`): 16-byte
// cp.async, which the caller commits and waits for; otherwise the rows are
// not 16-byte aligned, and each element is loaded and stored here (two a
// thread a step), published by the caller's next barrier.
template <int W, int LD = W + 8>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int r0, int S, int D, int c0,
                                           bool aligned, int tid) {
  if (aligned) {
    constexpr int N8 = W / 8;             // 16-byte chunks a row
#pragma unroll 4
    for (int e = tid; e < kT * N8; e += kTcThreads) {
      const int r = e / N8, c = 8 * (e % N8);
      const bool ok = r0 + r < S && c0 + c < D;
      tc::cp_async16(dst + r * LD + c,
                     src + (ok ? (size_t)(r0 + r) * D + c0 + c : 0), ok);
    }
  } else {
    constexpr int N2 = W / 2;             // element pairs a row
    const bf16 zero = __ushort_as_bfloat16((unsigned short)0);
    for (int e = tid; e < kT * N2; e += kTcThreads) {
      const int r = e / N2, c = 2 * (e % N2);
      const int col = c0 + c;
      bf16 x0 = zero, x1 = zero;
      if (r0 + r < S) {
        const bf16* row = src + (size_t)(r0 + r) * D;
        if (col < D) x0 = row[col];
        if (col + 1 < D) x1 = row[col + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + r * LD + c) =
          __halves2bfloat162(x0, x1);
    }
  }
}

// NP: 16-column pairs of o a warp holds and k-steps of the score product
// it runs, a piece; a piece is 32·NP columns (zero past D), the warp's
// half of it 16·NP
template <int NP>
__global__ void __launch_bounds__(kTcThreads, 1)
wide_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                   int D, float scale, int causal, int window, int pieces) {
  constexpr int W = 32 * NP;              // columns of a piece
  constexpr int LD = W + 8;               // row stride of a staged tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);       // [64][LD] q
  bf16* ks = qs + kT * LD;                            // [64][LD] k
  bf16* vs = ks + kT * LD;                            // [64][LD] v
  float* xs = reinterpret_cast<float*>(vs + kT * LD); // [8 warps][kXchg]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, half = warp >> 2;          // row group, half
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = gridDim.x / pieces;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / pieces) * kT;  // heaviest
                                                              // first
  const int c_out = ((int)blockIdx.x % pieces) * W;   // this output piece
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                      // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const bf16* qp = q + qoff * D;
  const bf16* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bf16* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bool aligned = D % 8 == 0;
  const bool whole = pieces == 1;         // q staged once a block
  const float sl2 = scale * tc::kLog2e;
  const int wr = 16 * rg;                 // this warp's first row
  const int w_lo = q0 + wr, w_hi = w_lo + 15;
  // this lane's ldmatrix addresses: q rows (A) and k rows (B) at this
  // warp's half of the columns, v (B, transposed) at its output columns
  const uint32_t qa = tc::smem_u32(qs) + tc::a_lane(lane, LD) +
                      tc::at(wr, 16 * NP * half, LD);
  const uint32_t kb = tc::smem_u32(ks) + tc::bn_lane(lane, LD) +
                      tc::at(0, 16 * NP * half, LD);
  const uint32_t vb = tc::smem_u32(vs) + tc::bk_lane(lane, LD) +
                      tc::at(0, 16 * NP * half, LD);
  float* xw = xs + warp * kXchg + 4 * lane;            // own partial s
  const float* xp = xs + (warp ^ 4) * kXchg + 4 * lane;  // the partner's

  const int n_kt_all = (Sk + kT - 1) / kT;
  // causal: k-tiles starting past this q-tile's last row are skipped;
  // window: so are those ending before its first row's window
  const int n_kt = causal ? min(n_kt_all, (q0 + kT - 1) / kT + 1) : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / kT : 0;
  if (whole) {
    stage_rows<W>(qs, qp, q0, Sq, D, 0, aligned, tid);
    stage_rows<W>(ks, kp, it0 * kT, Sk, D, 0, aligned, tid);
    tc::cp_async_commit();
  }

  float acc[NP][2][4];                    // o, rows g and g + 8
  float m[2], l[2];                       // running max (exp2), sum part
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;

  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * kT;
    // causal: a k-tile wholly past this warp's last row adds nothing;
    // window: nor one wholly before its first row's window (the same for
    // both warps of a pair)
    const bool live = (!causal || k0 <= w_hi) &&
                      (window == 0 || k0 + kT - 1 > w_lo - window);
    float s[8][4];                        // 16 rows × 64 keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int pc = 0; pc < pieces; ++pc) {
      if (!whole) {                       // this piece of q and k
        if (pc > 0) __syncthreads();      // the last piece's reads are done
        stage_rows<W>(qs, qp, q0, Sq, D, pc * W, aligned, tid);
        stage_rows<W>(ks, kp, k0, Sk, D, pc * W, aligned, tid);
        tc::cp_async_commit();
      }
      tc::cp_async_wait<0>();             // q and this k-tile have landed
      // k is visible; every warp is done with the last tile's v (and its
      // partner's partial scores): refill v
      __syncthreads();
      if (whole) {
        stage_rows<W>(vs, vp, k0, Sk, D, 0, aligned, tid);
        tc::cp_async_commit();
      }
      if (live) {
        // this warp's half of the piece: k-steps 16·NP·half..
#pragma unroll
        for (int kk = 0; kk < NP; ++kk) {
          uint32_t aq[4];
          tc::ldsm_x4(aq, qa + tc::at(0, 16 * kk, LD));
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bb[4];
            tc::ldsm_x4(bb, kb + tc::at(16 * np, 16 * kk, LD));
            tc::mma(s[2 * np], aq, bb[0], bb[1]);
            tc::mma(s[2 * np + 1], aq, bb[2], bb[3]);
          }
        }
      }
    }
    // the pair's two halves of s, added in one order: each warp adds its
    // partner's partial to its own, and a + b = b + a bitwise
    if (live) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float4*>(xw + n * 128) =
            make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      pair_sync(rg);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 x = *reinterpret_cast<const float4*>(xp + n * 128);
        s[n][0] += x.x;
        s[n][1] += x.y;
        s[n][2] += x.z;
        s[n][3] += x.w;
      }

      // mask the diagonal, the window's lower edge and the ragged tile
      if (k0 + kT > Sk || (causal && k0 + kT - 1 > w_lo) ||
          (window > 0 && k0 <= w_hi - window)) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = w_lo + g + 8 * (e >> 1);
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            // −inf, not −1e30: a row the window leaves without a key in
            // this tile keeps its running max and gets p = 2^−inf = 0
            if (col >= Sk || (causal && col > row) ||
                (window > 0 && col <= row - window))
              s[n][e] = __int_as_float(0xff800000);
          }
      }
      // online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3), in the
      // exp2 domain: p = 2^(s·scale·log2e − m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mt = fmaxf(m[r], mx * sl2);
        const float alpha = tc::ex2(m[r] - mt);
        m[r] = mt;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 2 * r; c < 2 * r + 2; ++c) {
            s[n][c] = tc::ex2(fmaf(s[n][c], sl2, -mt));
            rs += s[n][c];
          }
        l[r] = alpha * l[r] + rs;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[p][j][2 * r] *= alpha;
            acc[p][j][2 * r + 1] *= alpha;
          }
      }
    }

    if (!whole) {                         // v is free since the last tile
      stage_rows<W>(vs, vp, k0, Sk, D, c_out, aligned, tid);
      tc::cp_async_commit();
    }
    tc::cp_async_wait<0>();               // this v-tile has landed
    // v is visible; every warp is done with k: refill k
    __syncthreads();
    if (whole && it + 1 < n_kt) {
      stage_rows<W>(ks, kp, k0 + kT, Sk, D, 0, aligned, tid);
      tc::cp_async_commit();
    }
    if (live) {
      // o += p · v over this warp's column pairs, p rounded to bf16 in
      // registers
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[4];
        tc::a_from_c(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, vb + tc::at(16 * kk, 16 * p, LD));
          tc::mma(acc[p][0], pa, bb[0], bb[1]);
          tc::mma(acc[p][1], pa, bb[2], bb[3]);
        }
      }
    }
  }

  bf16* op = o + qoff * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = w_lo + g + 8 * r;
    if (row >= Sq) continue;
    const float lsafe = lr == 0.f ? 1.f : lr;
    const float inv = 1.f / lsafe;
    bf16* orow = op + (size_t)row * D;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = c_out + 16 * (NP * half + p) + 8 * j + 2 * t;
        const float x0 = acc[p][j][2 * r] * inv;
        const float x1 = acc[p][j][2 * r + 1] * inv;
        if (D % 2 == 0) {                 // col even: 4-byte aligned pair
          if (col < D)
            *reinterpret_cast<uint32_t*>(orow + col) = tc::pack_bf16(x0, x1);
        } else {
          if (col < D) orow[col] = __float2bfloat16(x0);
          if (col + 1 < D) orow[col + 1] = __float2bfloat16(x1);
        }
      }
    // m and l are whole-row values in the row's 4 lanes, and the same in
    // both warps of the pair and in every piece
    if (lse != nullptr && half == 0 && c_out == 0 && t == 0)
      lse[qoff + row] = m[r] * tc::kLn2 + logf(lsafe);
  }
}

// ---- the bf16 backward on the tensor cores ---------------------------------

// q, dO, k and v held whole in shared memory (up to 384 columns), or,
// above, k and v taking turns in one tile (dq), q and dO in one tile
// (dk/dv)
__host__ __device__ constexpr bool bwd_resident(int NP) { return NP <= 12; }

constexpr int kFragSlot = 2 * 32;   // uint4 of a warp's two A fragments
// the two kernels' shared memory at NP column pairs (score pieces of 32·NP
// columns) and TERMS bf16 terms of ds: the staged tiles, the warps'
// fragment slots (ds in the dq kernel, p and ds in the dk/dv kernel) and,
// in the dk/dv kernel, the q-tile's lse and delta
__host__ __device__ constexpr size_t dq_tc_smem(int NP, int TERMS) {
  return (bwd_resident(NP) ? 4 : 3) * sizeof(bf16) * kT * (32 * NP + 8) +
         sizeof(uint4) * kTcWarps * TERMS * kFragSlot;
}
__host__ __device__ constexpr size_t dkv_tc_smem(int NP, int TERMS) {
  return (bwd_resident(NP) ? 4 : 3) * sizeof(bf16) * kT * (32 * NP + 8) +
         sizeof(uint4) * kTcWarps * (1 + TERMS) * kFragSlot +
         sizeof(float) * 2 * kT;
}
static_assert(dq_tc_smem(10, 1) == 176128 && dkv_tc_smem(10, 1) == 184832 &&
                  dq_tc_smem(12, 2) == 217088 &&
                  dq_tc_smem(16, 2) == 216064 &&
                  dkv_tc_smem(12, 2) == 225792 &&
                  dkv_tc_smem(16, 2) == 224768,
              "the bf16 backward's tiles fit a block at every width");

// the low bf16 terms x − hi of an A fragment's eight values x (the C
// fragments of its two 8-column halves, as tc::a_from_c takes them) whose
// high terms `hi` a_from_c gave: hi + lo carries x to about 16 bits
__device__ __forceinline__ void a_lo_from_c(uint32_t (&lo)[4],
                                            const uint32_t (&hi)[4],
                                            const float (&c0)[4],
                                            const float (&c1)[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    lo[i] = tc::pack_bf16(x[2 * i] - __uint_as_float(hi[i] << 16),
                          x[2 * i + 1] - __uint_as_float(hi[i] & 0xffff0000u));
}

// c += A·Bᵀ for one warp over NS k-steps of 16 columns: A the 16 rows at
// the lane's ldmatrix address a, B the 32 rows (n along them) at b; c the
// 16 × 32 product, four 8-column tiles
template <int NS, int LD>
__device__ __forceinline__ void mma_16x32(float (&c)[4][4], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    uint32_t af[4], b0[4], b1[4];
    tc::ldsm_x4(af, a + tc::at(0, 16 * kk, LD));
    tc::ldsm_x4(b0, b + tc::at(0, 16 * kk, LD));
    tc::ldsm_x4(b1, b + tc::at(16, 16 * kk, LD));
    tc::mma(c[0], af, b0[0], b0[1]);
    tc::mma(c[1], af, b0[2], b0[3]);
    tc::mma(c[2], af, b1[0], b1[1]);
    tc::mma(c[3], af, b1[2], b1[3]);
  }
}

// acc += Σ_{F ≤ n < L} A_n·B for one warp: each A_n a 16 × 64 operand as
// four fragments (k-steps of 16 along the 64; several n: the bf16 terms of
// one operand, each B fragment loaded once for all), B a 64-row tile read
// transposed (k along its rows) at the lane's ldmatrix address b, NT
// 8-column tiles from the warp's first column; the 32-row halves of the 64
// not live are skipped
template <int NT, int LD, int F, int L, int N>
__device__ __forceinline__ void mma_out(float (&acc)[NT][4],
                                        const uint32_t (&a)[N][4][4],
                                        uint32_t b, bool live0, bool live1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (!(kk < 2 ? live0 : live1)) continue;
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t bb[4];
      tc::ldsm_x4_t(bb, b + tc::at(16 * kk, 16 * p, LD));
#pragma unroll
      for (int n = F; n < L; ++n) {
        tc::mma(acc[2 * p], a[n][kk], bb[0], bb[1]);
        tc::mma(acc[2 * p + 1], a[n][kk], bb[2], bb[3]);
      }
    }
    if constexpr (NT % 2 == 1) {          // a last single tile: the x4 load
      uint32_t bb[4];                     // reads 8 columns past it, inside
      tc::ldsm_x4_t(bb, b + tc::at(16 * kk, 16 * (NT / 2), LD));  // the row
#pragma unroll
      for (int n = F; n < L; ++n) tc::mma(acc[NT - 1], a[n][kk], bb[0], bb[1]);
    }
  }
}

// The pair's bf16 A fragments of N operands of 16 × 64: warp half h
// computed the 16 × 32 half h (fragments 2h, 2h + 1 of each, in `own`) and
// writes them to its slot, lane-major, 16 bytes a lane and fragment; after
// the pair barrier both warps read the live halves from the two slots, so
// both hold the same bits in the tile's order
template <int N>
__device__ __forceinline__ void pair_frags(uint32_t (&a)[N][4][4],
                                           const uint32_t (&own)[N][2][4],
                                           uint4* slots, int warp, int rg,
                                           int lane, bool live_own,
                                           bool live0, bool live1) {
  constexpr int S = N * kFragSlot;        // uint4 a warp's slot
  if (live_own) {
    uint4* mine = slots + warp * S + lane;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int f = 0; f < 2; ++f)
        mine[(2 * n + f) * 32] = make_uint4(own[n][f][0], own[n][f][1],
                                            own[n][f][2], own[n][f][3]);
  }
  pair_sync(rg);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!(hf == 0 ? live0 : live1)) continue;
    const uint4* src = slots + (rg + 4 * hf) * S + lane;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const uint4 x = src[(2 * n + f) * 32];
        a[n][2 * hf + f][0] = x.x;
        a[n][2 * hf + f][1] = x.y;
        a[n][2 * hf + f][2] = x.z;
        a[n][2 * hf + f][3] = x.w;
      }
  }
}

// two 16-row output fragments (rows row0 and row0 + 8 of acc's tiles, the
// warp's columns from col0, 8 a tile) times f, rounded to bf16, stored
// where they fall inside (rows, D)
template <int NT>
__device__ __forceinline__ void store_frags(bf16* out, const float (&acc)[NT][4],
                                            float f, int row0, int rows,
                                            int D, int col0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    bf16* orow = out + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      const float x0 = acc[j][2 * r] * f, x1 = acc[j][2 * r + 1] * f;
      if (D % 2 == 0) {                   // col even: 4-byte aligned pair
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) = tc::pack_bf16(x0, x1);
      } else {
        if (col < D) orow[col] = __float2bfloat16(x0);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// 64 fp32 values a q row (lse or delta) of the q-tile from row q0 into
// dst by threads 0..63, asynchronously; zero past S
__device__ __forceinline__ void stage_row_stats(float* dst, const float* src,
                                                int q0, int S, int tid) {
  if (tid < kT) {
    const bool ok = q0 + tid < S;
    tc::cp_async4(dst + tid, src + (ok ? q0 + tid : 0), ok);
  }
}

// dq on the tensor cores.  A block owns 64 query rows of one (b, h) and one
// output piece of W = 32·NP columns of dq (one piece up to D = 512); warp
// (rg, half) owns rows 16·rg.. and, of each k-tile, the keys 32·half..:
// it runs s = q·kᵀ and dp = dO·vᵀ for its 16 × 32 over the whole head dim,
// forms ds = p·(dp − delta) unscaled, rounds it to bf16 A fragments and
// trades them with its partner (warp rg + 4·(1 − half)), then accumulates
// dq += ds·k over all 64 keys for its half of the piece's columns (NP
// 16-column pairs).  So the scores run once per tile pair for any D ≤ 512.
// TERMS = 2 carries ds as two bf16 terms, hi + lo, each a product.
template <int NP, int TERMS>
__global__ void __launch_bounds__(kTcThreads, 1)
wide_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int Hq, int Hkv, int Sq, int Sk, int D, float scale,
                  int causal, int window, int pieces) {
  constexpr int W = 32 * NP;
  constexpr int LD = W + 8;
  constexpr bool kRes = bwd_resident(NP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);       // [64][LD] q
  bf16* dos = qs + kT * LD;                           // [64][LD] dO
  bf16* ks = dos + kT * LD;                           // [64][LD] k
  bf16* vs = kRes ? ks + kT * LD : ks;                // v (or k's turn)
  uint4* slots = reinterpret_cast<uint4*>(vs + kT * LD);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rg = warp & 3, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = gridDim.x / pieces;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / pieces) * kT;  // heaviest
                                                              // first
  const int c_out = ((int)blockIdx.x % pieces) * W;   // this output piece
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                      // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const bf16* qp = q + qoff * D;
  const bf16* dop = dout + qoff * D;
  const bf16* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bf16* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bool aligned = D % 8 == 0;
  const bool whole = pieces == 1;         // q and dO staged once a block
  const float sl2 = scale * tc::kLog2e;
  const int w_lo = q0 + 16 * rg, w_hi = w_lo + 15;    // this warp's rows
  // ldmatrix addresses: q and dO rows (A), this warp's 32 keys of k and v
  // (B), and k transposed at this warp's output columns
  const uint32_t qa = tc::smem_u32(qs) + tc::a_lane(lane, LD) +
                      tc::at(16 * rg, 0, LD);
  const uint32_t doa = tc::smem_u32(dos) + tc::a_lane(lane, LD) +
                       tc::at(16 * rg, 0, LD);
  const uint32_t kb = tc::smem_u32(ks) + tc::bn_lane(lane, LD) +
                      tc::at(32 * half, 0, LD);
  const uint32_t vb = tc::smem_u32(vs) + tc::bn_lane(lane, LD) +
                      tc::at(32 * half, 0, LD);
  const uint32_t kt = tc::smem_u32(ks) + tc::bk_lane(lane, LD) +
                      tc::at(0, 16 * NP * half, LD);

  float lse2[2], dl[2];                   // rows g and g + 8 (0 past Sq)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w_lo + g + 8 * r;
    lse2[r] = row < Sq ? lse[qoff + row] * tc::kLog2e : 0.f;
    dl[r] = row < Sq ? delta[qoff + row] : 0.f;
  }
  float acc[2 * NP][4];                   // dq, rows g and g + 8
#pragma unroll
  for (int j = 0; j < 2 * NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int n_kt_all = (Sk + kT - 1) / kT;
  const int n_kt = causal ? min(n_kt_all, (q0 + kT - 1) / kT + 1) : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / kT : 0;
  if (kRes) {
    stage_rows<W>(qs, qp, q0, Sq, D, 0, aligned, tid);
    stage_rows<W>(dos, dop, q0, Sq, D, 0, aligned, tid);
    stage_rows<W>(vs, vp, it0 * kT, Sk, D, 0, aligned, tid);
    tc::cp_async_commit();
    stage_rows<W>(ks, kp, it0 * kT, Sk, D, 0, aligned, tid);
    tc::cp_async_commit();
  } else if (whole) {
    stage_rows<W>(qs, qp, q0, Sq, D, 0, aligned, tid);
    stage_rows<W>(dos, dop, q0, Sq, D, 0, aligned, tid);
    tc::cp_async_commit();
  }

  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * kT;
    // which 32-key halves of the tile meet this warp's rows (the same for
    // both warps of the pair): causal, the window, keys and rows past Sk
    // and Sq
    bool live[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int c0 = k0 + 32 * c;
      live[c] = w_lo < Sq && c0 < Sk && (!causal || c0 <= w_hi) &&
                (window == 0 || c0 + 31 > w_lo - window);
    }
    const bool live_own = live[half];
    float s[4][4], dp[4][4];              // 16 rows × this warp's 32 keys
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if constexpr (kRes) {
      tc::cp_async_wait<1>();             // q, dO and this v have landed
      __syncthreads();
      if (live_own) mma_16x32<2 * NP, LD>(dp, doa, vb);
      tc::cp_async_wait<0>();             // this k has landed
      // k is visible; every warp is done with v: the next v loads while
      // the scores and dq run
      __syncthreads();
      if (it + 1 < n_kt) {
        stage_rows<W>(vs, vp, k0 + kT, Sk, D, 0, aligned, tid);
        tc::cp_async_commit();
      }
      if (live_own) mma_16x32<2 * NP, LD>(s, qa, kb);
    } else {
      // pieces of the head dim through the same tiles, v then k in turns
      for (int pc = 0; pc < pieces; ++pc) {
        __syncthreads();                  // the last reads of the tiles
        if (!whole) {
          stage_rows<W>(qs, qp, q0, Sq, D, pc * W, aligned, tid);
          stage_rows<W>(dos, dop, q0, Sq, D, pc * W, aligned, tid);
        }
        stage_rows<W>(vs, vp, k0, Sk, D, pc * W, aligned, tid);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        if (live_own) mma_16x32<2 * NP, LD>(dp, doa, vb);
        __syncthreads();                  // every warp is done with v
        stage_rows<W>(ks, kp, k0, Sk, D, pc * W, aligned, tid);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        if (live_own) mma_16x32<2 * NP, LD>(s, qa, kb);
      }
    }

    uint32_t a[TERMS][4][4];              // ds of the 16 rows × 64 keys
    if (live[0] || live[1]) {
      uint32_t own[TERMS][2][4];
      if (live_own) {
        // ds = p·(dp − delta), unscaled; p = 2^(s·scale·log2e − lse·log2e),
        // 0 where masked (the diagonal, the window, keys past Sk)
        const int c0 = k0 + 32 * half;
        const bool edge = c0 + 32 > Sk || (causal && c0 + 31 > w_lo) ||
                          (window > 0 && c0 <= w_hi - window);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float p = tc::ex2(fmaf(s[n][e], sl2, -lse2[r]));
            if (edge) {
              const int row = w_lo + g + 8 * r;
              const int col = c0 + 8 * n + 2 * t + (e & 1);
              if (col >= Sk || (causal && col > row) ||
                  (window > 0 && col <= row - window))
                p = 0.f;
            }
            s[n][e] = p * (dp[n][e] - dl[r]);
          }
        tc::a_from_c(own[0][0], s[0], s[1]);
        tc::a_from_c(own[0][1], s[2], s[3]);
        if constexpr (TERMS == 2) {
          a_lo_from_c(own[1][0], own[0][0], s[0], s[1]);
          a_lo_from_c(own[1][1], own[0][1], s[2], s[3]);
        }
      }
      pair_frags<TERMS>(a, own, slots, warp, rg, lane, live_own, live[0],
                        live[1]);
    }
    if constexpr (!kRes) {                // k at this block's output piece
      if (pieces > 1 && c_out != (pieces - 1) * W) {
        __syncthreads();
        stage_rows<W>(ks, kp, k0, Sk, D, c_out, aligned, tid);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
      }
    }
    // dq += ds · k over this warp's column pairs, k read transposed
    if (live[0] || live[1])
      mma_out<2 * NP, LD, 0, TERMS>(acc, a, kt, live[0], live[1]);
    if constexpr (kRes) {
      __syncthreads();                    // every warp is done with k
      if (it + 1 < n_kt) {
        stage_rows<W>(ks, kp, k0 + kT, Sk, D, 0, aligned, tid);
        tc::cp_async_commit();
      }
    }
  }

  store_frags<2 * NP>(dq + qoff * D, acc, scale, w_lo + g, Sq, D,
                      c_out + 16 * NP * half, t);
}

// dk and dv per query head on the tensor cores.  A block owns 64 keys of
// one (b, query head) and one output piece of 16·NP columns of dk and dv
// (two pieces up to D = 512, ceil(D / 256) above); warp (kg, half) owns
// keys 16·kg.. and, of each q-tile, the rows 32·half..: it runs the
// transposed products sᵀ = k·qᵀ and dpᵀ = v·dOᵀ for its 16 × 32 over the
// whole head dim, so pᵀ and dsᵀ come out in the accumulator layout, with a
// q row's lse and delta indexed by the fragment's column; rounded to bf16
// A fragments and traded with its partner, they feed dv += pᵀ·dO and dk
// += dsᵀ·q over all 64 rows for its half of the piece's columns (NP
// 8-column tiles), dO and q read transposed.  Each output piece recomputes
// the scores: two score computations a tile pair up to D = 512.  TERMS = 2
// carries dsᵀ as two bf16 terms, hi + lo, each a product (p keeps one).
template <int NP, int TERMS>
__global__ void __launch_bounds__(kTcThreads, 1)
wide_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk_h,
                   bf16* __restrict__ dv_h, int Hq, int Hkv, int Sq, int Sk,
                   int D, float scale, int causal, int window, int pieces) {
  constexpr int W = 32 * NP;              // columns of a score piece
  constexpr int LD = W + 8;
  constexpr int WO = 16 * NP;             // columns of an output piece
  constexpr bool kRes = bwd_resident(NP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // k and v (the block's, restaged for each score piece above 512
  // columns), q and dO (the q-tile's; above 384 columns taking turns in
  // one tile, q and dO at the output piece restaged into it)
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kT * LD;
  bf16* qs = vs + kT * LD;
  bf16* dos = kRes ? qs + kT * LD : qs;
  uint4* slots = reinterpret_cast<uint4*>(dos + kT * LD);
  float* ls = reinterpret_cast<float*>(slots +
                                      kTcWarps * (1 + TERMS) * kFragSlot);
  float* dls = ls + kT;                   // the q-tile's lse and delta

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int kg = warp & 3, half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = ((int)blockIdx.x / pieces) * kT;     // causal: heaviest
                                                      // first
  const int c_out = ((int)blockIdx.x % pieces) * WO;  // this output piece
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const bf16* qp = q + qoff * D;
  const bf16* dop = dout + qoff * D;
  const float* lp = lse + qoff;
  const float* dlp = delta + qoff;
  const bf16* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bf16* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bool aligned = D % 8 == 0;
  const int score_pieces = (D + W - 1) / W;           // 1 when resident
  const float sl2 = scale * tc::kLog2e;
  const int k_lo = k0 + 16 * kg, k_hi = k_lo + 15;    // this warp's keys
  // ldmatrix addresses: this warp's keys of k and v (A), its 32 rows of q
  // and dO (B), and q and dO transposed at its output columns (the
  // piece's columns of the whole rows, or of the restaged piece)
  const uint32_t ka = tc::smem_u32(ks) + tc::a_lane(lane, LD) +
                      tc::at(16 * kg, 0, LD);
  const uint32_t va = tc::smem_u32(vs) + tc::a_lane(lane, LD) +
                      tc::at(16 * kg, 0, LD);
  const uint32_t qb = tc::smem_u32(qs) + tc::bn_lane(lane, LD) +
                      tc::at(32 * half, 0, LD);
  const uint32_t dob = tc::smem_u32(dos) + tc::bn_lane(lane, LD) +
                       tc::at(32 * half, 0, LD);
  const int c_q = (score_pieces == 1 ? c_out : 0) + 8 * NP * half;
  const int c_do = (kRes ? c_out : 0) + 8 * NP * half;
  const uint32_t qt = tc::smem_u32(qs) + tc::bk_lane(lane, LD) +
                      tc::at(0, c_q, LD);
  const uint32_t dot = tc::smem_u32(dos) + tc::bk_lane(lane, LD) +
                       tc::at(0, c_do, LD);

  float dk[NP][4], dv[NP][4];             // keys g and g + 8
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  // causal: q-tiles whose last row lies before this k-tile are skipped;
  // window: so are those starting past its last key's last row
  const int n_qt = window > 0
      ? min((Sq + kT - 1) / kT, (k0 + kT - 1 + window - 1) / kT + 1)
      : (Sq + kT - 1) / kT;
  const int qi0 = causal ? k0 / kT : 0;
  if (kRes) {
    stage_rows<W>(ks, kp, k0, Sk, D, 0, aligned, tid);
    stage_rows<W>(vs, vp, k0, Sk, D, 0, aligned, tid);
    stage_rows<W>(dos, dop, qi0 * kT, Sq, D, 0, aligned, tid);
    stage_row_stats(dls, dlp, qi0 * kT, Sq, tid);
    tc::cp_async_commit();
    stage_rows<W>(qs, qp, qi0 * kT, Sq, D, 0, aligned, tid);
    stage_row_stats(ls, lp, qi0 * kT, Sq, tid);
    tc::cp_async_commit();
  } else if (score_pieces == 1) {
    stage_rows<W>(ks, kp, k0, Sk, D, 0, aligned, tid);
    stage_rows<W>(vs, vp, k0, Sk, D, 0, aligned, tid);
    tc::cp_async_commit();
  }

  for (int qi = qi0; qi < n_qt; ++qi) {
    const int q0 = qi * kT;
    // which 32-row halves of the q-tile meet this warp's keys (the same
    // for both warps of the pair)
    bool live[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r0 = q0 + 32 * c;
      live[c] = r0 < Sq && k_lo < Sk && (!causal || r0 + 31 >= k_lo) &&
                (window == 0 || r0 - k_hi < window);
    }
    const bool live_own = live[half];
    float st[4][4], dpt[4][4];            // 16 keys × this warp's 32 rows
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    if constexpr (kRes) {
      tc::cp_async_wait<1>();             // k, v, this dO and delta landed
      __syncthreads();
      if (live_own) mma_16x32<2 * NP, LD>(dpt, va, dob);
      tc::cp_async_wait<0>();             // this q and lse have landed
      __syncthreads();
      if (live_own) mma_16x32<2 * NP, LD>(st, ka, qb);
    } else {
      // pieces of the head dim: dO, then q, in turns in one tile
      for (int pc = 0; pc < score_pieces; ++pc) {
        __syncthreads();                  // the last reads of the tiles
        if (score_pieces > 1) {
          stage_rows<W>(ks, kp, k0, Sk, D, pc * W, aligned, tid);
          stage_rows<W>(vs, vp, k0, Sk, D, pc * W, aligned, tid);
        }
        stage_rows<W>(dos, dop, q0, Sq, D, pc * W, aligned, tid);
        if (pc == 0) {
          stage_row_stats(ls, lp, q0, Sq, tid);
          stage_row_stats(dls, dlp, q0, Sq, tid);
        }
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        if (live_own) mma_16x32<2 * NP, LD>(dpt, va, dob);
        __syncthreads();                  // every warp is done with dO
        stage_rows<W>(qs, qp, q0, Sq, D, pc * W, aligned, tid);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
        if (live_own) mma_16x32<2 * NP, LD>(st, ka, qb);
      }
    }

    uint32_t a[1 + TERMS][4][4];          // pᵀ, dsᵀ: 16 keys × 64 rows
    if (live[0] || live[1]) {
      uint32_t own[1 + TERMS][2][4];
      if (live_own) {
        // pᵀ, and dsᵀ = pᵀ·(dpᵀ − delta) unscaled, masked on the diagonal,
        // the window and rows past Sq; a q row's lse and delta by column
        const int r0 = q0 + 32 * half;
        const bool edge = r0 + 32 > Sq || (causal && k_hi > r0) ||
                          (window > 0 && r0 + 31 - k_lo >= window);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qr = 32 * half + 8 * n + 2 * t + c;  // row in tile
            const float l2 = ls[qr] * tc::kLog2e, dlt = dls[qr];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int e = 2 * rr + c;
              float p = tc::ex2(fmaf(st[n][e], sl2, -l2));
              if (edge) {
                const int key = k_lo + g + 8 * rr;
                const int row = q0 + qr;
                if (row >= Sq || (causal && key > row) ||
                    (window > 0 && key <= row - window))
                  p = 0.f;
              }
              st[n][e] = p;
              dpt[n][e] = p * (dpt[n][e] - dlt);
            }
          }
        tc::a_from_c(own[0][0], st[0], st[1]);
        tc::a_from_c(own[0][1], st[2], st[3]);
        tc::a_from_c(own[1][0], dpt[0], dpt[1]);
        tc::a_from_c(own[1][1], dpt[2], dpt[3]);
        if constexpr (TERMS == 2) {
          a_lo_from_c(own[2][0], own[1][0], dpt[0], dpt[1]);
          a_lo_from_c(own[2][1], own[1][1], dpt[2], dpt[3]);
        }
      }
      pair_frags<1 + TERMS>(a, own, slots, warp, kg, lane, live_own,
                            live[0], live[1]);
    }
    if constexpr (kRes) {
      // dv += pᵀ · dO; then dO and delta are free: the next q-tile's load
      // while dk += dsᵀ · q runs; then q and lse
      if (live[0] || live[1])
        mma_out<NP, LD, 0, 1>(dv, a, dot, live[0], live[1]);
      __syncthreads();
      if (qi + 1 < n_qt) {
        stage_rows<W>(dos, dop, q0 + kT, Sq, D, 0, aligned, tid);
        stage_row_stats(dls, dlp, q0 + kT, Sq, tid);
        tc::cp_async_commit();
      }
      if (live[0] || live[1])
        mma_out<NP, LD, 1, 1 + TERMS>(dk, a, qt, live[0], live[1]);
      __syncthreads();
      if (qi + 1 < n_qt) {
        stage_rows<W>(qs, qp, q0 + kT, Sq, D, 0, aligned, tid);
        stage_row_stats(ls, lp, q0 + kT, Sq, tid);
        tc::cp_async_commit();
      }
    } else {
      // dk += dsᵀ · q, q at this block's output piece (restaged where the
      // tile holds another piece); then dO's piece over it, dv += pᵀ · dO
      if (score_pieces > 1) {
        __syncthreads();
        stage_rows<WO, LD>(qs, qp, q0, Sq, D, c_out, aligned, tid);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
      }
      if (live[0] || live[1])
        mma_out<NP, LD, 1, 1 + TERMS>(dk, a, qt, live[0], live[1]);
      __syncthreads();                    // every warp is done with q
      stage_rows<WO, LD>(dos, dop, q0, Sq, D, c_out, aligned, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
      if (live[0] || live[1])
        mma_out<NP, LD, 0, 1>(dv, a, dot, live[0], live[1]);
    }
  }

  const size_t koff = (size_t)(b * Hq + h) * Sk;   // this head's dk_h rows
  const int col0 = c_out + 8 * NP * half;
  store_frags<NP>(dk_h + koff * D, dk, scale, k_lo + g, Sk, D, col0, t);
  store_frags<NP>(dv_h + koff * D, dv, 1.f, k_lo + g, Sk, D, col0, t);
}

// ---- fp32 on the CUDA cores --------------------------------------------------

// 256 threads a block.  The score products run in the two halves of the
// block (warps 0–3, 4–7), each a 64 × 64 product at an 8 × 4 tile a
// thread: rows ty + 8i, keys tx + 16j (ty < 8, tx < 16; a warp's lanes 4
// rows × 8 keys).  The accumulating products run over the whole block at
// a 4-row tile a thread: rows rg + 16i of the tile (rg < 16) by the
// float4 column groups 4·cg + 64j of its piece (cg < 16, j < G; a warp's
// lanes 4 row groups × 8 column groups).
//
// Every load goes through one ring of kStages slots, a step a slot: a
// tile pair is nch score steps (a chunk of D of each score operand), then
// 4 accumulating steps (16 rows of the accumulating operand's piece: v's,
// k's, dO's or q's rows of the other tile).  Step g + kStages − 1 loads
// while step g computes, so loads run through both phases.
constexpr int kF32Threads = 256;
constexpr int kLdS = kT + 8;              // [64][72] score tiles (≡ 8 mod 32)
constexpr int kTileS = kT * kLdS;
constexpr int kFwdCols = 32;              // forward, dv: q and k columns a step
constexpr int kBwdCols = 16;              // dq, dk: q, k, dO, v columns a step
constexpr int kRowStep = 16;              // rows of an accumulating step
constexpr int kAccSteps = kT / kRowStep;
constexpr int kStages = 4;                // ring slots
constexpr int kAhead = kStages - 1;       // steps in flight
constexpr int kMaxCluster = 8;            // portable cluster size

// The pieces of one tile form a thread-block cluster (up to kMaxCluster):
// each block runs the score products over its own piece's columns only,
// and every block adds all the cluster's partial tiles in one order
// through distributed shared memory, so the scores of a tile pair run
// once whatever D.  Above kMaxCluster pieces each block runs them over
// all of D.
__host__ __device__ constexpr bool f32_clustered(int pieces) {
  return pieces > 1 && pieces <= kMaxCluster;
}

// the columns of D a block's score products run over: its piece's where
// the pieces form a cluster, else all of D
struct F32Cols {
  int lo, n;
};
__device__ __forceinline__ F32Cols f32_cols(int pieces, int c0, int W,
                                            int D) {
  return f32_clustered(pieces) ? F32Cols{c0, min(W, D - c0)}
                               : F32Cols{0, D};
}

// Σ over the cluster's ranks (in rank order) of rank r's t[i], from a
// pointer into this block's shared memory; this block's alone outside a
// cluster
__device__ __forceinline__ float f32_cluster_sum(const float* t, int pieces) {
  if (!f32_clustered(pieces)) return *t;
  cg::cluster_group cluster = cg::this_cluster();
  float x = 0.f;
  for (int r = 0; r < pieces; ++r) x += *cluster.map_shared_rank(t, r);
  return x;
}

// every block of the cluster has reached this point (its shared memory
// writes visible to the others); nothing outside a cluster
__device__ __forceinline__ void f32_cluster_sync(int pieces) {
  if (f32_clustered(pieces)) cg::this_cluster().sync();
}

// row stride of a staged tile of W columns: ≡ 4 mod 32 floats for the
// score chunks (W = 32; 20 for W = 16), so the 8 rows one warp reads at a
// column lie in 8 distinct 16-byte bank groups; W + 4 for a piece too
__host__ __device__ constexpr int f32_ld(int W) { return W + 4; }

// floats of a ring slot: a score step's operand chunks or 16 rows of a
// piece of 64·G columns, whichever is larger
__host__ __device__ constexpr int f32_slot(int G) {
  return 4 * kT * f32_ld(kBwdCols) > kRowStep * f32_ld(64 * G)
             ? 4 * kT * f32_ld(kBwdCols)
             : kRowStep * f32_ld(64 * G);
}
static_assert(2 * kT * f32_ld(kFwdCols) <= 4 * kT * f32_ld(kBwdCols),
              "a forward score step fits a slot");

// shared memory a block: the ring, the two score tiles and the row
// statistics (the forward's running max, sum and rescale; the backward's
// lse and delta)
__host__ __device__ constexpr size_t f32_fwd_smem(int G) {
  return sizeof(float) * (kStages * f32_slot(G) + 2 * kTileS + 3 * kT);
}
__host__ __device__ constexpr size_t f32_bwd_smem(int G) {  // dq and dk/dv
  return sizeof(float) * (kStages * f32_slot(G) + 2 * kTileS + 2 * kT);
}
static_assert(f32_fwd_smem(8) == 169728 && f32_bwd_smem(8) == 169472 &&
                  f32_fwd_smem(8) <= kSmemOptIn,
              "the fp32 wide kernels' widest pieces fit a block");
static_assert(kAhead <= kAccSteps, "the next tile's first score step, and "
              "the dk/dv kernel's lse and delta with it, load after the "
              "last one's elementwise phase");

// Rows r0..r0+R−1 (zero past S), columns c0..c0+W−1 (zero past D) of a
// contiguous (S, D) fp32 matrix into an [R][f32_ld(W)] tile, by cp.async,
// which the caller commits and waits for: 16 bytes a copy where rows are
// 16-byte aligned, else one element.
template <int R, int W>
__device__ __forceinline__ void f32_copy(float* dst, const float* src, int r0,
                                         int S, int D, int c0, bool aligned,
                                         int tid) {
  constexpr int LD = f32_ld(W);
  if (aligned) {
    constexpr int N4 = W / 4;
#pragma unroll 4
    for (int u = tid; u < R * N4; u += kF32Threads) {
      const int r = u / N4, c = 4 * (u % N4);
      const bool ok = r0 + r < S && c0 + c < D;
      tc::cp_async16(dst + r * LD + c,
                     src + (ok ? (size_t)(r0 + r) * D + c0 + c : 0), ok);
    }
  } else {
    for (int u = tid; u < R * W; u += kF32Threads) {
      const int r = u / W, c = u % W;
      const bool ok = r0 + r < S && c0 + c < D;
      tc::cp_async4(dst + r * LD + c,
                    src + (ok ? (size_t)(r0 + r) * D + c0 + c : 0), ok);
    }
  }
}

__device__ __forceinline__ float f4(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// s[i][j] += Σ_{d < 16} x[ty + 8i][d] · y[tx + 16j][d], x and y at the
// half's first column of two staged tiles of row stride LD, d ascending
template <int LD>
__device__ __forceinline__ void f32_scores(float (&s)[8][4], const float* x,
                                           const float* y, int ty, int tx) {
#pragma unroll
  for (int d = 0; d < 16; d += 4) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(y + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(x + (ty + 8 * i) * LD
                                                        + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(f4(a, e), f4(b[j], e), s[i][j]);
    }
  }
}

// a half's scores into its [64][kLdS] tile
__device__ __forceinline__ void f32_put_scores(float* t, const float (&s)[8][4],
                                               int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[(ty + 8 * i) * kLdS + tx + 16 * j] = s[i][j];
}

// acc[i][j][e] += Σ_{κ < 16} w[rg + 16i][κ] · z[κ][4·cg + 64j + e]: w the
// step's 16 columns of a [64][kLdS] tile (p or ds, a row a query or a
// key), z 16 rows of a piece of 64·G columns; κ ascending
template <int G>
__device__ __forceinline__ void f32_accumulate(float (&acc)[4][G][4],
                                               const float* w, const float* z,
                                               int rg, int cg) {
  constexpr int LZ = f32_ld(64 * G);
#pragma unroll
  for (int kk = 0; kk < kRowStep; kk += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(w + (rg + 16 * i) * kLdS + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(
            z + (kk + u) * LZ + 4 * cg + 64 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float wv = f4(a[i], u);
          acc[i][j][0] = fmaf(wv, b.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(wv, b.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(wv, b.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(wv, b.w, acc[i][j][3]);
        }
      }
  }
}

// rows r0 + rg + 16i (below `rows`) and columns c0 + 4·cg + 64j (below D)
// of an accumulator, each row divided by div[i] (o = acc / l) or not
template <int G>
__device__ __forceinline__ void f32_store(float* out, const float (&acc)[4][G][4],
                                          const float* div, int r0, int rows,
                                          int D, int c0, bool aligned, int rg,
                                          int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg + 16 * i;
    if (row >= rows) continue;
    float* o = out + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int col = c0 + 4 * cg + 64 * j;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = div != nullptr ? acc[i][j][e] / div[i] : acc[i][j][e];
      if (aligned) {
        if (col < D)
          *reinterpret_cast<float4*>(o + col) = make_float4(x[0], x[1], x[2],
                                                            x[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < D) o[col + e] = x[e];
      }
    }
  }
}

__device__ __forceinline__ bool f32_aligned(int D, const void* a,
                                            const void* b, const void* c,
                                            const void* d) {
  return D % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(d)) & 15) == 0;
}

// wait for step g's loads (all but the kAhead − 1 groups after it), make
// them visible, and issue step g + kAhead into the slot every warp is done
// with (step g − 1's)
template <typename Issue>
__device__ __forceinline__ void f32_next_step(int g, Issue& issue) {
  tc::cp_async_wait<kAhead - 1>();
  __syncthreads();
  issue(g + kAhead);
  tc::cp_async_commit();
}

// The fp32 forward.  G: float4 column groups of o a thread holds, so a
// piece of o is 64·G columns (zero past D); the block owns one q-tile and
// one piece and walks the k-tiles.
template <int G>
__global__ void __launch_bounds__(kF32Threads, 1)
wide_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                    int D, float scale, int causal, int window, int pieces) {
  constexpr int W = 64 * G;                   // columns of a piece
  constexpr int CW = kFwdCols, LR = f32_ld(CW);
  constexpr int kSlot = f32_slot(G);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                         // [kStages][kSlot]: q, k
                                              // [64][LR]; or v [16][W + 4]
  float* sp = ring + kStages * kSlot;         // [2][64][kLdS] the halves'
                                              // partial scores; p over the
                                              // first
  float* alpha_s = sp + 2 * kTileS;           // [64] a tile's rescale
  float* m_s = alpha_s + kT;                  // [64] running max
  float* l_s = m_s + kT;                      // [64] running sum

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int half = warp >> 2, wl = warp & 3;
  const int ty = (wl >> 1) * 4 + (lane >> 3), tx = (wl & 1) * 8 + (lane & 7);
  const int rg = (warp >> 1) * 4 + (lane >> 3), cg = (warp & 1) * 8 + (lane & 7);
  const int n_qt = gridDim.x / pieces;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / pieces) * kT;  // heaviest
                                                              // first
  const int c0 = ((int)blockIdx.x % pieces) * W;      // this output piece
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                      // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const float* qp = q + qoff * D;
  const float* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bool aligned = f32_aligned(D, q, k, v, o);
  const F32Cols cols = f32_cols(pieces, c0, W, D);
  const int nch = (cols.n + CW - 1) / CW;     // score steps a tile pair
  const int nsteps = nch + kAccSteps;

  const int n_kt_all = (Sk + kT - 1) / kT;
  // causal: k-tiles starting past this q-tile's last row are skipped;
  // window: so are those ending before its first row's window
  const int n_kt = causal ? min(n_kt_all, (q0 + kT - 1) / kT + 1) : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / kT : 0;
  const int total = (n_kt - it0) * nsteps;

  auto issue = [&](int g) {                   // the loads of step g
    if (g >= total) return;
    float* slot = ring + (g % kStages) * kSlot;
    const int k0 = (it0 + g / nsteps) * kT, j = g % nsteps;
    if (j < nch) {                            // q's and k's chunk j
      const int d0 = cols.lo + j * CW;
      f32_copy<kT, CW>(slot, qp, q0, Sq, D, d0, aligned, tid);
      f32_copy<kT, CW>(slot + kT * LR, kp, k0, Sk, D, d0, aligned, tid);
    } else {                                  // 16 rows of v's piece
      f32_copy<kRowStep, W>(slot, vp, k0 + kRowStep * (j - nch), Sk, D, c0,
                            aligned, tid);
    }
  };

  if (tid < kT) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][G][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int g = 0; g < kAhead; ++g) {
    issue(g);
    tc::cp_async_commit();
  }
  int g = 0;
  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * kT;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // s = q·kᵀ once a tile pair, each half over half of every chunk
    for (int j = 0; j < nch; ++j, ++g) {
      f32_next_step(g, issue);
      const float* st = ring + (g % kStages) * kSlot + 16 * half;
      f32_scores<LR>(s, st, st + kT * LR, ty, tx);
    }
    f32_put_scores(sp + half * kTileS, s, ty, tx);
    __syncthreads();
    f32_cluster_sync(pieces);                 // every piece's partials
    // the online softmax: warp w the rows 8w.. (the 8 side by side), a
    // lane keys lane and lane + 32
    {
      float x[8][2], mt[8], rs[8], m_old[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int rr = 8 * warp + r;
        mt[r] = kNegInf;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = lane + 32 * e;
          const float sv = f32_cluster_sum(sp + rr * kLdS + c, pieces) +
                           f32_cluster_sum(sp + kTileS + rr * kLdS + c,
                                           pieces);
          x[r][e] = in_band(q0 + rr, k0 + c, Sk, causal, window)
                        ? sv * scale : kNegInf;
          mt[r] = fmaxf(mt[r], x[r][e]);
        }
        m_old[r] = m_s[rr];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], off));
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        mt[r] = fmaxf(m_old[r], mt[r]);         // the new running max
        rs[r] = 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[r][e] = expf(x[r][e] - mt[r]);
          rs[r] += x[r][e];
        }
      }
      f32_cluster_sync(pieces);               // every piece has read ours
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sp[(8 * warp + r) * kLdS + lane + 32 * e] = x[r][e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < 8; ++r)
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], off);
      __syncwarp();                           // every lane has read m_s
      if (lane < 8) {
        float m_new = 0.f, sum = 0.f, mo = 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r == lane) {
            m_new = mt[r];
            sum = rs[r];
            mo = m_old[r];
          }
        const int rr = 8 * warp + lane;
        const float alpha = expf(mo - m_new);
        alpha_s[rr] = alpha;
        l_s[rr] = alpha * l_s[rr] + sum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();                          // p and alpha are ready
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = alpha_s[rg + 16 * i];
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
    }
    // o += p·v, 16 keys a step
    for (int c = 0; c < kAccSteps; ++c, ++g) {
      f32_next_step(g, issue);
      f32_accumulate<G>(acc, sp + kRowStep * c,
                        ring + (g % kStages) * kSlot, rg, cg);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();                            // l_s and m_s of every row

  float lsafe[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = l_s[rg + 16 * i];
    lsafe[i] = l == 0.f ? 1.f : l;
  }
  f32_store<G>(o + qoff * D, acc, lsafe, q0, Sq, D, c0, aligned, rg, cg);
  // m and l are the same in every piece; the first writes lse
  if (lse != nullptr && c0 == 0 && tid < kT && q0 + tid < Sq) {
    const float l = l_s[tid];
    lse[qoff + q0 + tid] = m_s[tid] + logf(l == 0.f ? 1.f : l);
  }
}

// The fp32 dq kernel: the block owns one q-tile and one 64·G-column piece
// of dq and walks the k-tiles; half 0 runs s = q·kᵀ, half 1 dp = dO·vᵀ,
// each over all of D once a tile pair; then dq += ds·k over k's piece.
template <int G>
__global__ void __launch_bounds__(kF32Threads, 1)
wide_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int Hq, int Hkv, int Sq, int Sk, int D, float scale,
                   int causal, int window, int pieces) {
  constexpr int W = 64 * G;
  constexpr int CW = kBwdCols, LR = f32_ld(CW);
  constexpr int kSlot = f32_slot(G);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                         // [kStages][kSlot]: q, k, dO,
                                              // v [64][LR]; or k [16][W + 4]
  float* sp = ring + kStages * kSlot;         // [2][64][kLdS] s, dp; ds over s
  float* lse_s = sp + 2 * kTileS;             // [64]
  float* delta_s = lse_s + kT;                // [64]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int half = warp >> 2, wl = warp & 3;
  const int ty = (wl >> 1) * 4 + (lane >> 3), tx = (wl & 1) * 8 + (lane & 7);
  const int rg = (warp >> 1) * 4 + (lane >> 3), cg = (warp & 1) * 8 + (lane & 7);
  const int n_qt = gridDim.x / pieces;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / pieces) * kT;  // heaviest
                                                              // first
  const int c0 = ((int)blockIdx.x % pieces) * W;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const float* qp = q + qoff * D;
  const float* dop = dout + qoff * D;
  const float* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bool aligned = f32_aligned(D, q, k, v, dout) &&
                       f32_aligned(D, dq, dq, dq, dq);
  const F32Cols cols = f32_cols(pieces, c0, W, D);
  const int nch = (cols.n + CW - 1) / CW;
  const int nsteps = nch + kAccSteps;

  const int n_kt_all = (Sk + kT - 1) / kT;
  const int n_kt = causal ? min(n_kt_all, (q0 + kT - 1) / kT + 1) : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / kT : 0;
  const int total = (n_kt - it0) * nsteps;

  auto issue = [&](int g) {
    if (g >= total) return;
    float* slot = ring + (g % kStages) * kSlot;
    const int k0 = (it0 + g / nsteps) * kT, j = g % nsteps;
    if (j < nch) {
      const int d0 = cols.lo + j * CW;
      f32_copy<kT, CW>(slot, qp, q0, Sq, D, d0, aligned, tid);
      f32_copy<kT, CW>(slot + kT * LR, kp, k0, Sk, D, d0, aligned, tid);
      f32_copy<kT, CW>(slot + 2 * kT * LR, dop, q0, Sq, D, d0, aligned, tid);
      f32_copy<kT, CW>(slot + 3 * kT * LR, vp, k0, Sk, D, d0, aligned, tid);
    } else {                                  // 16 rows of k's piece
      f32_copy<kRowStep, W>(slot, kp, k0 + kRowStep * (j - nch), Sk, D, c0,
                            aligned, tid);
    }
  };

  if (tid < kT) {
    const bool ok = q0 + tid < Sq;
    lse_s[tid] = ok ? lse[qoff + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
  }
  float acc[4][G][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int g = 0; g < kAhead; ++g) {
    issue(g);
    tc::cp_async_commit();
  }
  int g = 0;
  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * kT;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int j = 0; j < nch; ++j, ++g) {
      f32_next_step(g, issue);
      const float* st = ring + (g % kStages) * kSlot + 2 * half * kT * LR;
      f32_scores<LR>(s, st, st + kT * LR, ty, tx);
    }
    f32_put_scores(sp + half * kTileS, s, ty, tx);
    __syncthreads();
    f32_cluster_sync(pieces);                 // every piece's partials
    // ds = p·(dp − delta)·scale, p = exp(s·scale − lse), 0 where masked
    float ds[kT * kT / kF32Threads];
#pragma unroll
    for (int n = 0; n < kT * kT / kF32Threads; ++n) {
      const int e = tid + n * kF32Threads;
      const int r = e / kT, c = e % kT;
      const int row = q0 + r;
      const float* x = sp + r * kLdS + c;
      const float p = row < Sq && in_band(row, k0 + c, Sk, causal, window)
                          ? expf(f32_cluster_sum(x, pieces) * scale -
                                 lse_s[r])
                          : 0.f;
      ds[n] = p * (f32_cluster_sum(x + kTileS, pieces) - delta_s[r]) * scale;
    }
    f32_cluster_sync(pieces);                 // every piece has read ours
#pragma unroll
    for (int n = 0; n < kT * kT / kF32Threads; ++n) {
      const int e = tid + n * kF32Threads;
      sp[(e / kT) * kLdS + e % kT] = ds[n];
    }
    // dq += ds·k, 16 keys a step (the step's barrier publishes ds)
    for (int c = 0; c < kAccSteps; ++c, ++g) {
      f32_next_step(g, issue);
      f32_accumulate<G>(acc, sp + kRowStep * c,
                        ring + (g % kStages) * kSlot, rg, cg);
    }
  }
  tc::cp_async_wait<0>();
  f32_store<G>(dq + qoff * D, acc, nullptr, q0, Sq, D, c0, aligned, rg, cg);
}

// The fp32 dk/dv kernel, per query head: the block owns one k-tile and
// one 64·G-column piece of dv (the first `pieces` blocks of the k-tile)
// or of dk (the next `pieces`), and walks the q-tiles.  dv = Σ pᵀ·dO needs
// only sᵀ = k·qᵀ: the two halves each take half of a 32-column chunk of k
// and q and add their partial scores, as the forward does.  dk = Σ dsᵀ·q
// needs dpᵀ = v·dOᵀ too: half 0 runs sᵀ, half 1 dpᵀ over 16-column chunks
// of k, q, v and dO.  Either way the scores run once a tile pair and
// piece, and a thread holds one accumulator, 16·G fp32.
template <int G>
__global__ void __launch_bounds__(kF32Threads, 1)
wide_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk_h,
                    float* __restrict__ dv_h, int Hq, int Hkv, int Sq,
                    int Sk, int D, float scale, int causal, int window,
                    int pieces) {
  constexpr int W = 64 * G;
  constexpr int CW = kBwdCols, LR = f32_ld(CW);
  constexpr int kSlot = f32_slot(G);
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                         // [kStages][kSlot]: four
                                              // [64][LR] operand chunks (dv:
                                              // k, q at columns 32j.., k, q
                                              // at 32j + 16..; dk: k, q, v,
                                              // dO); or dO's or q's
                                              // [16][W + 4]
  float* sp = ring + kStages * kSlot;         // [2][64][kLdS] the halves'
                                              // scores; pᵀ or dsᵀ over the
                                              // first
  float* lse_s = sp + 2 * kTileS;             // [64] the q-tile's
  float* delta_s = lse_s + kT;                // [64]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int half = warp >> 2, wl = warp & 3;
  const int ty = (wl >> 1) * 4 + (lane >> 3), tx = (wl & 1) * 8 + (lane & 7);
  const int rg = (warp >> 1) * 4 + (lane >> 3), cg = (warp & 1) * 8 + (lane & 7);
  const int k0 = ((int)blockIdx.x / (2 * pieces)) * kT;   // causal:
                                                          // heaviest first
  const int role = (int)blockIdx.x % (2 * pieces);
  const bool dk_role = role >= pieces;
  const int c0 = (role % pieces) * W;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const float* qp = q + qoff * D;
  const float* dop = dout + qoff * D;
  const float* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float* ap = dk_role ? qp : dop;       // the accumulating operand
  const bool aligned = f32_aligned(D, q, k, v, dout) &&
                       f32_aligned(D, dk_h, dv_h, dk_h, dv_h);
  const int cw = dk_role ? CW : 2 * CW;       // columns of D a score step
  const F32Cols cols = f32_cols(pieces, c0, W, D);
  const int nch = (cols.n + cw - 1) / cw;
  const int nsteps = nch + kAccSteps;

  // causal: q-tiles whose last row lies before this k-tile are skipped;
  // window: so are those starting past its last key's last row
  const int n_qt = window > 0
      ? min((Sq + kT - 1) / kT, (k0 + kT - 1 + window - 1) / kT + 1)
      : (Sq + kT - 1) / kT;
  const int qi0 = causal ? k0 / kT : 0;
  const int total = (n_qt - qi0) * nsteps;

  auto issue = [&](int g) {
    if (g >= total) return;
    float* slot = ring + (g % kStages) * kSlot;
    const int q0 = (qi0 + g / nsteps) * kT, j = g % nsteps;
    if (j < nch) {
      const int d0 = cols.lo + j * cw;
      f32_copy<kT, CW>(slot, kp, k0, Sk, D, d0, aligned, tid);
      f32_copy<kT, CW>(slot + kT * LR, qp, q0, Sq, D, d0, aligned, tid);
      f32_copy<kT, CW>(slot + 2 * kT * LR, dk_role ? vp : kp, k0, Sk, D,
                       d0 + (dk_role ? 0 : CW), aligned, tid);
      f32_copy<kT, CW>(slot + 3 * kT * LR, dk_role ? dop : qp, q0, Sq, D,
                       d0 + (dk_role ? 0 : CW), aligned, tid);
      if (j == 0 && tid < 2 * kT) {           // the q-tile's lse and delta
        const int r = tid & (kT - 1);
        const bool ok = q0 + r < Sq;
        const float* src = (tid < kT ? lse : delta) + qoff + (ok ? q0 + r : 0);
        tc::cp_async4((tid < kT ? lse_s : delta_s) + r, src, ok);
      }
    } else {                                  // 16 rows of dO's or q's piece
      f32_copy<kRowStep, W>(slot, ap, q0 + kRowStep * (j - nch), Sq, D, c0,
                            aligned, tid);
    }
  };

  float acc[4][G][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int g = 0; g < kAhead; ++g) {
    issue(g);
    tc::cp_async_commit();
  }
  int g = 0;
  for (int qi = qi0; qi < n_qt; ++qi) {
    const int q0 = qi * kT;
    float s[8][4];                            // [key ty + 8i][query tx + 16j]
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int j = 0; j < nch; ++j, ++g) {
      f32_next_step(g, issue);
      const float* st = ring + (g % kStages) * kSlot + 2 * half * kT * LR;
      f32_scores<LR>(s, st, st + kT * LR, ty, tx);
    }
    f32_put_scores(sp + half * kTileS, s, ty, tx);
    __syncthreads();
    f32_cluster_sync(pieces);                 // every piece's partials
    // pᵀ (dv) or dsᵀ (dk), [key r][query c], over the first score tile
    float pd[kT * kT / kF32Threads];
#pragma unroll
    for (int n = 0; n < kT * kT / kF32Threads; ++n) {
      const int e = tid + n * kF32Threads;
      const int r = e / kT, c = e % kT;
      const int row = q0 + c;
      const float* x = sp + r * kLdS + c;
      const float s0 = f32_cluster_sum(x, pieces);
      const float s1 = f32_cluster_sum(x + kTileS, pieces);
      const float sv = dk_role ? s0 : s0 + s1;
      const float p = row < Sq && in_band(row, k0 + r, Sk, causal, window)
                          ? expf(sv * scale - lse_s[c])
                          : 0.f;
      pd[n] = dk_role ? p * (s1 - delta_s[c]) * scale : p;
    }
    f32_cluster_sync(pieces);                 // every piece has read ours
#pragma unroll
    for (int n = 0; n < kT * kT / kF32Threads; ++n) {
      const int e = tid + n * kF32Threads;
      sp[(e / kT) * kLdS + e % kT] = pd[n];
    }
    // dv += pᵀ·dO or dk += dsᵀ·q, 16 queries a step
    for (int c = 0; c < kAccSteps; ++c, ++g) {
      f32_next_step(g, issue);
      f32_accumulate<G>(acc, sp + kRowStep * c,
                        ring + (g % kStages) * kSlot, rg, cg);
    }
  }
  tc::cp_async_wait<0>();

  const size_t koff = (size_t)(b * Hq + h) * Sk;   // this head's dk_h rows
  f32_store<G>((dk_role ? dk_h : dv_h) + koff * D, acc, nullptr, k0, Sk, D,
               c0, aligned, rg, cg);
}

template <typename Kernel>
int configure(Kernel kernel, size_t smem, bool& configured) {
  if (configured) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  configured = true;
  return 0;
}

// Launches an fp32 wide kernel on a grid of (tiles · blocks_per_tile, Hq,
// B) with `smem` bytes a block, the pieces of a tile in one cluster where
// f32_clustered(pieces).
template <typename... Params, typename... Args>
int launch_f32(void (*kernel)(Params...), bool& configured, size_t smem,
               int tiles, int per_tile, int pieces, int Hq, int B,
               cudaStream_t stream, Args... args) {
  if (int err = configure(kernel, smem, configured)) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = f32_clustered(pieces) ? (unsigned)pieces : 1u;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * per_tile), (unsigned)Hq,
                     (unsigned)B);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int G>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   float scale, int causal, int window, int pieces,
                   cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  return launch_f32(wide_fwd_f32_kernel<G>, configured, f32_fwd_smem(G),
                    (Sq + kT - 1) / kT, pieces, pieces, Hq, B, stream,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), lse,
                    Hq, Hkv, Sq, Sk, D, scale, causal, window, pieces);
}

template <int G>
int launch_dq_f32(const float* q, const float* k, const float* v,
                  const float* dout, const float* lse, const float* delta,
                  float* dq, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                  float scale, int causal, int window, int pieces,
                  cudaStream_t stream) {
  static bool configured = false;
  return launch_f32(wide_dq_f32_kernel<G>, configured, f32_bwd_smem(G),
                    (Sq + kT - 1) / kT, pieces, pieces, Hq, B, stream, q, k,
                    v, dout, lse, delta, dq, Hq, Hkv, Sq, Sk, D, scale,
                    causal, window, pieces);
}

template <int G>
int launch_dkv_f32(const float* q, const float* k, const float* v,
                   const float* dout, const float* lse, const float* delta,
                   float* dk_h, float* dv_h, int B, int Hq, int Hkv, int Sq,
                   int Sk, int D, float scale, int causal, int window,
                   int pieces, cudaStream_t stream) {
  static bool configured = false;
  // a k-tile's dv pieces, then its dk pieces: each set one cluster
  return launch_f32(wide_dkv_f32_kernel<G>, configured, f32_bwd_smem(G),
                    (Sk + kT - 1) / kT, 2 * pieces, pieces, Hq, B, stream, q,
                    k, v, dout, lse, delta, dk_h, dv_h, Hq, Hkv, Sq, Sk, D,
                    scale, causal, window, pieces);
}

template <int NP>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                  float scale, int causal, int window, int pieces,
                  cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  if (int err = configure(wide_fwd_tc_kernel<NP>, tc_smem(NP), configured))
    return err;
  const dim3 grid(((Sq + kT - 1) / kT) * pieces, Hq, B);
  wide_fwd_tc_kernel<NP><<<grid, kTcThreads, tc_smem(NP), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Hq, Hkv, Sq,
      Sk, D, scale, causal, window, pieces);
  return (int)cudaGetLastError();
}

template <int NP, int TERMS>
int launch_bwd_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk_h, void* dv_h, int B, int Hq, int Hkv,
                  int Sq, int Sk, int D, float scale, int causal, int window,
                  int dq_pieces, int dkv_pieces, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_tc_smem(NP, TERMS);
  constexpr size_t smem_dkv = dkv_tc_smem(NP, TERMS);
  static_assert(smem_dq <= kSmemOptIn && smem_dkv <= kSmemOptIn,
                "the bf16 backward fits a block");
  static bool configured_dq = false, configured_dkv = false;
  if (int err = configure(wide_dq_tc_kernel<NP, TERMS>, smem_dq,
                          configured_dq))
    return err;
  if (int err = configure(wide_dkv_tc_kernel<NP, TERMS>, smem_dkv,
                          configured_dkv))
    return err;
  const dim3 grid_q(((Sq + kT - 1) / kT) * dq_pieces, Hq, B);
  const dim3 grid_k(((Sk + kT - 1) / kT) * dkv_pieces, Hq, B);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  wide_dq_tc_kernel<NP, TERMS><<<grid_q, kTcThreads, smem_dq, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq), Hq, Hkv, Sq, Sk,
      D, scale, causal, window, dq_pieces);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_dkv_tc_kernel<NP, TERMS><<<grid_k, kTcThreads, smem_dkv,
                                  stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk_h),
      static_cast<bf16*>(dv_h), Hq, Hkv, Sq, Sk, D, scale, causal, window,
      dkv_pieces);
  return (int)cudaGetLastError();
}

// pieces of `cols` columns that cover D, none of them wholly past it
bool covers(int pieces, int cols, int D) {
  return pieces >= 1 && cols >= 1 && (long)pieces * cols >= D &&
         (long)(pieces - 1) * cols < D;
}

bool bad_args(int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
              int window) {
  return B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || D < 1 ||
         window < 0 || (window > 0 && !causal) || (causal && Sk != Sq);
}

}  // namespace

extern "C" {

// As flash_attention_fwd (flash_attention.cu), for any head dim D ≥ 1 (the
// wrapper sends D > 256 here): o (B,Hq,Sq,D) and, with a non-null lse,
// lse (B,Hq,Sq) fp32, from q (B,Hq,Sq,D) and k, v (B,Hkv,Sk,D), contiguous
// fp32; Sk = Sq where causal; window > 0 (causal only): the sliding
// window, 0: none.  dtype 0 (fp32) only: bf16 runs on the tensor cores
// through flash_attention_wide_fwd_tc.  At the geometry kernel.py::
// wide_f32_fwd_geometry(D) gives: `pieces` output pieces of `piece_cols` =
// 64 · `groups` columns that cover D, none of them empty; `groups` the
// instantiation (5, 6 or 8 float4 column groups a thread); `smem` the
// bytes a block (f32_fwd_smem).  Any other geometry is refused.
int flash_attention_wide_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int dtype, int B, int Hq,
                             int Hkv, int Sq, int Sk, int D, float scale,
                             int causal, int window, int pieces,
                             int piece_cols, int groups, int smem,
                             void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, D, causal, window) || dtype != 0 ||
      piece_cols != 64 * groups || !covers(pieces, piece_cols, D) ||
      smem < 0 || (size_t)smem != f32_fwd_smem(groups))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define WIDE_FWD_F32(G)                                                     \
  launch_fwd_f32<G>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, scale, causal,    \
                    window, pieces, s)
  switch (groups) {
    case 5: return WIDE_FWD_F32(5);
    case 6: return WIDE_FWD_F32(6);
    case 8: return WIDE_FWD_F32(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WIDE_FWD_F32
}

// The same function in bf16 (q, k, v and o bf16, 16-byte aligned; lse fp32
// or null) on the tensor cores, at the geometry kernel.py::
// wide_fwd_geometry(D) gives: `pieces` output pieces of `piece_cols` = 32 ·
// `pairs` columns that cover D, none of them empty; `pairs` the
// instantiation (9, 10, 12 or 16 column pairs a warp); `smem` the bytes a
// block (tc_smem).  Any other geometry is refused.
int flash_attention_wide_fwd_tc(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int Hq, int Hkv,
                                int Sq, int Sk, int D, float scale,
                                int causal, int window, int pieces,
                                int piece_cols, int pairs, int smem,
                                void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, D, causal, window) || pieces < 1 ||
      piece_cols != 32 * pairs || pieces * piece_cols < D ||
      (pieces - 1) * piece_cols >= D || smem < 0 ||
      (size_t)smem != tc_smem(pairs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (pairs) {
    case 9:
      return launch_fwd_tc<9>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, scale,
                              causal, window, pieces, s);
    case 10:
      return launch_fwd_tc<10>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, scale,
                               causal, window, pieces, s);
    case 12:
      return launch_fwd_tc<12>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, scale,
                               causal, window, pieces, s);
    case 16:
      return launch_fwd_tc<16>(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, scale,
                               causal, window, pieces, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As flash_attention_bwd (flash_attention_bwd.cu), for any head dim D ≥ 1:
// dq (B,Hq,Sq,D), and dk_h, dv_h (B,Hq,Sk,D) per query head, fp32.
// Launches the dq kernel, then the dk/dv kernel.  dtype 0 (fp32) only:
// bf16 runs on the tensor cores through flash_attention_wide_bwd_tc.  At
// the geometry kernel.py::wide_f32_bwd_geometry(D) gives: `pieces` pieces
// of `piece_cols` = 64 · `groups` columns (5, 6 or 8 groups) that cover D,
// none of them empty, for dq, dv and dk alike; `smem` the bytes a block
// of either kernel (f32_bwd_smem).  Any other geometry is refused.
int flash_attention_wide_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk_h,
                             void* dv_h, int dtype, int B, int Hq, int Hkv,
                             int Sq, int Sk, int D, float scale, int causal,
                             int window, int pieces, int piece_cols,
                             int groups, int smem, void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, D, causal, window) || dtype != 0 ||
      piece_cols != 64 * groups || !covers(pieces, piece_cols, D) ||
      smem < 0 || (size_t)smem != f32_bwd_smem(groups))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* dqp = static_cast<float*>(dq);
  float* dkp = static_cast<float*>(dk_h);
  float* dvp = static_cast<float*>(dv_h);
#define WIDE_BWD_F32(G)                                                     \
  {                                                                         \
    const int err = launch_dq_f32<G>(qp, kp, vp, dop, l, dl, dqp, B, Hq,    \
                                     Hkv, Sq, Sk, D, scale, causal, window, \
                                     pieces, s);                            \
    if (err != 0) return err;                                               \
    return launch_dkv_f32<G>(qp, kp, vp, dop, l, dl, dkp, dvp, B, Hq, Hkv,  \
                             Sq, Sk, D, scale, causal, window, pieces, s);  \
  }
  switch (groups) {
    case 5: WIDE_BWD_F32(5)
    case 6: WIDE_BWD_F32(6)
    case 8: WIDE_BWD_F32(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WIDE_BWD_F32
}

// The same function in bf16 (q, k, v, dO, dq, dk_h and dv_h bf16, 16-byte
// aligned; lse and delta fp32) on the tensor cores, at the geometry
// kernel.py::wide_bwd_geometry(D) gives: `pairs` the instantiation (9, 10,
// 12 or 16; score pieces of 32·`pairs` columns, held whole up to 12);
// `ds_terms` the bf16 terms ds is carried in (1 or 2); `dq_pieces` dq
// pieces of `dq_cols` = 32·`pairs` columns and `dkv_pieces` dk/dv pieces
// of `dkv_cols` = 16·`pairs` columns, each set covering D with none of its
// pieces empty (one dq piece where the tiles are held whole); `dq_smem`,
// `dkv_smem` the bytes a block of each kernel (dq_tc_smem, dkv_tc_smem).
// Any other geometry is refused.
int flash_attention_wide_bwd_tc(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dk_h,
                                void* dv_h, int B, int Hq, int Hkv, int Sq,
                                int Sk, int D, float scale, int causal,
                                int window, int pairs, int ds_terms,
                                int dq_pieces, int dq_cols, int dkv_pieces,
                                int dkv_cols, int dq_smem, int dkv_smem,
                                void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, D, causal, window) || pairs < 1 ||
      (ds_terms != 1 && ds_terms != 2) || dq_cols != 32 * pairs ||
      dkv_cols != 16 * pairs || !covers(dq_pieces, dq_cols, D) ||
      !covers(dkv_pieces, dkv_cols, D) ||
      (bwd_resident(pairs) && dq_pieces != 1) || dq_smem < 0 ||
      dkv_smem < 0 || (size_t)dq_smem != dq_tc_smem(pairs, ds_terms) ||
      (size_t)dkv_smem != dkv_tc_smem(pairs, ds_terms))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define WIDE_BWD_TC(NP, TERMS)                                              \
  launch_bwd_tc<NP, TERMS>(q, k, v, dout, l, dl, dq, dk_h, dv_h, B, Hq, Hkv, \
                           Sq, Sk, D, scale, causal, window, dq_pieces,      \
                           dkv_pieces, s)
  switch (pairs * 2 + ds_terms - 1) {
    case 18: return WIDE_BWD_TC(9, 1);
    case 19: return WIDE_BWD_TC(9, 2);
    case 20: return WIDE_BWD_TC(10, 1);
    case 21: return WIDE_BWD_TC(10, 2);
    case 24: return WIDE_BWD_TC(12, 1);
    case 25: return WIDE_BWD_TC(12, 2);
    case 32: return WIDE_BWD_TC(16, 1);
    case 33: return WIDE_BWD_TC(16, 2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WIDE_BWD_TC
}

}  // extern "C"
