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
// fp32 forward and backward: the first wide kernels, kept as they were, so
// fp32 outputs are bitwise those of before:
//   * a score product (q·kᵀ, dO·vᵀ) runs over D in chunks of kC = 64
//     columns, each staged transposed in shared memory and added to the
//     same running 4 × 4 sums in ascending column order;
//   * a block accumulates one slice of kS = 128 output columns (o, dq, or
//     dk and dv), so the grid holds ceil(D / 128) blocks for each tile, and
//     each recomputes the scores over the whole head dim;
//   * the ragged last chunk and slice are bounded in the loads: columns
//     past D are not read, and a slice's columns past D are zero in shared
//     memory and never stored.
// Every slice of a tile runs the same score products, masks and online
// softmax in the same order, so the slices agree bitwise on m, l and p;
// only slice 0 writes lse.  They compute in fp32 on the CUDA cores.  No
// kernel here uses atomics: two calls agree bitwise.
//
// What bounds them: operations.  The forward at (B=4, Hq=16, S=1024,
// D=512, causal) is 4·B·Hq·D·S²/2 = 68.8 GFLOP of multiply-adds, 0.07 ms
// at the 989 TFLOP/s bf16 tensor-core rate (1.03 ms at the 67 TFLOP/s
// fp32 CUDA-core rate the fp32 kernels run at); recomputing the scores in
// every slice adds (slices − 1) / 2 of that to the fp32 kernels, 1.5× at
// D = 512.  The fp32 dq kernel runs two score products and one slice
// product a tile, the dk/dv kernel two and two: 15 D-wide products a tile
// pair at D = 320.  The bf16 backward runs 9 up to D = 512: dq 3, dk/dv
// two pieces of 2 score products and 2 half-width ones.
//
// Thread layout of the fp32 kernels (256 threads as a 16 × 16 grid (ty,
// tx), as the fp32 kernels of the other head dims): a thread holds a 4 × 4
// block of a 64 × 64 score tile (rows 4ty.., columns 4tx..), and for the
// slice product the same 4 rows by the 8 columns tx + 16c of the slice.
// Scores and accumulators meet through shared memory: p (or ds) as a
// [64][kLd] tile, the slice of v, k, dO or q transposed as a [128][kLd]
// tile over the score chunks' buffers, which are free by then.
//
// Masks, tile ranges, the sliding window (W > 0, causal only: key col
// counts for row row iff row − W < col <= row) and cross attention (Sk ≠
// Sq, bidirectional) are those of the fp32 kernels in flash_attention.cu
// and flash_attention_bwd.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;                // query rows or keys a tile
constexpr int kC = 64;                // head-dim columns a score chunk
constexpr int kS = 128;               // output columns a block accumulates
constexpr int kThreads = 256;         // 16 × 16
constexpr int kLd = kT + 4;           // row stride of every staged tile
constexpr int kChunk = kC * kLd;      // floats of a staged chunk
constexpr int kTile = kT * kLd;       // floats of a p or ds tile
constexpr int kSlice = kS * kLd;      // floats of a staged slice
constexpr float kNegInf = -1e30f;     // the reference's mask value
static_assert(kSlice == 2 * kChunk, "a slice fills two chunk buffers");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// dst[d][r] = src[r0 + r][d0 + d] for the tile's 64 rows and the chunk's
// dn columns; rows past S are zero
template <typename T>
__device__ __forceinline__ void stage_chunk(float* dst, const T* src, int r0,
                                            int S, int D, int d0, int dn,
                                            int tid) {
  for (int e = tid; e < kT * kC; e += kThreads) {
    const int r = e / kC, d = e % kC;
    if (d < dn)
      dst[d * kLd + r] =
          r0 + r < S ? to_f32(src[(size_t)(r0 + r) * D + d0 + d]) : 0.f;
  }
}

// dst[c][r] = src[r0 + r][c0 + c] for the slice's kS columns; rows past S
// and columns past D are zero
template <typename T>
__device__ __forceinline__ void stage_slice(float* dst, const T* src, int r0,
                                            int S, int D, int c0, int tid) {
  for (int e = tid; e < kT * kS; e += kThreads) {
    const int r = e / kS, c = e % kS;
    dst[c * kLd + r] = r0 + r < S && c0 + c < D
                           ? to_f32(src[(size_t)(r0 + r) * D + c0 + c])
                           : 0.f;
  }
}

// a[i][j] += Σ_{d < dn} x[d][4·ty + i] · y[d][4·tx + j] over two staged
// chunks
__device__ __forceinline__ void outer4(float (&a)[4][4], const float* x,
                                       const float* y, int dn, int ty,
                                       int tx) {
#pragma unroll 8
  for (int d = 0; d < dn; ++d) {
    const float4 xa = *reinterpret_cast<const float4*>(x + d * kLd + 4 * ty);
    const float4 ya = *reinterpret_cast<const float4*>(y + d * kLd + 4 * tx);
    const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
    const float yv[4] = {ya.x, ya.y, ya.z, ya.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
  }
}

// acc[i][c] += Σ_r w[4·ty + i][r] · z[tx + 16c][r] over the tile's 64 rows
// r: w a [64][kLd] tile (p or ds, possibly transposed), z a staged slice
__device__ __forceinline__ void accum(float (&acc)[4][kS / 16],
                                      const float* w, const float* z, int ty,
                                      int tx) {
#pragma unroll 2
  for (int r = 0; r < kT; r += 4) {
    float wr[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 w4 =
          *reinterpret_cast<const float4*>(w + (4 * ty + i) * kLd + r);
      wr[i][0] = w4.x;
      wr[i][1] = w4.y;
      wr[i][2] = w4.z;
      wr[i][3] = w4.w;
    }
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) {
      const float4 z4 =
          *reinterpret_cast<const float4*>(z + (tx + 16 * c) * kLd + r);
      const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[i][c] = fmaf(wr[i][u], zv[u], acc[i][c]);
    }
  }
}

// a thread's accumulator rows r0 + 4ty + i and slice columns c0 + tx + 16c,
// stored where they fall inside (rows, D)
template <typename T>
__device__ __forceinline__ void store_slice(T* out,
                                            const float (&acc)[4][kS / 16],
                                            int r0, int rows, int D, int c0,
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < D) store(out + (size_t)row * D + col, acc[i][c]);
    }
  }
}

__device__ __forceinline__ bool in_band(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) &&
         (window == 0 || col > row - window);
}

// ---- the forward ------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                int D, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  float* xq = smem;                   // [kC][kLd] q chunk, transposed
  float* xk = xq + kChunk;            // [kC][kLd] k chunk, transposed
  float* vs = xq;                     // [kS][kLd] v slice (over both chunks)
  float* ps = xq + 2 * kChunk;        // [kT][kLd] probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nsl = (D + kS - 1) / kS;
  const int n_qt = gridDim.x / nsl;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / nsl) * kT;  // heaviest first
  const int c0 = ((int)blockIdx.x % nsl) * kS;              // this slice
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                       // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* qp = q + qoff * D;
  const T* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const T* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;

  float m[4], l[4], acc[4][kS / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) acc[i][c] = 0.f;
  }

  const int n_kt_all = (Sk + kT - 1) / kT;
  // causal: k-tiles starting past this q-tile's last row are skipped;
  // window: so are those ending before its first row's window
  const int n_kt = causal ? min(n_kt_all, (q0 + kT - 1) / kT + 1) : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / kT : 0;
  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * kT;
    float s[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += kC) {
      const int dn = min(kC, D - d0);
      __syncthreads();  // the previous reads of these buffers are done
      stage_chunk(xq, qp, q0, Sq, D, d0, dn, tid);
      stage_chunk(xk, kp, k0, Sk, D, d0, dn, tid);
      __syncthreads();
      outer4(s, xq, xk, dn, ty, tx);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        s[i][j] = in_band(row, col, Sk, causal, window) ? s[i][j] * scale
                                                        : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + rs;
      m[i] = m_new;
      *reinterpret_cast<float4*>(ps + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kS / 16; ++c) acc[i][c] *= alpha[i];
    __syncthreads();  // the last chunk's reads are done; p is written
    stage_slice(vs, vp, k0, Sk, D, c0, tid);
    __syncthreads();
    accum(acc, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lsafe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) acc[i][c] /= lsafe;  // o = acc / l
    // m and l are whole-row values in each of the row's 16 threads, and
    // the same in every slice
    const int row = q0 + 4 * ty + i;
    if (lse != nullptr && c0 == 0 && tx == 0 && row < Sq)
      lse[qoff + row] = m[i] + logf(lsafe);
  }
  store_slice(o + qoff * D, acc, q0, Sq, D, c0, ty, tx);
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

// ---- the backward: dq --------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  float* xq = smem;                   // [kC][kLd] q chunk, transposed
  float* xk = xq + kChunk;            // [kC][kLd] k chunk
  float* xo = xk + kChunk;            // [kC][kLd] dO chunk
  float* xv = xo + kChunk;            // [kC][kLd] v chunk
  float* ks = xq;                     // [kS][kLd] k slice (over xq, xk)
  float* dss = xq + 4 * kChunk;       // [kT][kLd] ds
  float* lse_s = dss + kTile;         // [kT]
  float* delta_s = lse_s + kT;        // [kT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nsl = (D + kS - 1) / kS;
  const int n_qt = gridDim.x / nsl;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / nsl) * kT;  // heaviest first
  const int c0 = ((int)blockIdx.x % nsl) * kS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* qp = q + qoff * D;
  const T* dop = dout + qoff * D;
  const T* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const T* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;

  if (tid < kT) {
    const bool ok = q0 + tid < Sq;
    lse_s[tid] = ok ? lse[qoff + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
  }

  float acc[4][kS / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) acc[i][c] = 0.f;

  const int n_kt_all = (Sk + kT - 1) / kT;
  const int n_kt = causal ? min(n_kt_all, (q0 + kT - 1) / kT + 1) : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / kT : 0;
  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * kT;
    float s[4][4] = {}, dp[4][4] = {};
    for (int d0 = 0; d0 < D; d0 += kC) {
      const int dn = min(kC, D - d0);
      __syncthreads();  // the previous reads of these buffers are done
      stage_chunk(xq, qp, q0, Sq, D, d0, dn, tid);
      stage_chunk(xk, kp, k0, Sk, D, d0, dn, tid);
      stage_chunk(xo, dop, q0, Sq, D, d0, dn, tid);
      stage_chunk(xv, vp, k0, Sk, D, d0, dn, tid);
      __syncthreads();
      outer4(s, xq, xk, dn, ty, tx);
      outer4(dp, xo, xv, dn, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int row = q0 + r;
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const float p = row < Sq && in_band(row, col, Sk, causal, window)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.f;
        ds[j] = p * (dp[i][j] - delta_s[r]) * scale;
      }
      *reinterpret_cast<float4*>(dss + r * kLd + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // the last chunk's reads are done; ds is written
    stage_slice(ks, kp, k0, Sk, D, c0, tid);
    __syncthreads();
    accum(acc, dss, ks, ty, tx);
  }

  store_slice(dq + qoff * D, acc, q0, Sq, D, c0, ty, tx);
}

// ---- the backward: dk and dv per query head ---------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk_h,
                T* __restrict__ dv_h, int Hq, int Hkv, int Sq, int Sk, int D,
                float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  float* xk = smem;                   // [kC][kLd] k chunk, transposed
  float* xq = xk + kChunk;            // [kC][kLd] q chunk
  float* xv = xq + kChunk;            // [kC][kLd] v chunk
  float* xo = xv + kChunk;            // [kC][kLd] dO chunk
  float* os = xk;                     // [kS][kLd] dO slice (over xk, xq)
  float* qs = xv;                     // [kS][kLd] q slice (over xv, xo)
  float* pt = xk + 4 * kChunk;        // [kT][kLd] pᵀ (key rows)
  float* dst = pt + kTile;            // [kT][kLd] dsᵀ
  float* lse_s = dst + kTile;         // [kT]
  float* delta_s = lse_s + kT;        // [kT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nsl = (D + kS - 1) / kS;
  const int k0 = ((int)blockIdx.x / nsl) * kT;  // causal: heaviest first
  const int c0 = ((int)blockIdx.x % nsl) * kS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const T* qp = q + qoff * D;
  const T* dop = dout + qoff * D;
  const T* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const T* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;

  float dk[4][kS / 16], dv[4][kS / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kS / 16; ++c) dk[i][c] = dv[i][c] = 0.f;

  // causal: q-tiles whose last row lies before this k-tile are skipped;
  // window: so are those starting past its last key's last row
  const int n_qt = window > 0
      ? min((Sq + kT - 1) / kT, (k0 + kT - 1 + window - 1) / kT + 1)
      : (Sq + kT - 1) / kT;
  for (int qi = causal ? k0 / kT : 0; qi < n_qt; ++qi) {
    const int q0 = qi * kT;
    float s[4][4] = {}, dp[4][4] = {};   // [key 4ty + i][query 4tx + j]
    for (int d0 = 0; d0 < D; d0 += kC) {
      const int dn = min(kC, D - d0);
      __syncthreads();  // the previous reads of these buffers are done
      if (d0 == 0 && tid < kT) {
        const bool ok = q0 + tid < Sq;
        lse_s[tid] = ok ? lse[qoff + q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta[qoff + q0 + tid] : 0.f;
      }
      stage_chunk(xk, kp, k0, Sk, D, d0, dn, tid);
      stage_chunk(xq, qp, q0, Sq, D, d0, dn, tid);
      stage_chunk(xv, vp, k0, Sk, D, d0, dn, tid);
      stage_chunk(xo, dop, q0, Sq, D, d0, dn, tid);
      __syncthreads();
      outer4(s, xk, xq, dn, ty, tx);
      outer4(dp, xv, xo, dn, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * ty + i;
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * tx + j;
        const int row = q0 + r;
        p[j] = row < Sq && in_band(row, key, Sk, causal, window)
                   ? expf(s[i][j] * scale - lse_s[r])
                   : 0.f;
        ds[j] = p[j] * (dp[i][j] - delta_s[r]) * scale;
      }
      *reinterpret_cast<float4*>(pt + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dst + (4 * ty + i) * kLd + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();  // the last chunk's reads are done; p and ds written
    stage_slice(os, dop, q0, Sq, D, c0, tid);
    stage_slice(qs, qp, q0, Sq, D, c0, tid);
    __syncthreads();
    accum(dv, pt, os, ty, tx);
    accum(dk, dst, qs, ty, tx);
  }

  const size_t koff = (size_t)(b * Hq + h) * Sk;   // this head's dk_h rows
  store_slice(dk_h + koff * D, dk, k0, Sk, D, c0, ty, tx);
  store_slice(dv_h + koff * D, dv, k0, Sk, D, c0, ty, tx);
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

// shared memory a block: the forward's two chunks (the v slice over them)
// and p, 52,224 bytes; the dq kernel's four chunks, ds, lse and delta,
// 87,552; the dk/dv kernel's four chunks, pᵀ, dsᵀ, lse and delta, 104,960
constexpr size_t kFwdSmem = sizeof(float) * (2 * kChunk + kTile);
constexpr size_t kDqSmem = sizeof(float) * (4 * kChunk + kTile + 2 * kT);
constexpr size_t kDkvSmem = sizeof(float) * (4 * kChunk + 2 * kTile + 2 * kT);
static_assert(kFwdSmem == 52224 && kDqSmem == 87552 && kDkvSmem == 104960,
              "the wide kernels' shared memory, whatever D");

template <typename Kernel>
int configure(Kernel kernel, size_t smem, bool& configured) {
  if (configured) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  configured = true;
  return 0;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, int window, cudaStream_t stream) {
  static bool configured = false;  // once per instantiation
  if (int err = configure(wide_fwd_kernel<T>, kFwdSmem, configured))
    return err;
  const int nsl = (D + kS - 1) / kS;
  const dim3 grid(((Sq + kT - 1) / kT) * nsl, Hq, B);
  wide_fwd_kernel<T><<<grid, kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq, Hkv, Sq, Sk, D,
      scale, causal, window);
  return (int)cudaGetLastError();
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

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk_h,
               void* dv_h, int B, int Hq, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, int window, cudaStream_t stream) {
  static bool configured_dq = false, configured_dkv = false;
  if (int err = configure(wide_dq_kernel<T>, kDqSmem, configured_dq))
    return err;
  if (int err = configure(wide_dkv_kernel<T>, kDkvSmem, configured_dkv))
    return err;
  const int nsl = (D + kS - 1) / kS;
  const dim3 grid_q(((Sq + kT - 1) / kT) * nsl, Hq, B);   // dq
  const dim3 grid_k(((Sk + kT - 1) / kT) * nsl, Hq, B);   // dk, dv
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  wide_dq_kernel<T><<<grid_q, kThreads, kDqSmem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Hq, Hkv, Sq, Sk, D,
      scale, causal, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_dkv_kernel<T><<<grid_k, kThreads, kDkvSmem, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk_h),
      static_cast<T*>(dv_h), Hq, Hkv, Sq, Sk, D, scale, causal, window);
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
// and of one dtype; Sk = Sq where causal; window > 0 (causal only): the
// sliding window, 0: none.  dtype 0 (fp32) only: bf16 runs on the tensor
// cores through flash_attention_wide_fwd_tc, which takes its geometry.
int flash_attention_wide_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int dtype, int B, int Hq,
                             int Hkv, int Sq, int Sk, int D, float scale,
                             int causal, int window, void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, D, causal, window) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch_fwd<float>(q, k, v, o, static_cast<float*>(lse), B, Hq, Hkv,
                           Sq, Sk, D, scale, causal, window,
                           static_cast<cudaStream_t>(stream));
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
// dq (B,Hq,Sq,D), and dk_h, dv_h (B,Hq,Sk,D) per query head.  Launches
// the dq kernel, then the dk/dv kernel.  dtype 0 (fp32) only: bf16 runs on
// the tensor cores through flash_attention_wide_bwd_tc, which takes its
// geometry.
int flash_attention_wide_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk_h,
                             void* dv_h, int dtype, int B, int Hq, int Hkv,
                             int Sq, int Sk, int D, float scale, int causal,
                             int window, void* stream) {
  if (bad_args(B, Hq, Hkv, Sq, Sk, D, causal, window) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  return launch_bwd<float>(q, k, v, dout, static_cast<const float*>(lse),
                           static_cast<const float*>(delta), dq, dk_h, dv_h,
                           B, Hq, Hkv, Sq, Sk, D, scale, causal, window,
                           static_cast<cudaStream_t>(stream));
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
