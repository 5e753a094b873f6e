// Causal (optionally sliding-window) / bidirectional GQA attention with an
// online softmax (the forward, with or without its log-sum-exp) for Hopper
// (sm_90a), compiled
// into the port's one library (repro_torch/kernels/cudalib.py) and bound
// through a plain C interface.
//
// Source note
// -----------
// Replaces two of the JAX package's Pallas TPU kernels, one body each:
//   repro/kernels/flash_attention/kernel.py::flash_attention (_flash_kernel):
//     o = softmax(q·kᵀ·scale, masked) · v per (batch, query head), query
//     head h reading KV head h // (Hq/Hkv), with an fp32 running max m, sum
//     l and accumulator carried across the k-blocks, the −1e30 mask value,
//     causal k-blocks wholly above the diagonal skipped, and the l == 0 → 1
//     guard at the end;
//   ...::flash_attention_fwd_lse (_flash_fwd_lse_kernel): the same o, and
//     lse = m + log(l, guarded) per row in fp32 for the training backward
//     (flash_attention_bwd.cu): the same kernel, given an lse output.
// Both take the reference's sliding window (repro/models/layers.py::
// _chunked_attention, window=W, causal only): key col counts for row row
// iff col <= row and col > row − W.  W = 0 means none.  The k-tile loop of
// a q-tile starts at the tile holding its first row's first key, so tiles
// wholly before the window are never loaded, as causal tiles past the
// diagonal are not; a warp skips a tile wholly before its own rows'
// window; the band's lower edge joins the masked-tile test and the
// element mask.  At W >= S nothing is skipped or masked beyond causal, so
// the result is the causal one bitwise.  Mixtral-8x7b (B=1, Hq=32, Hkv=8,
// S=8192, D=128, W=4096) has 25.17 M (row, key) pairs against causal's
// 33.56 M: 412 GFLOP, 0.417 ms at the 989 TFLOP/s bf16 rate.
//
// Cross attention (causal = 0): Sq query rows against Sk keys, Sk ≠ Sq
// allowed (the reference's _chunked_attention with kv_override, an
// encoder–decoder's decoder over its encoder memory).  The q-tile grid, the
// q loads, the o and lse rows count Sq; the k-tile loop, the k and v loads
// with their zero fill and the ragged-column mask count Sk.  Causal
// attention needs Sk = Sq (the entry point refuses anything else), so on
// that path both counts are the one S they were.  Seamless-m4t-large-v2's
// cross attention (B=4, H=16, Sq=1024, Sk=4096, D=64) is 4·B·H·D·Sq·Sk =
// 68.7 GFLOP: 0.069 ms at the bf16 rate.
//
// What bounds it: operations.  Granite-3-2b's prefill (B=8, Hq=32, S=1024,
// D=64, causal) is 2·2·B·Hq·D·S²/2 ≈ 34 GFLOP a layer against 84 MB of q,
// k, v and o in bf16: 0.035 ms at the 989 TFLOP/s bf16 tensor-core rate,
// 0.025 ms of bytes.  Beside the products, each score takes one exp2 on the
// special-function units (16 a clock an SM): at D=64 a 64×64 tile is 128
// mma.sync and 4096 exp2, so the exponentials cost about as much as the
// products, as in FlashAttention-2.
//
// bf16: flash_fwd_tc_kernel, FlashAttention-2 on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, fp32 accumulation; the building
// blocks in flash_tc.cuh).  One block of 4 warps owns one (b, h, q-tile)
// reduction and loops over the 64-key k-tiles itself, so nothing carries
// between blocks.  Each warp owns m_tiles<D>() 16-row tiles: two at
// D ≤ 64 (a 128-row q-tile, each K or V fragment loaded from shared memory
// feeding four mma), one above (a 64-row q-tile; two would spill).  D =
// 112 and 160 (zamba2-7b, stablelm-12b) are multiples of 16, so the k-steps
// of mma.m16n8k16, the 16-byte cp.async chunks (14 and 20 a row) and the
// padded rows (240 and 336 bytes, odd multiples of 16, so ldmatrix stays
// free of bank conflicts) hold as at the powers of two.  At D = 112 ptxas
// fits the kernel in 168 registers and spills 12 bytes; asking it for one
// block an SM (190 registers, no spill) was slower (PERF.md §6).  D = 256,
// the largest head dim of public dense models, keeps the o accumulator (128
// fp32 a lane) in registers but not the q fragments beside it: each k-step
// reads them from the staged q tile.  Any other D up to 256 runs zero-padded
// to the next instantiated one (kernel.py::forward_padded): zero columns
// add nothing to q·kᵀ, and the scale stays 1/√D of the unpadded D.
// The warp's q rows go into registers once (ldmatrix) as A fragments; K and
// V tiles are bf16 in shared memory, double-buffered with cp.async (16 bytes
// a thread, rows padded so ldmatrix is free of bank conflicts).  S = Q·Kᵀ
// runs on the tensor cores; scale·log2(e) folds into one FFMA before
// ex2.approx, and the row max and sum reduce over the 4 threads of a quad
// with shuffles.  P never touches shared memory: its fp32 accumulator
// fragments are rounded to nearest in registers (cvt.rn.bf16x2.f32) into
// the A operand of P·V, V read through ldmatrix.trans, and the O
// accumulator stays in registers.  The row sum l adds the unrounded p, as
// FlashAttention-2 and the library call do; p is rounded once for its
// product, so o differs from the fp32 plain version by about one bf16
// rounding of p (chip_smoke.py's gate for these kernels anchors on the
// library's own error against float64).  Masking runs only on the causal
// diagonal and the ragged last tile; a causal k-tile wholly past a warp's
// rows is skipped by that warp and one past the q-tile is never loaded;
// loads past S are zero-filled (cp.async with source size 0), so any S
// runs; the grid hands out the heaviest (last) q-tiles first; lse =
// m·ln 2 + log(l) back in natural log.  mma.sync, not wgmma: a 64-row
// tile per warpgroup fits wgmma's M=64, but its shared-memory descriptors,
// swizzled layouts and TMA feed are a larger step, left for a later
// redesign (PERF.md §7).
//
// fp32: flash_fwd_f32_kernel, FlashAttention-2 on the tensor cores in split
// TF32 (flash_tc.cuh): each fp32 operand of q·kᵀ and p·v is a TF32 big
// part and a TF32 small part, and each product three mma.sync.m16n8k8
// with fp32 accumulation (big·small, small·big, big·big), so fp32 inputs
// keep fp32-level error beside the fp32 plain version, as the library's
// fp32 attention (CUTLASS's OpMultiplyAddFastF32) does.  What bounds it:
// operations at 495/3 = 165 TFLOP/s of fp32 products (0.208 ms at (4, 32,
// 4, 1024, 128) causal; 0.513 at the CUDA cores' 67 TFLOP/s).  The first
// fp32 kernel ran those products in FFMA with two shared-memory loads for
// every 16 and staged its tiles element by element; this one does neither.
// A block of 8 warps owns 128 query rows, 16 a warp, staged once; K and V
// stream in steps of 64 keys (32 at D = 160, 16 at D = 256, so that the
// double buffer fits beside q: 202,752 bytes at D = 128) through
// cp.async, 16 bytes a copy (4 where a base pointer is only 4-byte
// aligned, as a view's can be).  The split happens as a fragment is
// loaded from shared memory (4 operations an element), not once as a tile
// is staged: a big and a small copy of K and V would halve the step that
// fits.  The tensor cores truncate as they accumulate, so sums are kept
// short: p·v over each 32 keys and q·kᵀ over each half of D above D = 128
// run into a fresh accumulator, added to the running one in fp32
// (flash_tc.cuh::add_to).  The key relabelling of flash_tc.cuh makes
// the score fragments p·v's A operand in registers, and its column
// relabelling reads V as two 8-byte loads a lane and writes o as 16-byte
// stores; every tile row is D + 4 floats, so the fragment loads are free of
// bank conflicts.  The masks, the −inf of masked scores, the exp2 domain,
// the l == 0 → 1 guard, lse in natural log and the heaviest q-tiles first
// are the bf16 kernel's.
//
// No atomics in either kernel: two calls agree bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

namespace tc = flash_tc;
using tc::bf16;

// ---- fp32: split TF32 on the tensor cores ----------------------------------

using tc::kNegInf;                    // the reference's mask value
using tc::kSmemOptIn;

// the forward's geometry: one resident tile (q), no per-row statistics
template <int D>
__host__ __device__ constexpr int fwd_warps() {
  return tc::f32_warps<D>(1, 0);
}
template <int D>
__host__ __device__ constexpr int fwd_step() {
  return tc::f32_step<D>(1, 0);
}
template <int D>
constexpr size_t fwd_f32_smem() {
  return tc::f32_smem<D>(1, fwd_warps<D>(), fwd_step<D>(), 0);
}
static_assert(fwd_warps<256>() == 8 && fwd_step<128>() == 64 &&
                  fwd_step<160>() == 32 && fwd_step<256>() == 16 &&
                  fwd_f32_smem<128>() == 202752 &&
                  fwd_f32_smem<256>() == 199680,
              "kernel.py::f32_geometry models the fp32 forward's geometry");

// two blocks an SM at D ≤ 64 (128 registers a thread), one above, asked
// of ptxas explicitly: one block stated was faster at D = 112 to 160
// than no count (scripts/flash_f32_variants.py, PERF.md §6)
template <int D>
__global__ void __launch_bounds__(32 * fwd_warps<D>(), D <= 64 ? 2 : 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk,
                     float scale, int causal, int window, int aligned) {
  constexpr int W = fwd_warps<D>();
  constexpr int NT = 32 * W;
  constexpr int BQ = 16 * W;          // query rows a block, 16 a warp
  constexpr int KS = fwd_step<D>();   // keys a step
  constexpr int LD = tc::ld_f32<D>();
  constexpr int NK = KS / 8;          // 8-key n-tiles of a step's scores
  constexpr int KC = NK < 4 ? NK : 4;  // 8-key steps a chunk of o's sum
  constexpr int KD = D / 8;           // k-steps of the head dim
  constexpr int KDC = tc::score_chunk<D>();  // k-steps a chunk of q·kᵀ
  static_assert(KD % KDC == 0, "whole score chunks");
  constexpr int ND = D / 8;           // 8-column n-tiles of o
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [BQ][LD]     q tile
  float* ks = qs + BQ * LD;           // [2][KS][LD]  k steps
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
  const float* kb = ks + g * LD + t;          // B (k = d): key rows
  const float* vb = vs + 2 * t * LD + 2 * g;  // B pairs (k = keys)

  const int n_kt_all = (Sk + KS - 1) / KS;
  // causal: steps starting past this q-tile's last row are skipped;
  // window: so are those ending before its first row's window
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / KS + 1) : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / KS : 0;
  // this warp's rows: the first whose window a step must reach, the last
  const int w_lo = q0 + wr, w_hi = q0 + wr + 15;
  tc::load_rows_f32<D, BQ, NT>(qs, q + qoff * D, q0, Sq, tid, aligned);
  tc::load_rows_f32<D, KS, NT>(ks, kp, it0 * KS, Sk, tid, aligned);
  tc::load_rows_f32<D, KS, NT>(vs, vp, it0 * KS, Sk, tid, aligned);
  tc::cp_async_commit();

  float acc[ND][4];                   // o, rows g and g + 8
  float m[2], l[2];                   // running max (exp2 domain), sum part
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;

  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * KS;
    const int buf = (it - it0) & 1;
    if (it + 1 < n_kt) {              // prefetch the next step
      tc::load_rows_f32<D, KS, NT>(ks + (buf ^ 1) * KS * LD, kp, k0 + KS, Sk,
                                   tid, aligned);
      tc::load_rows_f32<D, KS, NT>(vs + (buf ^ 1) * KS * LD, vp, k0 + KS, Sk,
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
      const float* kt = kb + buf * KS * LD;
      const float* vt = vb + buf * KS * LD;

      float s[NK][4];                 // 16 rows × KS keys
#pragma unroll
      for (int d0 = 0; d0 < KD; d0 += KDC) {
        float part[NK][4] = {};       // a chunk's sum (tc::score_chunk)
#pragma unroll
        for (int kk = d0; kk < d0 + KDC; ++kk) {
          const tc::Frag<4> aq = tc::lda_f32<LD>(qa + 8 * kk);
#pragma unroll
          for (int n = 0; n < NK; ++n)
            tc::mma3(part[n], aq, tc::ldb_f32(kt + 8 * n * LD + 8 * kk));
        }
#pragma unroll
        for (int n = 0; n < NK; ++n) tc::set_or_add(s[n], part[n], d0 == 0);
      }

      // mask the diagonal, the window's lower edge and the ragged step
      // (raw scores)
      if (k0 + KS > Sk || (causal && k0 + KS - 1 > w_lo) ||
          (window > 0 && k0 <= w_hi - window)) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + wr + g + 8 * (e >> 1);
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            // −inf, not −1e30: a row the window leaves without a key in
            // this step keeps its running max and gets p = 2^−inf = 0
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
        for (int n = 0; n < NK; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mt = fmaxf(m[r], mx * sl2);
        const float alpha = tc::ex2(m[r] - mt);
        m[r] = mt;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int c = 2 * r; c < 2 * r + 2; ++c) {
            s[n][c] = tc::ex2(fmaf(s[n][c], sl2, -mt));
            rs += s[n][c];
          }
        l[r] = alpha * l[r] + rs;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }

      // o += p · v in split TF32, p from registers: the sum over each
      // chunk of up to 32 keys in a fresh accumulator, added in fp32 (the
      // tensor cores truncate as they accumulate; tc::add_to)
#pragma unroll
      for (int c0 = 0; c0 < NK; c0 += KC) {
        tc::Frag<4> pa[KC];
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) pa[kk] = tc::a_from_c_f32(s[c0 + kk]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          float part[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
            tc::Frag<2> lo, hi;
            tc::ldb_pair_f32<LD>(lo, hi, vt + 8 * (c0 + kk) * LD + 16 * dp);
            tc::mma3(part[0], pa[kk], lo);
            tc::mma3(part[1], pa[kk], hi);
          }
          tc::add_to(acc[2 * dp], part[0]);
          tc::add_to(acc[2 * dp + 1], part[1]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  float* op = o + qoff * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = q0 + wr + g + 8 * r;
    if (row >= Sq) continue;
    const float lsafe = lr == 0.f ? 1.f : lr;
    const float inv = 1.f / lsafe;
    // columns 16·dp + 4t .. + 3 (the column relabelling)
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp)
      *reinterpret_cast<float4*>(op + (size_t)row * D + 16 * dp + 4 * t) =
          make_float4(acc[2 * dp][2 * r] * inv, acc[2 * dp + 1][2 * r] * inv,
                      acc[2 * dp][2 * r + 1] * inv,
                      acc[2 * dp + 1][2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[qoff + row] = m[r] * tc::kLn2 + logf(lsafe);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, float scale,
               int causal, int window, int aligned, cudaStream_t stream) {
  constexpr size_t smem = fwd_f32_smem<D>();
  static_assert(smem <= kSmemOptIn, "the fp32 forward's tiles fit a block");
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int bq = 16 * fwd_warps<D>();
  const dim3 grid((Sq + bq - 1) / bq, Hq, B);
  flash_fwd_f32_kernel<D><<<grid, 32 * fwd_warps<D>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq, Hkv, Sq,
      Sk, scale, causal, window, aligned);
  return (int)cudaGetLastError();
}

int launch_f32_dim(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                   float scale, int causal, int w, int al, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_f32<16>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                            causal, w, al, s);
    case 32:
      return launch_f32<32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                            causal, w, al, s);
    case 64:
      return launch_f32<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                            causal, w, al, s);
    case 112:
      return launch_f32<112>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                             causal, w, al, s);
    case 128:
      return launch_f32<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                             causal, w, al, s);
    case 160:
      return launch_f32<160>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                             causal, w, al, s);
    case 256:
      return launch_f32<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                             causal, w, al, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---- bf16: the tensor-core kernel ------------------------------------------

template <int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int Sq,
                    int Sk, float scale, int causal, int window) {
  constexpr int MT = tc::m_tiles<D>();
  constexpr int BQ = tc::kWarps * 16 * MT;  // query rows a block
  constexpr int LD = tc::ld<D>();
  constexpr int TILE = tc::tile<D>();
  constexpr int KD = D / 16;          // k-steps of the head dim
  constexpr int ND = D / 8;           // 8-column tiles of the head dim
  // q fragments held in registers up to D = 160; at D = 256 they would
  // take 64 registers beside the 128 of the o accumulator, so each k-step
  // reads them from the staged q tile again
  constexpr bool kRegQ = D <= 160;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD] q tile
  bf16* ks = qs + MT * TILE;                      // [2][64][LD] k tiles
  bf16* vs = ks + 2 * TILE;                       // [2][64][LD] v tiles

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) * 16 * MT;  // this warp's first row in the tile
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);                      // jnp.repeat's order
  const size_t qoff = (size_t)(b * Hq + h) * Sq;
  const bf16* kp = k + ((size_t)(b * Hkv + hk) * Sk) * D;
  const bf16* vp = v + ((size_t)(b * Hkv + hk) * Sk) * D;
  const float sl2 = scale * tc::kLog2e;
  // this lane's ldmatrix addresses: q rows (A), k rows (B, non-transposed),
  // v rows (B, transposed); a k-tile buffer adds 2·TILE bytes
  const uint32_t qa = tc::smem_u32(qs) + tc::a_lane(lane, LD) +
                      tc::at(wr, 0, LD);
  const uint32_t kb = tc::smem_u32(ks) + tc::bn_lane(lane, LD);
  const uint32_t vb = tc::smem_u32(vs) + tc::bk_lane(lane, LD);

  const int n_kt_all = (Sk + tc::kRows - 1) / tc::kRows;
  // causal: k-tiles starting past this q-tile's last row are skipped;
  // window: so are those ending before its first row's window
  const int n_kt = causal ? min(n_kt_all, (q0 + BQ - 1) / tc::kRows + 1)
                          : n_kt_all;
  const int it0 = window > 0 ? max(0, q0 - window + 1) / tc::kRows : 0;
  // this warp's rows: the first whose window a tile must reach, the last
  const int w_lo = q0 + wr, w_hi = q0 + wr + 16 * MT - 1;
#pragma unroll
  for (int i = 0; i < MT; ++i)
    tc::load_tile<D>(qs + i * TILE, q + qoff * D, q0 + i * tc::kRows, Sq,
                     tid);
  tc::load_tile<D>(ks, kp, it0 * tc::kRows, Sk, tid);
  tc::load_tile<D>(vs, vp, it0 * tc::kRows, Sk, tid);
  tc::cp_async_commit();

  uint32_t qf[kRegQ ? MT : 1][kRegQ ? KD : 1][4];  // this warp's q rows
  float acc[MT][ND][4];               // o, rows g and g + 8 of each m-tile
  float m[MT][2], l[MT][2];           // running max (exp2 domain), sum part
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
  }

  for (int it = it0; it < n_kt; ++it) {
    const int k0 = it * tc::kRows;
    const int buf = (it - it0) & 1;
    if (it + 1 < n_kt) {              // prefetch the next k-tile
      tc::load_tile<D>(ks + (buf ^ 1) * TILE, kp, k0 + tc::kRows, Sk, tid);
      tc::load_tile<D>(vs + (buf ^ 1) * TILE, vp, k0 + tc::kRows, Sk, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kRegQ) {
      if (it == it0) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            tc::ldsm_x4(qf[i][kk], qa + tc::at(16 * i, 16 * kk, LD));
      }
    }
    // causal: a k-tile wholly past this warp's last row adds nothing;
    // window: nor one wholly before its first row's window
    if ((!causal || k0 <= w_hi) &&
        (window == 0 || k0 + tc::kRows - 1 > w_lo - window)) {
      const uint32_t kt = kb + buf * 2 * TILE;
      const uint32_t vt = vb + buf * 2 * TILE;

      float s[MT][8][4];              // 16 rows × 64 keys an m-tile
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t aq[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if constexpr (kRegQ) {
#pragma unroll
            for (int x = 0; x < 4; ++x) aq[i][x] = qf[i][kk][x];
          } else {
            tc::ldsm_x4(aq[i], qa + tc::at(16 * i, 16 * kk, LD));
          }
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, kt + tc::at(16 * np, 16 * kk, LD));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            tc::mma(s[i][2 * np], aq[i], bb[0], bb[1]);
            tc::mma(s[i][2 * np + 1], aq[i], bb[2], bb[3]);
          }
        }
      }

      // mask the diagonal, the window's lower edge and the ragged tile
      // (raw scores)
      if (k0 + tc::kRows > Sk || (causal && k0 + 63 > w_lo) ||
          (window > 0 && k0 <= w_hi - window)) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = q0 + wr + 16 * i + g + 8 * (e >> 1);
              const int col = k0 + 8 * n + 2 * t + (e & 1);
              // −inf, not −1e30: a row the window leaves without a key in
              // this tile keeps its running max and gets p = 2^−inf = 0
              if (col >= Sk || (causal && col > row) ||
                  (window > 0 && col <= row - window))
                s[i][n][e] = __int_as_float(0xff800000);
            }
      }

      // online softmax for rows g (e = 0, 1) and g + 8 (e = 2, 3), in the
      // exp2 domain: p = 2^(s·scale·log2e − m)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = kNegInf;
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mx = fmaxf(mx, fmaxf(s[i][n][2 * r], s[i][n][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mt = fmaxf(m[i][r], mx * sl2);
          const float alpha = tc::ex2(m[i][r] - mt);
          m[i][r] = mt;
          float rs = 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int c = 2 * r; c < 2 * r + 2; ++c) {
              s[i][n][c] = tc::ex2(fmaf(s[i][n][c], sl2, -mt));
              rs += s[i][n][c];
            }
          l[i][r] = alpha * l[i][r] + rs;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            acc[i][n][2 * r] *= alpha;
            acc[i][n][2 * r + 1] *= alpha;
          }
        }

      // o += p · v, p rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          tc::a_from_c(pa[i], s[i][2 * kk], s[i][2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, vt + tc::at(16 * kk, 16 * dp, LD));
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            tc::mma(acc[i][2 * dp], pa[i], bb[0], bb[1]);
            tc::mma(acc[i][2 * dp + 1], pa[i], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before refill
  }

  bf16* op = o + qoff * D;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[i][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = q0 + wr + 16 * i + g + 8 * r;
      if (row >= Sq) continue;
      const float lsafe = lr == 0.f ? 1.f : lr;
      const float inv = 1.f / lsafe;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(op + (size_t)row * D + 8 * n + 2 * t) =
            tc::pack_bf16(acc[i][n][2 * r] * inv, acc[i][n][2 * r + 1] * inv);
      if (lse != nullptr && t == 0)
        lse[qoff + row] = m[i][r] * tc::kLn2 + logf(lsafe);
    }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Hq, int Hkv, int Sq, int Sk, float scale,
              int causal, int window, cudaStream_t stream) {
  constexpr int MT = tc::m_tiles<D>();
  // the q tile (MT staged tiles), two k and two v tiles: 107,520 bytes at
  // D = 160, 168,960 at D = 256
  constexpr size_t smem = (MT + 4) * tc::tile<D>() * sizeof(bf16);
  static_assert(smem <= kSmemOptIn, "the bf16 forward's tiles fit a block");
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int bq = tc::kWarps * 16 * MT;
  const dim3 grid((Sq + bq - 1) / bq, Hq, B);
  flash_fwd_tc_kernel<D><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Hq, Hkv, Sq,
      Sk, scale, causal, window);
  return (int)cudaGetLastError();
}

int launch_tc_dim(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                  float scale, int causal, int w, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_tc<16>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                           causal, w, s);
    case 32:
      return launch_tc<32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                           causal, w, s);
    case 64:
      return launch_tc<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                           causal, w, s);
    case 112:
      return launch_tc<112>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                            causal, w, s);
    case 128:
      return launch_tc<128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                            causal, w, s);
    case 160:
      return launch_tc<160>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                            causal, w, s);
    case 256:
      return launch_tc<256>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, scale,
                            causal, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// o (B,Hq,Sq,D) = attention of q (B,Hq,Sq,D) over k, v (B,Hkv,Sk,D), all
// contiguous and of one dtype (0 fp32: the split-TF32 kernel, 4-byte
// aligned; 1 bf16: the bf16 kernel, 16-byte aligned); D in {16, 32, 64,
// 112, 128, 160, 256} (the wrapper zero-pads any other D up to 256 to the
// next one, and sends D > 256 to flash_attention_wide.cu); Sk = Sq where
// causal.  With a non-null lse, also lse (B,Hq,Sq) fp32 = m + log(l,
// guarded) per row (the training forward).  window > 0 (causal only): the
// sliding window; 0: none.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int dtype, int B, int Hq, int Hkv, int Sq,
                        int Sk, int D, float scale, int causal, int window,
                        void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || window < 0 ||
      (window > 0 && !causal) || (causal && Sk != Sq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0: {
      // a view's base may be only 4-byte aligned: 4-byte copies then
      const int aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16
                          == 0;
      return launch_f32_dim(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, scale,
                            causal, window, aligned, s);
    }
    case 1:
      return launch_tc_dim(q, k, v, o, l, B, Hq, Hkv, Sq, Sk, D, scale,
                           causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
