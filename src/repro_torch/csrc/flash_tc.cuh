// The tensor-core building blocks shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): inline PTX for cp.async,
// ldmatrix, mma.sync.m16n8k16 (bf16 in, fp32 accumulate) and ex2, the
// bf16x2 conversion of an accumulator fragment, and the loader of a padded
// 64-row bf16 tile; and, for the fp32 kernels, split TF32 on
// mma.sync.m16n8k8 (below, "split TF32"), their fragment loads from fp32
// tiles and the loader of such a tile.
//
// Fragment layouts of mma.m16n8k16.row.col, for lane = 4·g + t (g the
// group, t the thread in the group):
//   A (16×16, 4 regs of bf16x2): a0 (row g, cols 2t..2t+1), a1 (row g+8,
//     same cols), a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..);
//   B (16×8, 2 regs): b0 (k rows 2t..2t+1, col g), b1 (k rows 2t+8.., g);
//   C (16×8 fp32, 4 regs): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So the C fragments of two neighbouring 8-column tiles, converted to
// bf16x2 pairs, are the A fragment of their 16×16 tile: a product's output
// feeds the next product from registers.
//
// Every staged tile is [64][D + 8] bf16, row-major: the 16 bytes of padding
// a row put the eight rows one ldmatrix phase reads into eight distinct
// 16-byte bank groups (the row stride is ≡ 16 mod 128 bytes), and keep each
// row 16-byte aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                  // rows of a staged q- or k-tile
constexpr int kWarps = 4;                  // 16 rows of the tile each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;          // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// m16 tiles (16 rows each) a warp owns: two at D ≤ 64, so each fragment
// loaded from shared memory feeds twice the mma and a 4-warp block owns 128
// rows; one above (D = 112, 128, 160), where the accumulators of two would
// not fit in registers
template <int D>
__host__ __device__ constexpr int m_tiles() {
  return D <= 64 ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int ld() {   // row stride of a staged tile
  return D + 8;
}
template <int D>
__host__ __device__ constexpr int tile() {
  return kRows * ld<D>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; zero-filled when !ok (the
// source size is 0 and nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global → shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8×8 bf16 matrices at the shared-memory byte address addr; lane l
// gives the address of row l % 8 of matrix l / 8, and gets (row g, cols
// 2t, 2t+1) of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed: lane gets (rows 2t, 2t+1, col g)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a · b on the tensor cores, fp32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest even into one bf16x2 register, lo in the low
// half (the lower column of a fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the A fragment of a 16×16 tile from the C fragments of its two 8-column
// halves, rounded to bf16
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 2^x on the special-function unit (ex2.approx, 2 ulp; results below
// 2^-126 flush to zero, where p adds nothing a bf16 product keeps)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// Byte offsets of a lane's row address into a staged tile (row stride ld
// elements) for the three ldmatrix uses, at the tile's row 0, column 0;
// the sub-tile at row r0, column c0 adds at(r0, c0, ld), a constant in
// the unrolled loops, so each ldmatrix takes [register + immediate]:
//   A of rows r0..r0+15 × cols c0..c0+15 (non-transposed);
__device__ __forceinline__ uint32_t a_lane(int lane, int ld) {
  return 2u * ((lane & 15) * ld + (lane >> 4) * 8);
}
//   B of two 8-column n-tiles whose n runs along the tile's rows r0..r0+15
//   and k along its columns c0..c0+15 (ldsm_x4: regs 0, 1 the first
//   n-tile's b0, b1; regs 2, 3 the second's);
__device__ __forceinline__ uint32_t bn_lane(int lane, int ld) {
  return 2u * ((lane & 7) + ((lane >> 4) << 3)) * ld +
         2u * (((lane >> 3) & 1) * 8);
}
//   B of two 8-column n-tiles whose k runs along the tile's rows r0..r0+15
//   and n along its columns c0..c0+15 (ldsm_x4_t, same register order).
__device__ __forceinline__ uint32_t bk_lane(int lane, int ld) {
  return 2u * ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
         2u * ((lane >> 4) * 8);
}
__host__ __device__ constexpr uint32_t at(int r0, int c0, int ld) {
  return 2u * (r0 * ld + c0);
}

// the H100's opt-in shared memory a block
constexpr size_t kSmemOptIn = 232448;

// rows r0..r0+63 of a contiguous (S, D) bf16 matrix into a staged tile,
// 16 bytes a thread a step; rows past S are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S, int tid) {
  constexpr int kChunks = D / 8;           // 16-byte chunks a row
  static_assert(kRows * kChunks % kThreads == 0, "whole steps");
#pragma unroll
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * ld<D>() + col,
               src + (size_t)(ok ? r0 + r : 0) * D + col, ok);
  }
}

// ---- split TF32: the fp32 kernels ------------------------------------------
//
// An fp32 product a·b runs as three TF32 products on the tensor cores,
// a_big·b_small + a_small·b_big + a_big·b_big, accumulated in fp32: x_big
// is x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero
// (cvt.rna.tf32.f32's rounding), and x_small = x − x_big, exact in fp32,
// rounded the same way.  What is dropped is a_small·b_small and the
// rounding of the small parts, about 2^-22 of |a·b| each, so a product
// keeps fp32-level error (PyTorch's memory-efficient attention does the
// same, as CUTLASS's OpMultiplyAddFastF32, with a truncated big part).
// The tensor cores read a tf32 operand's upper 19 bits and ignore the low
// 13, so the rounding is "add half of the dropped range" for small, and
// "add it and clear the low bits" for big, whose exact value x − big
// needs: 4 integer and fp32 operations an element.
//
// mma.m16n8k8.row.col with tf32 operands, lane = 4·g + t:
//   A (16×8): a0 (row g, col t), a1 (row g+8, col t), a2 (row g, col t+4),
//     a3 (row g+8, col t+4);
//   B (8×8, k × n): b0 (k row t, col g), b1 (k row t+4, col g);
//   C (16×8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// Two relabellings make every fragment a plain load or a register:
//   * keys: in an 8-key step of a product over keys (P·V, dS·K, Pᵀ·dO,
//     dSᵀ·Q) A column t is key 2t and column t+4 key 2t+1, so the score
//     fragment (c0, c2, c1, c3) of an 8-key n-tile is that step's A
//     fragment, and B row t reads the other operand's row 2t, row t+4 its
//     row 2t+1;
//   * columns: the two n-tiles 2j, 2j+1 of such a product cover the 16
//     head-dim columns from 16j, column g of n-tile 2j being 16j + 2g and of
//     2j+1 16j + 2g + 1, so a lane's B fragments of both are two 8-byte
//     loads (rows 2t and 2t+1, columns 16j + 2g, + 1), and its C fragments
//     hold columns 16j + 4t .. 16j + 4t + 3 of rows g and g + 8: one 16-byte
//     store a row.
// Products over the head dim (q·kᵀ, dO·vᵀ and their transposes) take A
// and B from rows of fp32 tiles as laid out, k = d.  Every fp32 tile is
// [rows][D + 4] floats: with D a multiple of 16 the row stride is 4·odd
// floats, so the eight rows g of a 4-byte fragment load (g·(D + 4) + t)
// and the four row pairs 2t, 2t+1 of an 8-byte one (8t + 2g + {0, 1}, a
// half-warp at a time) fall in 32 distinct banks, and rows stay 16-byte
// aligned for cp.async.

template <int D>
__host__ __device__ constexpr int ld_f32() {   // row stride of an fp32 tile
  return D + 4;
}

// fp32 shared-memory bytes of a block: `res` resident tiles of
// 16·`warps` rows (the block's own rows: q; q and dO; k and v), two
// streamed tiles (k and v; q and dO) of `step` rows double-buffered, and
// `stats` floats a streamed row, double-buffered too (the dk/dv kernel's
// lse and delta)
template <int D>
__host__ __device__ constexpr size_t f32_smem(int res, int warps, int step,
                                              int stats) {
  return sizeof(float) * ((size_t)(res * 16 * warps + 4 * step) * ld_f32<D>()
                          + 2 * stats * step);
}
// warps of an fp32 kernel: 8 (a 128-row block) where its resident tiles
// leave room for a 16-row step, else 4
template <int D>
__host__ __device__ constexpr int f32_warps(int res, int stats) {
  return f32_smem<D>(res, 8, 16, stats) <= kSmemOptIn ? 8 : 4;
}
// rows a streamed step of an fp32 kernel: the largest of 64, 32, 16 that
// fits beside the resident tiles
template <int D>
__host__ __device__ constexpr int f32_step(int res, int stats) {
  return f32_smem<D>(res, f32_warps<D>(res, stats), 64, stats) <= kSmemOptIn
             ? 64
         : f32_smem<D>(res, f32_warps<D>(res, stats), 32, stats) <=
                 kSmemOptIn
             ? 32
             : 16;
}

// x in split TF32 (above): big rounded and cleared, small with half of
// its dropped range added
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// c += a · b on the tensor cores, tf32 operands, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 fragment in split TF32: A (4 registers) or B (2) of one n-tile
template <int N>
struct Frag {
  uint32_t big[N], small[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split_frag(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], f.big[i], f.small[i]);
  return f;
}

// c += a · b in split TF32: the two small terms first, then big · big
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// acc += part, in fp32: a product over many steps sums each step in a
// fresh tensor-core accumulator and adds it here, because the tensor cores
// truncate where they add (to the accumulator's alignment) and the error
// of a long chain of mma into one accumulator grows with its length, past
// fp32's round-off (dk and dv over 1024 query rows in one chain failed
// chip_smoke.py's fp32 gate)
__device__ __forceinline__ void add_to(float (&acc)[4],
                                       const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// acc = part for a sum's first chunk, acc += part for the others (the
// chunk index is a compile-time constant in the unrolled loops)
__device__ __forceinline__ void set_or_add(float (&acc)[4],
                                           const float (&part)[4],
                                           bool first) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = first ? part[e] : acc[e] + part[e];
}

// k-steps of the head dim a score product (q·kᵀ, dO·vᵀ and their
// transposes) sums in one chain before add_to: all of D up to 128, half
// of it above (at D = 256 one chain of 32 k-steps left dq over
// chip_smoke.py's fp32 gate)
template <int D>
__host__ __device__ constexpr int score_chunk() {
  return D <= 128 ? D / 8 : D / 16;
}

// A (k = head dim) of rows r..r+15, cols c..c+7 of an fp32 tile, from
// p = &tile[(r + g)·LD + c + t]
template <int LD>
__device__ __forceinline__ Frag<4> lda_f32(const float* p) {
  const float x[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
  return split_frag(x);
}

// B (k = head dim) of the n-tile of rows n..n+7, cols c..c+7, from
// p = &tile[(n + g)·LD + c + t]
__device__ __forceinline__ Frag<2> ldb_f32(const float* p) {
  const float x[2] = {p[0], p[4]};
  return split_frag(x);
}

// B (k = rows) of the n-tile pair 2j, 2j+1 over the 8-row step from k0
// and the 16 columns from c0 (the relabellings above), from
// p = &tile[(k0 + 2t)·LD + c0 + 2g]: .x of each load is n-tile 2j's, .y
// 2j+1's
template <int LD>
__device__ __forceinline__ void ldb_pair_f32(Frag<2>& lo, Frag<2>& hi,
                                             const float* p) {
  const float2 r0 = *reinterpret_cast<const float2*>(p);
  const float2 r1 = *reinterpret_cast<const float2*>(p + LD);
  const float a[2] = {r0.x, r1.x}, b[2] = {r0.y, r1.y};
  lo = split_frag(a);
  hi = split_frag(b);
}

// the A fragment (k = keys) of an 8-key step from the scores' C fragment
// of the same 8 keys (the key relabelling), in split TF32
__device__ __forceinline__ Frag<4> a_from_c_f32(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split_frag(x);
}

// rows r0..r0+R−1 of a contiguous (S, D) fp32 matrix into an fp32 tile,
// rows past S zero-filled; 16 bytes a copy where every base pointer of the
// call is 16-byte aligned (`aligned`), else 4 (a view's base may be only
// 4-byte aligned; D is a multiple of 16, so rows keep the base's offset)
template <int D, int R, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int r0, int S, int tid,
                                              bool aligned) {
  constexpr int kChunks = D / 4;           // 16-byte chunks a row
#pragma unroll
  for (int c = tid; c < R * kChunks; c += NT) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const bool ok = r0 + r < S;
    float* d = dst + r * ld_f32<D>() + col;
    const float* s = src + (size_t)(ok ? r0 + r : 0) * D + col;
    if (aligned) {
      cp_async16(d, s, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async4(d + e, s + e, ok);
    }
  }
}

}  // namespace flash_tc
