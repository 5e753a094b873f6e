// The tensor-core building blocks shared by the bf16 flash-attention
// kernels (flash_attention.cu, flash_attention_bwd.cu): inline PTX for
// cp.async, ldmatrix, mma.sync.m16n8k16 (bf16 in, fp32 accumulate) and
// ex2, the bf16x2 conversion of an accumulator fragment, and the loader of
// a padded 64-row tile.
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

}  // namespace flash_tc
