// The PrimaryCaps convolution (9×9, stride 2, VALID, with bias) in fp32 for
// Hopper (sm_90a), as an implicit GEMM in split TF32 on the tensor cores,
// compiled into the port's one library (repro_torch/kernels/cudalib.py) and
// bound through a plain C interface.
//
// Source note
// -----------
// Replaces no TPU kernel: the JAX package computes this convolution with
// lax.conv_general_dilated and leaves it to XLA
// (repro/core/capsule_layers.py::primary_caps_forward).  It was added
// because the convolution is most of the serving path's device time: in
// fp32 with TF32 off, cuDNN runs it as an FFMA implicit GEMM on the CUDA
// cores (sm80_xmma_fprop_implicit_gemm_indexed_f32f32_*) at about a quarter
// of the card's 67 TFLOP/s fp32 rate.
//
// What bounds it: operations.  As a GEMM, M = B·H_o·W_o output positions,
// N = C_out and K = k·k·C_in: Caps-MN1 at B = 100 is M = 3,600, N = 256,
// K = 20,736, 38.2 GFLOP against ~66 MB of activation, weight and output
// (~20 µs at 3.35 TB/s): 0.232 ms at split TF32's 165 TFLOP/s (a third of
// the 495 TFLOP/s TF32 rate), 0.570 ms at the FFMA rate.
//
// What the design does about it:
//   * split TF32 (flash_tc.cuh): x = big + small, big and small TF32, and
//     a·b as a_small·b_big + a_big·b_small + a_big·b_big on
//     mma.sync.m16n8k8, summed in fp32, which keeps fp32-level error where
//     one TF32 product would not;
//   * every tensor-core sum runs over one stage of 32 K terms into a fresh
//     accumulator, added to the fp32 sums in registers after the stage: the
//     tensor cores truncate where they add, and a chain over thousands of
//     terms drifts past fp32's round-off;
//   * the weight is relaid to (C_out, kh, kw, C_in), K-major with C_in
//     contiguous, and split into big and small once a call by
//     caps_conv_split_weight (21.2 MB in, 42.5 MB out at Caps-MN1), so only
//     the activation is split in registers, once a fragment;
//   * A is gathered straight from the NHWC activation, 16 bytes a cp.async
//     (a stage is one (kh, kw) tap and 32 channels: a 128-byte run a row),
//     into a ring of kStages stages, with B's two planes beside it; rows
//     are swizzled by 16-byte chunk so that ldmatrix reads are free of bank
//     conflicts, and ldmatrix.x4 yields a TF32 A fragment or two B
//     fragments at once;
//   * the output tiles alone (29 × 2 of 128 × 128 at Caps-MN1) fill fewer
//     than half of the 132 SMs, so K is split over the grid's z
//     (kernel.py::caps_conv_geometry picks the split from M, N and K), and
//     caps_conv_reduce adds the partial sums in split order, then the bias:
//     no atomics, so a call's output repeats bit for bit.
//
// mma.sync and not wgmma: every 32 K terms the fresh accumulator is added
// into the fp32 sums, which needs the products in registers at that point;
// wgmma's asynchronous accumulators would need a wait every stage, and the
// split keeps both a fresh and a running accumulator (2 × 64 registers a
// thread at a 32 × 64 warp tile).  The kernel fits in one 256-thread block
// an SM.
//
// Layouts (row-major, contiguous): x (B, H, W, C_in); w (C_out, C_in, k, k)
// as PyTorch stores a conv weight; bias (C_out); out (B, H_o, W_o, C_out),
// i.e. (M, N); wsplit (2, C_out, k·k·C_in) scratch (big, then small, as
// TF32 bit patterns); partial (splits, M, N) scratch where splits > 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

using flash_tc::cp_async16;
using flash_tc::cp_async_commit;
using flash_tc::cp_async_wait;
using flash_tc::kSmemOptIn;
using flash_tc::ldsm_x4;
using flash_tc::mma_tf32;
using flash_tc::smem_u32;
using flash_tc::split_tf32;

constexpr int kThreads = 256;     // 8 warps: 4 along M × 2 along N
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kBM = 128;          // rows a block: a warp 2 m16 tiles
constexpr int kBK = 32;           // K terms a stage: 8 16-byte chunks a row
constexpr int kSteps = kBK / 8;   // k8 steps a stage
constexpr int kStages = 4;        // the cp.async ring
constexpr int kMinStagesPerSplit = 8;
constexpr int kMaxTaps = 256;     // k·k: the weight split's tile, 32 KB

// columns a block at nt 8-column n-tiles a warp
__host__ __device__ constexpr int block_n(int nt) { return kWarpsN * 8 * nt; }
// floats of one stage: A (kBM rows) and B's big and small planes
__host__ __device__ constexpr int stage_floats(int nt) {
  return kBK * (kBM + 2 * block_n(nt));
}
__host__ __device__ constexpr size_t conv_smem(int nt) {
  return sizeof(float) * kStages * stage_floats(nt);
}
static_assert(conv_smem(8) == 196608 && conv_smem(4) == 131072 &&
                  conv_smem(8) <= kSmemOptIn,
              "the ring fits a block");

// c = a · b on the tensor cores from a zero accumulator (a stage's first
// product: the fresh accumulator)
__device__ __forceinline__ void mma_tf32_first(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// w (N, C_in, T) with T = k·k taps → ws (2, N, T, C_in): big, then small.
// One block a (32 channels, output channel): the 32·T floats of the block
// are contiguous in w; read in order, written with the channel fastest
// (128-byte runs).  The tile's row stride T is odd at k = 9, so the
// transposed reads hit 32 distinct banks.
__global__ void __launch_bounds__(kThreads)
caps_conv_split_weight(const float* __restrict__ w, uint32_t* __restrict__ ws,
                       int N, int Cin, int T) {
  extern __shared__ float tile[];           // [32 channels][T taps]
  const int c0 = blockIdx.x * kBK, o = blockIdx.y, n = kBK * T;
  const float* src = w + ((size_t)o * Cin + c0) * T;
  for (int i = threadIdx.x; i < n; i += kThreads) tile[i] = src[i];
  __syncthreads();
  uint32_t* big = ws + (size_t)o * T * Cin + c0;
  uint32_t* small = big + (size_t)N * T * Cin;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int p = j / kBK, c = j - p * kBK;
    uint32_t b, s;
    split_tf32(tile[c * T + p], b, s);
    big[(size_t)p * Cin + c] = b;
    small[(size_t)p * Cin + c] = s;
  }
}

// The implicit GEMM.  Block (bx, by, z): output rows bx·128 .. +127, columns
// by·BN .. +BN−1, the z-th of gridDim.z equal runs of `sps` stages of K.
// Warp (wm, wn) owns rows wm·32 .. +31 (two m16 tiles) and columns
// wn·8·NT .. +8·NT−1 (NT n8 tiles).  With one split the bias is added and
// the rows go to out; else the partial sums go to out + z·M·N.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
caps_conv_kernel(const float* __restrict__ x, const uint32_t* __restrict__ ws,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int N, int H, int W, int Cin, int Wo, int HWo, int k,
                 int stride, int sps) {
  constexpr int BN = block_n(NT);
  constexpr int kSlot = stage_floats(NT);
  constexpr int kRowsB = BN / 32;           // B rows a thread loads a plane
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int K = k * k * Cin, chunks = Cin / kBK;
  const int g0 = blockIdx.z * sps;

  // the loader: 16-byte chunk lc of rows lr + 32·i, stored at its swizzled
  // place (chunk lc ^ (row & 7)); rows past M are zero-filled
  const int lc = tid & 7, lr = tid >> 3;
  const int lsw = 4 * (lc ^ (lr & 7));
  const float* arow[kBM / 32];
  bool aok[kBM / 32];
#pragma unroll
  for (int i = 0; i < kBM / 32; ++i) {
    const int m = m0 + lr + 32 * i;
    aok[i] = m < M;
    const int mm = aok[i] ? m : 0;
    const int b = mm / HWo, r = mm - b * HWo;
    const int oh = r / Wo, ow = r - oh * Wo;
    arow[i] = x + ((size_t)(b * H + oh * stride) * W + ow * stride) * Cin +
              4 * lc;
  }
  const uint32_t* brow = ws + (size_t)(n0 + lr) * K + 4 * lc;
  const size_t plane = (size_t)N * K;

  auto load = [&](int slot, int stage) {
    const int tap = stage / chunks, c0 = (stage - tap * chunks) * kBK;
    const int kh = tap / k, kw = tap - kh * k;
    const size_t aoff = (size_t)(kh * W + kw) * Cin + c0;
    float* as = smem + slot * kSlot;
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i)
      cp_async16(as + (lr + 32 * i) * kBK + lsw, arow[i] + aoff, aok[i]);
    float* bs = as + kBM * kBK;
    const size_t boff = (size_t)stage * kBK;
#pragma unroll
    for (int i = 0; i < kRowsB; ++i) {
      const uint32_t* s = brow + (size_t)32 * i * K + boff;
      cp_async16(bs + (lr + 32 * i) * kBK + lsw, s, true);
      cp_async16(bs + (BN + lr + 32 * i) * kBK + lsw, s + plane, true);
    }
  };

  // ldmatrix lanes: lane l gives row l & 7 of matrix l >> 3.  A: matrices
  // (rows +0, chunk 2s), (rows +8, chunk 2s), (+0, 2s+1), (+8, 2s+1) are
  // a0..a3 of k-step s; B: (n-tile 2p, chunk 2s), (2p, 2s+1), (2p+1, 2s),
  // (2p+1, 2s+1) are b0, b1 of n-tiles 2p and 2p+1.  Every row read is
  // ≡ lane & 7 mod 8, so its chunk sits at chunk ^ (lane & 7).
  const int mat = lane >> 3, sw = lane & 7;
  const int a_row = wm * 32 + sw + 8 * (mat & 1), a_half = mat >> 1;
  const int b_row = wn * 8 * NT + 8 * (mat >> 1) + sw, b_half = mat & 1;
  const int g = lane >> 2, t = lane & 3;

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < sps) load(s, g0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < sps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                  // stage it landed; it − 1 consumed
    const int next = it + kStages - 1;
    if (next < sps) load(next % kStages, g0 + next);
    cp_async_commit();
    const uint32_t base = smem_u32(smem + (it % kStages) * kSlot);
    const uint32_t a_base = base + 4u * (a_row * kBK);
    const uint32_t b_base = base + 4u * ((kBM + b_row) * kBK);
    float fresh[2][NT][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t r[4];
        ldsm_x4(r, a_base + 4u * (16 * mi * kBK +
                                  4 * ((2 * ks + a_half) ^ sw)));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(r[e]), ab[mi][e], as[mi][e]);
      }
      uint32_t bb[NT][2], bsm[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        const uint32_t at =
            b_base + 4u * (16 * p * kBK + 4 * ((2 * ks + b_half) ^ sw));
        uint32_t r[4];
        ldsm_x4(r, at);
        bb[2 * p][0] = r[0];
        bb[2 * p][1] = r[1];
        bb[2 * p + 1][0] = r[2];
        bb[2 * p + 1][1] = r[3];
        ldsm_x4(r, at + 4u * BN * kBK);
        bsm[2 * p][0] = r[0];
        bsm[2 * p][1] = r[1];
        bsm[2 * p + 1][0] = r[2];
        bsm[2 * p + 1][1] = r[3];
      }
      // the two small terms first, then big · big
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) {
          if (ks == 0)
            mma_tf32_first(fresh[mi][nj], as[mi], bb[nj][0], bb[nj][1]);
          else
            mma_tf32(fresh[mi][nj], as[mi], bb[nj][0], bb[nj][1]);
          mma_tf32(fresh[mi][nj], ab[mi], bsm[nj][0], bsm[nj][1]);
          mma_tf32(fresh[mi][nj], ab[mi], bb[nj][0], bb[nj][1]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += fresh[mi][nj][e];
  }
  cp_async_wait<0>();

  // C fragment: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
  const bool one = gridDim.z == 1;
  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int nj = 0; nj < NT; ++nj) {
    const int col = n0 + wn * 8 * NT + 8 * nj + 2 * t;
    const float2 bv = one ? *reinterpret_cast<const float2*>(bias + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + 16 * mi + g + 8 * h;
        if (row < M)
          *reinterpret_cast<float2*>(dst + (size_t)row * N + col) =
              make_float2(acc[mi][nj][2 * h] + bv.x,
                          acc[mi][nj][2 * h + 1] + bv.y);
      }
  }
}

// out = Σ_z partial[z] in z order, then + bias; 4 columns a thread
__global__ void __launch_bounds__(kThreads)
caps_conv_reduce(const float4* __restrict__ partial,
                 const float* __restrict__ bias, float4* __restrict__ out,
                 int mn4, int N, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= mn4) return;
  float4 s = partial[i];
  for (int z = 1; z < splits; ++z) {
    const float4 v = partial[(size_t)z * mn4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float4 b = *reinterpret_cast<const float4*>(bias + (4 * i) % N);
  out[i] = make_float4(s.x + b.x, s.y + b.y, s.z + b.z, s.w + b.w);
}

template <int NT>
int launch_conv(const float* x, const uint32_t* ws, const float* bias,
                float* dst, int M, int N, int H, int W, int Cin, int Wo,
                int HWo, int k, int stride, int splits, int sps,
                cudaStream_t stream) {
  constexpr size_t smem = conv_smem(NT);
  static bool configured = false;  // once per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        caps_conv_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((M + kBM - 1) / kBM, N / block_n(NT), splits);
  caps_conv_kernel<NT><<<grid, kThreads, smem, stream>>>(
      x, ws, bias, dst, M, N, H, W, Cin, Wo, HWo, k, stride, sps);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// out (B, H_o, W_o, C_out) = conv(x, w, stride, VALID) + bias, fp32, for x
// (B, H, W, C_in) NHWC and w (C_out, C_in, k, k), all contiguous and
// 16-byte aligned; wsplit (2, C_out, k·k·C_in) and, where splits > 1,
// partial (splits, M, C_out) are the caller's scratch.  At the geometry
// kernel.py::caps_conv_geometry gives: C_in a multiple of 32, C_out of 64;
// `nt` 8 where C_out is a multiple of 128, else 4; `splits` dividing the
// k·k·C_in / 32 stages into runs of at least kMinStagesPerSplit; `smem`
// the ring's bytes (conv_smem(nt)).  Any other geometry is refused.
int caps_conv_forward(const void* x, const void* w, const void* bias,
                      void* wsplit, void* partial, void* out, int B, int H,
                      int W, int Cin, int Cout, int k, int stride, int nt,
                      int splits, int smem, void* stream) {
  if (B < 1 || k < 1 || k * k > kMaxTaps || stride < 1 || H < k || W < k ||
      Cin < kBK || Cin % kBK != 0 || Cout < 64 || Cout % 64 != 0 ||
      nt != (Cout % 128 == 0 ? 8 : 4) || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int stages = k * k * Cin / kBK;
  if (stages % splits != 0 || stages / splits < kMinStagesPerSplit ||
      smem < 0 || (size_t)smem != conv_smem(nt))
    return (int)cudaErrorInvalidValue;
  const int Ho = (H - k) / stride + 1, Wo = (W - k) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  if (M * Cout * splits >= (1LL << 31) ||
      (long long)B * H * W * Cin >= (1LL << 31) ||
      (splits > 1 && partial == nullptr) || !aligned16(x) ||
      !aligned16(wsplit) || !aligned16(out) || !aligned16(bias) ||
      (splits > 1 && !aligned16(partial)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* ws = static_cast<uint32_t*>(wsplit);
  caps_conv_split_weight<<<dim3(Cin / kBK, Cout), kThreads,
                           sizeof(float) * kBK * k * k, s>>>(
      static_cast<const float*>(w), ws, Cout, Cin, k * k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* xp = static_cast<const float*>(x);
  const float* bp = static_cast<const float*>(bias);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const int sps = stages / splits;
  const int rc = nt == 8
      ? launch_conv<8>(xp, ws, bp, dst, (int)M, Cout, H, W, Cin, Wo, Ho * Wo,
                       k, stride, splits, sps, s)
      : launch_conv<4>(xp, ws, bp, dst, (int)M, Cout, H, W, Cin, Wo, Ho * Wo,
                       k, stride, splits, sps, s);
  if (rc != 0 || splits == 1) return rc;
  const int mn4 = (int)(M * Cout / 4);
  caps_conv_reduce<<<(mn4 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float4*>(partial), bp, static_cast<float4*>(out), mn4,
      Cout, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
