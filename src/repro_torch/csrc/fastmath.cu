// The paper's §5.2.2 PE special-function unit as an elementwise kernel for
// Hopper (sm_90a), compiled into the port's one library
// (repro_torch/kernels/cudalib.py) and bound through a plain C interface.
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernel
//   repro/kernels/fastmath/kernel.py::fastmath_2d (_fastmath_kernel) — the
//     bit-trick exp, inverse square root and reciprocal (one Newton step
//     where the op has one), with the optional accuracy-recovery multiplier.
// The arithmetic is routing.cuh's fast_exp / fast_rsqrt / fast_recip, the
// same definitions the routing kernels' use_approx mode runs, with recovery
// as a template parameter.
//
// Bound by bytes: 4 bytes read and 4 written per element for a handful of
// integer and fp32 operations, so 8 bytes an element over 3.35 TB/s
// (0.160 ms at 2^26 elements).  The TPU kernel cuts the array into
// (block_rows, block_cols) slabs for VMEM; here the array is one flat range
// and a grid-stride loop walks it with consecutive threads on consecutive
// elements (coalesced), a few blocks per SM.

#include "routing.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// op codes shared with kernels/fastmath/kernel.py
enum Op { kExp = 0, kInvSqrt = 1, kReciprocal = 2 };

template <int OP, bool RECOVER>
__global__ void __launch_bounds__(kThreads)
fastmath_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = __ldg(x + i);
    float y;
    if (OP == kExp) {
      y = routing::fast_exp<RECOVER>(v);
    } else if (OP == kInvSqrt) {
      y = routing::fast_rsqrt<RECOVER>(v);
    } else {
      y = routing::fast_recip<RECOVER>(v);
    }
    out[i] = y;
  }
}

template <int OP>
void launch(const float* x, float* out, long long n, bool recover,
            cudaStream_t s) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  if (recover) {
    fastmath_kernel<OP, true><<<(int)blocks, kThreads, 0, s>>>(x, out, n);
  } else {
    fastmath_kernel<OP, false><<<(int)blocks, kThreads, 0, s>>>(x, out, n);
  }
}

}  // namespace

extern "C" {

// out[i] = op(x[i]) for i < n, fp32.
int fastmath_apply(const float* x, float* out, long long n, int op,
                   int recover, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kExp: launch<kExp>(x, out, n, recover != 0, s); break;
    case kInvSqrt: launch<kInvSqrt>(x, out, n, recover != 0, s); break;
    case kReciprocal: launch<kReciprocal>(x, out, n, recover != 0, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
