// Stage-split routing kernels for Hopper (sm_90a): the kernels of sharded
// dynamic routing, compiled into the port's one library
// (repro_torch/kernels/cudalib.py builds every source with nvcc) and bound
// through a plain C interface.
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernels
//   repro/kernels/routing/kernel.py::routing_stage_votes (_stage_votes_kernel)
//     — STAGE 1, Eq.2: s[b,h,:] = Σ_l c[l,h]·û[b,l,h,:];
//   repro/kernels/routing/kernel.py::routing_stage_update
//     (_stage_update_kernel) — STAGE 2, Eq.3 v = squash(s) and Eq.4
//     db[l,h] = Σ_b Σ_c û[b,l,h,c]·v[b,h,c];
//   repro/kernels/routing/kernel.py::routing_stage_update_fold
//     (_stage_update_fold_kernel) — STAGE 2 plus b_new = b + db and the next
//     iteration's couplings c = softmax_H(b_new).
// kernels/routing/ops.py::dynamic_routing_fused_sharded runs them once per
// iteration each, with the collectives of the paper's Table 2 between them
// (psum of s over L's axis, of db over B's axis, the softmax's max and sum
// over H's axis).
//
// All three are bound by bytes on this card: each reads û once (73.7 MB
// fp32 at Caps-MN1, B=100) and does 2 fp32 operations per vote element, far
// below the ~20 FLOP/byte at which fp32 arithmetic (67 TFLOP/s) would take
// over from HBM (3.35 TB/s).  The bound is each input read once and each
// output written once over 3.35 TB/s (about 0.022 ms per stage at
// Caps-MN1); the measured times against it are in PERF.md.
//
// The TPU grid walks the L-tiles in order on one core, the output block
// resident across the steps.  These kernels keep no per-tile state (no int8
// scales, no early-exit flags), so their grids need not follow the
// reference's l_tile (kernel.py keeps it for its error surface) and are sized
// for the card's 132 SMs instead:
//
//   votes kernel    one block per (batch row b, L-chunk); kernel.py's
//                   stage_chunks cuts L so that B·chunks is near 8 blocks
//                   per SM, as em_stage_stats does.  Threads run over h·c,
//                   so a warp reads consecutive votes of one row; each
//                   thread sums its chunk's rows in order into one slot of a
//                   (chunks, B, H, C) partial buffer.
//   reduce kernel   one thread per (b, h, c) sums the partials in chunk
//                   order: deterministic, no float atomics.
//   squash kernel   v = squash(s), a thread an element (a row's C lanes
//                   sum |s|² by an xor butterfly where C is a power of two
//                   up to 32), written once; it lets the update kernel
//                   start at once (programmatic dependent launch).
//   update kernel   Eq.4 and the fold, at the geometry of
//                   kernels/routing/ops.py::stage_update_geometry,
//                   launched as the squash kernel's programmatic
//                   dependent: it issues its first û loads, then waits for
//                   v.  A block owns `rows` consecutive l rows with all of
//                   H.  A thread owns a run of consecutive (l, h, c) votes
//                   — 4 fp32 or 8 bf16, 16 bytes; one element where H·C
//                   does not split into runs or û is not 16-byte aligned —
//                   for one of `slices` batch slices: B splits over the
//                   block's warps, slice s taking the rows [s·B/S,
//                   (s+1)·B/S) and summing them in order.  Where a row
//                   holds more runs than a block has threads, the block
//                   (one row) walks its columns in `passes` segments, a
//                   run of each a thread.  The next runs
//                   are in flight while one is used: two in registers, or,
//                   for slices of 48 rows and more, four in a ring of
//                   shared-memory slots filled by cp.async (no registers;
//                   40 a thread keep three 512-thread blocks on an SM).  v
//                   is read from shared memory: `chunk_rows` batch rows of
//                   every slice at a time (64 KB of v at Caps-MN1, 397 KB
//                   at Caps-EN3), one TMA bulk copy a slice, in two
//                   buffers completing on mbarriers, the next staging in
//                   flight while this one is used.  Then the slices'
//                   partial sums meet in shared memory in slice order, and
//                   one thread per (l, h) sums its C terms in order (over
//                   the passes, the sum so far kept in shared memory):
//                   fixed orders, no float atomics, two calls equal bit
//                   for bit.
//                   FOLD: b_new = b + db (b copied in while the block
//                   streams), and the Eq.5 softmax over H — block-local,
//                   since a block owns whole rows with all of H: a row's
//                   max and sum by a thread, the exponentials and
//                   divisions by a thread an element.  The geometry trades
//                   rows a block (the staged v's bytes, which read L2)
//                   against the SMs that get a block and the û bytes in
//                   flight an SM.
//
// Arithmetic follows repro/kernels/routing/kernel.py in fp32: û streams as
// fp32 or bf16 (widened exactly), the squash and the softmax are
// routing.cuh's squash_row and softmax_row element by element (the §5.2.2
// fast helpers in approx mode, exact squash dividing by sqrt(|s|² +
// 1e-9)), and only the order of the sums differs from the plain PyTorch
// versions.

#include "routing.cuh"

namespace {

using routing::fast_exp;
using routing::fast_recip;
using routing::fast_rsqrt;
using routing::kReduceThreads;
using routing::load_u;

constexpr int kVotesMaxThreads = 1024;
// the update kernel's blocks: at most 512 threads, three of them an SM, so
// at most 40 registers a thread (ops.py's STAGE_UPDATE_THREADS and
// STAGE_UPDATE_REGS)
constexpr int kUpdateThreads = 512;
constexpr int kUpdateBlocksPerSm = 3;
// û runs in flight a thread, in registers or in a ring of shared memory
// (ops.py's STAGE_UPDATE_RING)
constexpr int kRingRegisters = 2;
constexpr int kRingShared = 4;
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// ---- STAGE 1: partial Eq.2 sums, one block per (b, L-chunk) ---------------

template <typename T>
__global__ void __launch_bounds__(kVotesMaxThreads)
stage_votes_kernel(const T* __restrict__ u, const float* __restrict__ c,
                   float* __restrict__ partial, int B, int L, int H, int C,
                   int chunk_rows) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int HC = H * C;
  const int l0 = j * chunk_rows;
  const int l1 = min(L, l0 + chunk_rows);
  float* out = partial + ((size_t)j * B + b) * HC;
  for (int hc = threadIdx.x; hc < HC; hc += blockDim.x) {
    const int h = hc / C;
    size_t p = ((size_t)b * L + l0) * HC + hc;
    const float* cp = c + (size_t)l0 * H + h;
    float acc = 0.0f;
#pragma unroll 4
    for (int l = l0; l < l1; ++l) {
      acc = __fadd_rn(acc, __fmul_rn(__ldg(cp), load_u(u, p, 1.0f)));
      p += HC;
      cp += H;
    }
    out[hc] = acc;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
stage_votes_reduce_kernel(const float* __restrict__ partial,
                          float* __restrict__ s, int chunks, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.0f;
  for (int j = 0; j < chunks; ++j)
    acc = __fadd_rn(acc, partial[(size_t)j * n + idx]);
  s[idx] = acc;
}

// ---- STAGE 2: Eq.3, Eq.4 (+ the folded Eq.5) ------------------------------
//
// FOLD = false: db[l,h] = Σ_c Σ_b û·v.
// FOLD = true:  b_out[l,h] = b[l,h] + db, c_out[l,:] = softmax_H(b_out[l,:]).
// stage_squash_kernel writes v; the update kernel, launched as its
// programmatic dependent, issues its first û loads before it waits for it.

struct UpdateArgs {
  const void* u;
  const float* s;
  float* v;
  float* db;
  const float* b;
  float* b_out;
  float* c_out;
  int B, L, H, C;
  // ops.py::stage_update_geometry
  int rows, slices, passes, chunk_rows, chunks;
};

// the columns of a row that one pass covers: the row's runs of V split
// evenly over the passes
__device__ __host__ __forceinline__ int pass_cols(const UpdateArgs& a,
                                                  int V) {
  const int runs = a.H * a.C / V;
  return (runs + a.passes - 1) / a.passes * V;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 16-byte global -> shared copy that runs without the thread, in the
// thread's current cp.async group
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
               "r"(smem_addr(dst)), "l"(src) : "memory");
}
// a 4-byte one, for the fold's b
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// an mbarrier of one arrival that a bulk copy completes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::
               "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile("{\n.reg .pred done;\nLAB_WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
               "r"(parity) : "memory");
}
// a TMA bulk copy global -> shared of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// one run of V consecutive û elements (V = 4 fp32, V = 8 bf16: 16 bytes;
// V = 1: one element) as the thread holds it (Raw): load reads it from
// device memory into registers; fill copies it into a 16-byte ring slot of
// shared memory (16 bytes: asynchronously; one element: by the thread),
// read takes it from there; widen<Q> gives elements [4Q, 4Q + 4) in fp32
template <typename T, int V>
struct Run;

template <>
struct Run<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void fill(float4* slot, const float* p) {
    copy16(slot, p);
  }
  static __device__ __forceinline__ Raw read(const float4* slot) {
    return *slot;
  }
  template <int Q>
  static __device__ __forceinline__ float4 widen(const Raw& r) { return r; }
};

template <>
struct Run<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void fill(float4* slot,
                                              const __nv_bfloat16* p) {
    copy16(slot, p);
  }
  static __device__ __forceinline__ Raw read(const float4* slot) {
    return *reinterpret_cast<const uint4*>(slot);
  }
  // a bf16 is the high half of its fp32: the lower address is the low half
  template <int Q>
  static __device__ __forceinline__ float4 widen(const Raw& r) {
    const unsigned lo = Q == 0 ? r.x : r.z, hi = Q == 0 ? r.y : r.w;
    return make_float4(__uint_as_float(lo << 16),
                       __uint_as_float(lo & 0xffff0000u),
                       __uint_as_float(hi << 16),
                       __uint_as_float(hi & 0xffff0000u));
  }
};

template <typename T>
struct Run<T, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const T* p) {
    return load_u(p, 0, 1.0f);
  }
  static __device__ __forceinline__ void fill(float4* slot, const T* p) {
    *reinterpret_cast<float*>(slot) = load(p);
  }
  static __device__ __forceinline__ Raw read(const float4* slot) {
    return *reinterpret_cast<const float*>(slot);
  }
};

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// v = squash(s); lets its programmatic dependent start at once (a no-op
// when it has none).  Where C is a power of two up to 32, a thread an
// element, a row's C lanes summing |s|² by an xor butterfly (every lane
// gets the same bits); otherwise a thread a row, in c order.
template <bool APPROX>
__global__ void __launch_bounds__(kReduceThreads)
stage_squash_kernel(const float* __restrict__ s, float* __restrict__ v,
                    int BH, int C) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (C <= 32 && (C & (C - 1)) == 0) {
    const int n = BH * C;
    const float x = i < n ? s[i] : 0.0f;
    float n2 = __fmul_rn(x, x);
    for (int off = C >> 1; off > 0; off >>= 1)
      n2 = __fadd_rn(n2, __shfl_xor_sync(kFull, n2, off));
    if (i < n) v[i] = routing::Squash<APPROX>(n2)(x);
    return;
  }
  if (i >= BH) return;
  const float* sp = s + (size_t)i * C;
  float* o = v + (size_t)i * C;
  float n2 = 0.0f;
  for (int k = 0; k < C; ++k) n2 = __fadd_rn(n2, __fmul_rn(sp[k], sp[k]));
  const routing::Squash<APPROX> sq(n2);
  for (int k = 0; k < C; ++k) o[k] = sq(sp[k]);
}

// the batch row whose v lands in staged row sj of staging t, or -1 past
// the slice's rows
__device__ __forceinline__ int staged_row(const UpdateArgs& a, int sj,
                                          int t) {
  const int KR = a.chunk_rows, S = a.slices;
  const int sl = sj / KR, j = t * KR + sj - sl * KR;
  const int lo = sl * a.B / S;
  return j < (sl + 1) * a.B / S - lo ? lo + j : -1;
}

// whether the stagings go by bulk copies: with one pass, each slice's rows
// of a staging are consecutive rows of v, so one copy a slice where H·C
// divides into fours and v is 16-byte aligned
__device__ __forceinline__ bool bulk_staging(const UpdateArgs& a) {
  return a.passes == 1 && (a.H * a.C) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
}

// issues staging t of the pass over columns [c0, c0 + width):
// vs[(s'·KR + j)·cols + k] = v[b, c0 + k] for the j-th row b of chunk t of
// slice s' — one bulk copy a slice, all issued by thread 0 and completing
// on bar; otherwise every thread copies elements itself (visible after
// the next barrier)
__device__ __forceinline__ void stage_issue(const UpdateArgs& a, bool bulk,
                                            float* vs, uint64_t* bar, int t,
                                            int c0, int cols, int width) {
  const int HC = a.H * a.C, S = a.slices, KR = a.chunk_rows;
  if (bulk) {
    if (threadIdx.x != 0) return;
    // shared memory last read by the threads is about to be written by the
    // copy engine
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    uint32_t bytes = 0;
    for (int sl = 0; sl < S; ++sl) {
      const int lo = sl * a.B / S, n = (sl + 1) * a.B / S - lo - t * KR;
      bytes += 4u * HC * (uint32_t)max(0, min(KR, n));
    }
    mbar_expect(bar, bytes);
    for (int sl = 0; sl < S; ++sl) {
      const int lo = sl * a.B / S, n = (sl + 1) * a.B / S - lo - t * KR;
      const int rows = max(0, min(KR, n));
      if (rows > 0)
        bulk_copy(vs + (size_t)sl * KR * HC,
                  a.v + (size_t)(lo + t * KR) * HC, 4u * HC * rows, bar);
    }
    return;
  }
  const int n = S * KR * width;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int sj = i / width, k = i - sj * width;
    const int b = staged_row(a, sj, t);
    if (b >= 0) vs[(size_t)sj * cols + k] = a.v[(size_t)b * HC + c0 + k];
  }
}

// acc[4h..4h+4) += x·v, four products and sums each rounded on its own
__device__ __forceinline__ void fma4(float* acc, float4 x, float4 v) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(x.x, v.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(x.y, v.y));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(x.z, v.z));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(x.w, v.w));
}

// acc[0..V) += û·v for one run x and its V staged v values
template <typename T, int V>
__device__ __forceinline__ void accumulate(float* acc,
                                           const typename Run<T, V>::Raw& x,
                                           const float* v) {
  using R = Run<T, V>;
  if constexpr (V == 1) {
    acc[0] = __fadd_rn(acc[0], __fmul_rn(x, *v));
  } else {
    fma4(acc, R::template widen<0>(x), reinterpret_cast<const float4*>(v)[0]);
    if constexpr (V == 8)
      fma4(acc + 4, R::template widen<1>(x),
           reinterpret_cast<const float4*>(v)[1]);
  }
}

// the shared memory of one update block, in floats: two stagings of v or
// the slices' partial sums of one pass, whichever is larger; the fold's
// (rows, H) logits; with several passes, the (rows, H) sums over C so
// far; then, with the ring in shared memory, its kRingShared 16-byte slots
// a thread (ops.py::stage_update_smem_bytes)
struct UpdateSmem {
  size_t stage, logits, ring;
  __device__ __host__ UpdateSmem(int rows, int slices, int chunk_rows,
                                 int cols, int H, int passes) {
    stage = (size_t)slices * chunk_rows * cols;
    const size_t part = (size_t)slices * rows * cols;
    logits = 2 * stage > part ? 2 * stage : part;
    const size_t sums = passes > 1 ? (size_t)rows * H : 0;
    ring = (logits + (size_t)rows * H + sums + 3) / 4 * 4;
  }
  size_t bytes(int threads, bool smem_ring) const {
    return 4 * ring + (smem_ring ? (size_t)16 * kRingShared * threads : 0);
  }
};

// PASSES = false: one pass over the whole row (passes = 1, cols = H·C,
// folded at compile time).  SMEM_RING = false: a thread keeps its next
// kRingRegisters runs in registers, row g in x[g % kRingRegisters], and
// loads row g + that as soon as row g is used.  SMEM_RING = true: row
// g's run is copied into ring slot g % kRingShared of shared memory that
// many rows ahead of its use, one cp.async group a row, so that before
// row g all but the newest kRingShared − 1 groups have landed — deeper,
// at no register cost, for long batch slices.  Stagings hold whole rings
// (KR a multiple of the depth) wherever there are several.
template <typename T, int V, bool FOLD, bool APPROX, bool SMEM_RING,
          bool PASSES>
__global__ void __launch_bounds__(kUpdateThreads, kUpdateBlocksPerSm)
stage_update_kernel(const UpdateArgs a) {
  constexpr int D = SMEM_RING ? kRingShared : kRingRegisters;
  using R = Run<T, V>;
  extern __shared__ __align__(16) float sm[];
  __shared__ uint64_t bars[2];      // stagings by bulk copy, one a buffer
  const int H = a.H, C = a.C, HC = H * C, S = a.slices, KR = a.chunk_rows;
  const int passes = PASSES ? a.passes : 1;
  const int cols = PASSES ? pass_cols(a, V) : HC;
  const UpdateSmem lay(a.rows, S, KR, cols, H, passes);
  const int l0 = blockIdx.x * a.rows;
  const int rows = min(a.rows, a.L - l0);
  const int pruns = cols / V;        // a row's runs in one pass
  const int sl = threadIdx.x / (a.rows * pruns);
  const int o = threadIdx.x - sl * a.rows * pruns;
  const int row = o / pruns;         // the thread's row of the block
  const int col = (o - row * pruns) * V;  // its run's column in a pass
  const bool on = sl < S && row < rows;
  const int b_lo = on ? sl * a.B / S : 0;
  const int nb_slice = on ? (sl + 1) * a.B / S - b_lo : 0;
  const int stride = a.L * HC;  // B·L·H·C < 2^31 (kernel.py checks)
  const bool bulk = bulk_staging(a);
  float* bn = sm + lay.logits;  // the fold's b rows, then its logits
  float* sums = bn + a.rows * H;  // several passes: Σ_c so far per (l, h)
  float* part = sm;  // (slices, rows·cols), over the stagings
  const int blk = a.rows * cols;
  if (FOLD) {  // copied in while the block streams
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x)
      copy4(bn + i, a.b + (size_t)l0 * H + i);
    commit_group();
  }
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float4* ring = reinterpret_cast<float4*>(sm + lay.ring) + threadIdx.x;
  typename R::Raw x[SMEM_RING ? 1 : D];

  for (int p = 0; p < passes; ++p) {
    const int c0 = p * cols;  // the pass's first column
    const int width = min(cols, HC - c0);
    const int nb = col < width ? nb_slice : 0;
    const T* next = static_cast<const T*>(a.u)
                    + ((size_t)b_lo * a.L + l0 + row) * HC + c0 + col;
    // Σ_b û·v over the slice's rows, in order, V elements a thread; v
    // sits in two buffers of one staging each, the next staging's copies
    // in flight while this one is used
#pragma unroll
    for (int q = 0; q < D; ++q) {
      if constexpr (SMEM_RING) {
        if (q < nb) R::fill(ring + q * blockDim.x, next);
        commit_group();
      } else {
        if (q < nb) x[q] = R::load(next);
      }
      next += stride;
    }
    // the mbarriers are initialised; the last pass's sums are read
    __syncthreads();
    if (p == 0) grid_dependency_wait();
    stage_issue(a, bulk, sm, &bars[0], 0, c0, cols, width);
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int t = 0; t < a.chunks; ++t) {
      float* vs = sm + (t & 1) * lay.stage;
      if (bulk) mbar_wait(&bars[t & 1], (t >> 1) & 1);
      __syncthreads();  // staging t landed; staging t - 1 is read
      if (t + 1 < a.chunks)
        stage_issue(a, bulk, sm + ((t + 1) & 1) * lay.stage,
                    &bars[(t + 1) & 1], t + 1, c0, cols, width);
      const int j0 = t * KR;
      const int jn = max(0, min(KR, nb - j0));
      const float* vrow = vs + (size_t)sl * KR * cols + col;
      if constexpr (SMEM_RING) {
        for (int j = 0; j < jn; ++j) {
          const int g = j0 + j;
          float4* slot = ring + (g % D) * blockDim.x;
          wait_groups<D - 1>();
          accumulate<T, V>(acc, R::read(slot), vrow + (size_t)j * cols);
          if (g + D < nb) R::fill(slot, next);
          next += stride;
          commit_group();
        }
      } else {
        for (int j = 0; j < jn; j += D) {
#pragma unroll
          for (int q = 0; q < D; ++q) {
            if (j + q < jn) {
              accumulate<T, V>(acc, x[q], vrow + (size_t)(j + q) * cols);
              if (j0 + j + q + D < nb) {
                x[q] = R::load(next);
                next += stride;
              }
            }
          }
        }
      }
    }

    // the slices' partial sums meet in slice order, then Σ_c per (row, h)
    // over the pass's columns, in c order, carried from pass to pass
    if (FOLD) wait_groups<0>();
    __syncthreads();
    if (on && col < width) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        part[(size_t)sl * blk + row * cols + col + k] = acc[k];
    }
    __syncthreads();
    const int n_el = rows * width;
    for (int i = threadIdx.x; i < n_el; i += blockDim.x) {
      const int e = PASSES ? i / width * cols + i % width : i;
      float y = part[e];
      for (int k = 1; k < S; ++k) y = __fadd_rn(y, part[(size_t)k * blk + e]);
      part[e] = y;
    }
    __syncthreads();
    const int h_lo = c0 / C, nh = (c0 + width - 1) / C - h_lo + 1;
    for (int i = threadIdx.x; i < rows * nh; i += blockDim.x) {
      const int r = i / nh, h = h_lo + i % nh;
      const int lo = max(h * C, c0), hi = min((h + 1) * C, c0 + width);
      const int li = r * H + h;
      const float* tp = part + (size_t)r * cols - c0;
      float d = !PASSES || h * C >= c0 ? 0.0f : sums[li];
      for (int k = lo; k < hi; ++k) d = __fadd_rn(d, tp[k]);
      if (PASSES && hi < (h + 1) * C) {  // the capsule goes on
        sums[li] = d;
        continue;
      }
      const size_t gi = (size_t)l0 * H + li;
      if (FOLD) {
        const float y = __fadd_rn(bn[li], d);
        a.b_out[gi] = y;
        bn[li] = y;
      } else {
        a.db[gi] = d;
      }
    }
  }
  if (!FOLD) return;

  // the next iteration's Eq.5 couplings, routing.cuh's softmax_row spread
  // over the block: a row's max and sum by one thread (the sum in h order),
  // the exponentials and the division by one thread an element
  const int n_lh = rows * H;
  float* stat = part;  // a row's max, then its sum (or 1/sum, approx)
  __syncthreads();
  for (int l = threadIdx.x; l < rows; l += blockDim.x) {
    const float* row = bn + (size_t)l * H;
    float m = row[0];
    for (int h = 1; h < H; ++h) m = fmaxf(m, row[h]);
    stat[l] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_lh; i += blockDim.x) {
    const float x = __fsub_rn(bn[i], stat[i / H]);
    bn[i] = APPROX ? fast_exp<true>(x) : expf(x);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < rows; l += blockDim.x) {
    const float* row = bn + (size_t)l * H;
    float sum = 0.0f;
    for (int h = 0; h < H; ++h) sum += row[h];
    stat[l] = APPROX ? fast_recip<true>(sum) : sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_lh; i += blockDim.x) {
    const float r = stat[i / H];
    a.c_out[(size_t)l0 * H + i] = APPROX ? __fmul_rn(bn[i], r)
                                         : __fdiv_rn(bn[i], r);
  }
}

// ---- host-side dispatch ----------------------------------------------------

inline int round_threads(int n, int cap) {
  int t = ((n + 31) / 32) * 32;
  return t > cap ? cap : t;
}

template <typename T>
cudaError_t launch_votes(const void* u, const float* c, float* s,
                         float* partial, int B, int L, int H, int C,
                         int chunk_rows, int chunks, cudaStream_t st) {
  const int HC = H * C;
  stage_votes_kernel<T><<<dim3(B, chunks), round_threads(HC, kVotesMaxThreads),
                          0, st>>>(static_cast<const T*>(u), c, partial, B, L,
                                   H, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = B * HC;
  stage_votes_reduce_kernel<<<(n + kReduceThreads - 1) / kReduceThreads,
                              kReduceThreads, 0, st>>>(partial, s, chunks, n);
  return cudaGetLastError();
}

template <typename T, int V, bool FOLD, bool APPROX, bool SMEM_RING,
          bool PASSES>
cudaError_t launch_update_k(const UpdateArgs& a, int threads, int blocks,
                            size_t smem, cudaStream_t st) {
  auto kernel = stage_update_kernel<T, V, FOLD, APPROX, SMEM_RING, PASSES>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int BH = a.B * a.H;
  const int n = a.C <= 32 && (a.C & (a.C - 1)) == 0 ? BH * a.C : BH;
  stage_squash_kernel<APPROX><<<(n + kReduceThreads - 1) / kReduceThreads,
                                kReduceThreads, 0, st>>>(a.s, a.v, BH, a.C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T, int V, bool SMEM_RING, bool PASSES>
cudaError_t launch_update_r(const UpdateArgs& a, bool approx, bool fold,
                            int threads, int blocks, size_t smem,
                            cudaStream_t st) {
  if (fold) {
    return approx ? launch_update_k<T, V, true, true, SMEM_RING, PASSES>(
                        a, threads, blocks, smem, st)
                  : launch_update_k<T, V, true, false, SMEM_RING, PASSES>(
                        a, threads, blocks, smem, st);
  }
  return approx ? launch_update_k<T, V, false, true, SMEM_RING, PASSES>(
                      a, threads, blocks, smem, st)
                : launch_update_k<T, V, false, false, SMEM_RING, PASSES>(
                      a, threads, blocks, smem, st);
}

template <typename T, int V>
cudaError_t launch_update_v(const UpdateArgs& a, bool smem_ring, bool approx,
                            bool fold, int threads, int blocks, size_t smem,
                            cudaStream_t st) {
  if (a.passes > 1)
    return smem_ring ? launch_update_r<T, V, true, true>(
                           a, approx, fold, threads, blocks, smem, st)
                     : launch_update_r<T, V, false, true>(
                           a, approx, fold, threads, blocks, smem, st);
  return smem_ring ? launch_update_r<T, V, true, false>(a, approx, fold,
                                                        threads, blocks,
                                                        smem, st)
                   : launch_update_r<T, V, false, false>(a, approx, fold,
                                                         threads, blocks,
                                                         smem, st);
}

// the geometry's checks, then the launch: vector 16 / itemsize (H·C a
// multiple of it, û 16-byte aligned) or 1; several passes only for one
// row a block, none of them empty
int launch_update(const UpdateArgs& a, int dtype, int vector, int ring,
                  int threads, int blocks, int smem_bytes, bool approx,
                  bool fold, cudaStream_t st) {
  const int HC = a.H * a.C;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int wide = dtype == 0 ? 4 : 8;
  if (a.B < 1 || a.L < 1 || a.H < 1 || a.C < 1 || a.rows < 1 ||
      a.slices < 1 || a.slices > a.B || a.passes < 1 ||
      (a.passes > 1 && a.rows != 1) || a.chunk_rows < 1 || a.chunks < 1 ||
      (ring != 0 && ring != 1) ||
      (vector != 1 && vector != wide) || HC % vector != 0 ||
      reinterpret_cast<uintptr_t>(a.u) % (vector == 1 ? 1 : 16) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int cols = pass_cols(a, vector);
  const int per_slice = (a.B + a.slices - 1) / a.slices;
  const long long need = (long long)a.slices * a.rows * (cols / vector);
  const bool smem_ring = ring == 1;
  const int depth = smem_ring ? kRingShared : kRingRegisters;
  const size_t smem = UpdateSmem(a.rows, a.slices, a.chunk_rows, cols, a.H,
                                 a.passes).bytes(threads, smem_ring);
  if (blocks != (a.L + a.rows - 1) / a.rows || threads % 32 != 0 ||
      threads > kUpdateThreads || need > threads || need <= threads - 32 ||
      (long long)(a.passes - 1) * cols >= HC ||
      (long long)a.chunks * a.chunk_rows < per_slice ||
      (long long)(a.chunks - 1) * a.chunk_rows >= per_slice ||
      (a.chunks > 1 && a.chunk_rows % depth != 0) ||
      smem != (size_t)smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return (int)(vector == 1
        ? launch_update_v<float, 1>(a, smem_ring, approx, fold, threads,
                                    blocks, smem, st)
        : launch_update_v<float, 4>(a, smem_ring, approx, fold, threads,
                                    blocks, smem, st));
  }
  return (int)(vector == 1
      ? launch_update_v<__nv_bfloat16, 1>(a, smem_ring, approx, fold, threads,
                                          blocks, smem, st)
      : launch_update_v<__nv_bfloat16, 8>(a, smem_ring, approx, fold, threads,
                                          blocks, smem, st));
}

}  // namespace

extern "C" {

// STAGE 1: s (B,H,C) = Σ_l c (L,H) · û (B,L,H,C); û fp32 (dtype 0) or bf16
// (1); partial is (chunks, B, H, C) scratch, chunks = ceil(L / chunk_rows).
int routing_stage_votes(const void* u, int dtype, const float* c, float* s,
                        float* partial, int B, int L, int H, int C,
                        int chunk_rows, int chunks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_votes<float>(u, c, s, partial, B, L, H, C,
                                            chunk_rows, chunks, st);
    case 1: return (int)launch_votes<__nv_bfloat16>(u, c, s, partial, B, L, H,
                                                    C, chunk_rows, chunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// STAGE 2: v (B,H,C) = squash(s), then fold = 0: db (L,H) = Σ_{b,c} û·v;
// fold = 1: b_out = b + that, c_out = softmax_H(b_out) (b, b_out, c_out
// (L,H); db unused); the squash launch, then the update kernel as its
// programmatic dependent, at the geometry of ops.py::stage_update_geometry
// (rows, slices, passes, vector, ring, chunk_rows, chunks, threads,
// blocks, smem_bytes).  Returns cudaErrorInvalidValue for a geometry that
// does not fit the shape.
int routing_stage_update(const void* u, int dtype, const float* s, float* v,
                         float* db, const float* b, float* b_out,
                         float* c_out, int B, int L, int H, int C,
                         int use_approx, int fold, int rows, int slices,
                         int passes, int vector, int ring, int chunk_rows,
                         int chunks, int threads, int blocks, int smem_bytes,
                         void* stream) {
  const UpdateArgs a{u, s, v, db, b, b_out, c_out, B, L, H, C,
                     rows, slices, passes, chunk_rows, chunks};
  return launch_update(a, dtype, vector, ring, threads, blocks, smem_bytes,
                       use_approx != 0, fold != 0,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
