// Recompute-b backward of the whole routing procedure for Hopper (sm_90a),
// compiled into the same library as routing.cu (kernel.py::build) and bound
// through the same plain C interface.
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernel
//   repro/kernels/routing/kernel.py::routing_procedure_bwd
//     (_routing_procedure_bwd_kernel) — (û (B,L,H,C), ∂v (B,H,C)) -> ∂û at
//     û's stream dtype (fp32 or bf16), fp32 accumulation, written once.
//
// The forward saved only û.  The backward first replays the forward and
// snapshots the small per-iteration state — c_t (T,L,H), s_t (T,B,H,C) and
// v_{t-1} (T,B,H,C) — then walks the iterations in reverse, carrying ∂v and
// the accumulated logit cotangent ∂b (kernel.py:405-419 in the reference):
//
//   gs   = squash_vjp(s_t, gv)             exact squash, even in approx mode
//   gc   = Σ_{k,c} û·gs                    (L,H)
//   gb  += c_t ⊙ (gc − Σ_H c_t·gc)         Eq.5 softmax vjp, snapshot gb_t
//   gv   = Σ_l gb·û                        carried to iteration t-1
//   ∂û   = Σ_t c_t⊗gs_t + Σ_{t≥1} gb_t⊗v_{t-1}   (the t=0 Eq.4 term vanishes)
//
// At t = 0 neither gb_0 nor the carry is needed, so the reverse sweep runs
// its tile launch for t = T-1 … 1 only.  Launches (4T for T iterations):
//
//   replay   T × (forward tile kernel + forward reduce kernel): the launches
//            of routing.cu at the forward's own geometry (clusters over B,
//            û staged once an iteration), with c_t and s_t snapshotted
//            through their c_out / s_out pointers, and v_t written straight
//            into the v_{t-1} snapshot slot of iteration t+1;
//   reverse  one reduce that turns ∂v into gs_{T-1}, then per t = T-1 … 1
//            routing.cu's reverse tile kernel and its reverse reduce.  The
//            reverse iteration has the forward iteration's shape — gc is
//            the deferred Eq.4 with gs_t for v, the Eq.5 vjp a per-row
//            operation like the softmax, Σ_l gb·û Eq.2 with gb for c — so
//            it runs on the forward's cells and geometry
//            (ops.tile_geometry): clusters split B, a block stages its row
//            group's û sub-block once by TMA bulk copy (the next group's
//            in flight) and takes gc and the ∂v carry from that one copy,
//            the cluster adds the gc parts through distributed shared
//            memory in rank order, a warp a row folds the vjp into gb
//            (rank 0 writes gb and the gb_t snapshot), and each slot's
//            carry goes to its slice of the partials; the reduce sums them
//            in slot order and applies the exact squash vjp of s_{t-1}.
//            So û leaves HBM once per reverse iteration, across the card;
//   ∂û       one elementwise kernel over (B,L,H,C) sums the snapshot terms.
//
// Every sum runs in a fixed order with no float atomics, so ∂û is bitwise
// deterministic.  All snapshots live in device memory (a few hundred KB at
// Caps-MN1), allocated by the wrapper.
//
// Bound: the function reads û (and ∂v) once and writes ∂û once, so the
// least it could move is 2·|û| bytes — 0.044 ms at Caps-MN1 fp32, B=100,
// over 3.35 TB/s; the arithmetic (about 4T FLOP per û element) is far below
// the fp32 rate.  The reference's stream model counts 2T û passes plus ∂û
// (ops.dma_bytes_per_call(backward=True)); the kernels make 2T − 1 (T
// replay, T − 1 reverse) and the ∂û pass.  Measured times are in PERF.md.

#include "routing.cuh"

namespace {

using routing::kReduceThreads;

__device__ __forceinline__ void store_du(float* p, size_t i, float x) {
  p[i] = x;
}

__device__ __forceinline__ void store_du(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16_rn(x);  // round to nearest even, as Tensor.to
}

// ---- ∂û: the snapshot terms summed per element -----------------------------
//
// ∂û[k,l,h,c] = c_0[l,h]·gs_0[k,h,c]
//             + Σ_{t≥1} (c_t[l,h]·gs_t[k,h,c] + gb_t[l,h]·v_{t-1}[k,h,c]),
// each product and sum rounded on its own (as the plain version's tensor
// operations round), written once at û's dtype.

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
du_kernel(T* __restrict__ du, const float* __restrict__ c_all,
          const float* __restrict__ gs_all, const float* __restrict__ gb_all,
          const float* __restrict__ vp_all, int B, int L, int H, int C,
          int iterations) {
  const size_t n = (size_t)B * L * H * C;
  const size_t LH = (size_t)L * H, BHC = (size_t)B * H * C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    size_t rest = i / C;
    const int h = (int)(rest % H);
    rest /= H;
    const int l = (int)(rest % L);
    const int k = (int)(rest / L);
    const size_t lh = (size_t)l * H + h;
    const size_t khc = ((size_t)k * H + h) * C + c;
    float acc = __fmul_rn(c_all[lh], gs_all[khc]);
    for (int t = 1; t < iterations; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(c_all[t * LH + lh], gs_all[t * BHC + khc]));
      acc = __fadd_rn(acc, __fmul_rn(gb_all[t * LH + lh], vp_all[t * BHC + khc]));
    }
    store_du(du, i, acc);
  }
}

// ---- host-side dispatch ----------------------------------------------------

template <typename T>
cudaError_t launch_du(void* du, const float* c_all, const float* gs_all,
                      const float* gb_all, const float* vp_all, int B, int L,
                      int H, int C, int iterations, cudaStream_t stream) {
  const size_t n = (size_t)B * L * H * C;
  size_t blocks = (n + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  du_kernel<T><<<(unsigned)blocks, kReduceThreads, 0, stream>>>(
      static_cast<T*>(du), c_all, gs_all, gb_all, vp_all, B, L, H, C,
      iterations);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ∂û (B,L,H,C) at û's dtype (0 fp32, 1 bf16) from û and ∂v = g (B,H,C).
// Scratch, all fp32 and allocated by the caller: b (L,H) (the replay
// starts from b = 0 without reading it), gb (L,H) zero on entry; partial
// (slots,B,H,C), one slice per slot of the forward's geometry
// (ops.tile_geometry), shared by the replay and the reverse sweep;
// snapshots c_all, gb_all (T,L,H) and s_all, vp_all, gs_all (T,B,H,C), of
// which vp_all[0] (v_{-1} = 0) is never read.  Returns the CUDA error of
// the first launch that failed, or 0.
int routing_procedure_backward(const void* u, int dtype, const float* g,
                               void* du, float* b, float* gb, float* partial,
                               float* c_all, float* gb_all, float* s_all,
                               float* vp_all, float* gs_all, int B, int L,
                               int H, int C, int l_tile, int rows,
                               int batch_chunk, int cluster, int staged,
                               int slots, int iterations, int use_approx,
                               void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t LH = (size_t)L * H, BHC = (size_t)B * H * C;
  const bool approx = use_approx != 0;
  const int T = iterations;
  cudaError_t err;

  // replay: the forward's own launches, snapshotting c_t, s_t and v_t
  routing::TileArgs a{u, nullptr, vp_all, b, b, partial, nullptr, nullptr,
                      nullptr, nullptr, nullptr, B, L, H, C, l_tile, 0, 0.0f,
                      rows, batch_chunk, cluster, staged, slots};
  err = routing::resolve_slots(a, dtype, approx, false);
  if (err != cudaSuccess) return (int)err;
  for (int t = 0; t < T; ++t) {
    a.v_prev = vp_all + t * BHC;
    a.c_out = c_all + t * LH;
    a.iteration = t;
    a.zero_state = t == 0;
    err = routing::launch_tile(a, dtype, approx, false, st);
    if (err != cudaSuccess) return (int)err;
    if (t + 1 < T) {
      err = routing::launch_reduce(a, vp_all + (t + 1) * BHC,
                                   s_all + t * BHC, true, approx, false, st);
    } else {  // the last v is the forward's output: only s_{T-1} is needed
      err = routing::launch_reduce(a, s_all + t * BHC, nullptr, false, false,
                                   false, st);
    }
    if (err != cudaSuccess) return (int)err;
  }

  // reverse: the tile kernel's reverse mode on the same geometry, its
  // slots resolved for its own kernel; seeded by the reduce of the one
  // slice g, then t = T-1 … 1
  routing::TileArgs r{u, nullptr, nullptr, gb, gb, partial, nullptr, nullptr,
                      nullptr, nullptr, gb_all, B, L, H, C, l_tile, 0, 0.0f,
                      rows, batch_chunk, cluster, staged, slots};
  r.c_rev = c_all;
  err = routing::resolve_slots(r, dtype, false, false);
  if (err != cudaSuccess) return (int)err;
  routing::TileArgs seed = r;
  seed.partial = const_cast<float*>(g);  // read only, by the reduce
  seed.slots = 1;
  err = routing::launch_reduce_vjp(seed, gs_all + (T - 1) * BHC,
                                   s_all + (T - 1) * BHC, st);
  if (err != cudaSuccess) return (int)err;
  for (int t = T - 1; t >= 1; --t) {
    r.v_prev = gs_all + t * BHC;
    r.c_rev = c_all + t * LH;
    r.c_out = gb_all + t * LH;
    err = routing::launch_tile(r, dtype, false, false, st);
    if (err != cudaSuccess) return (int)err;
    err = routing::launch_reduce_vjp(r, gs_all + (t - 1) * BHC,
                                     s_all + (t - 1) * BHC, st);
    if (err != cudaSuccess) return (int)err;
  }

  // ∂û from the snapshots, written once
  err = dtype == 0
      ? launch_du<float>(du, c_all, gs_all, gb_all, vp_all, B, L, H, C, T, st)
      : launch_du<__nv_bfloat16>(du, c_all, gs_all, gb_all, vp_all, B, L, H,
                                 C, T, st);
  return (int)err;
}

}  // extern "C"
