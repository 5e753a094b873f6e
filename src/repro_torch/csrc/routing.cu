// Dynamic-routing kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface and ctypes (repro_torch/kernels/routing/kernel.py builds
// this file with nvcc and loads it).
//
// Source note
// -----------
// Replaces the JAX package's Pallas TPU kernels
//   repro/kernels/routing/kernel.py::routing_procedure_fused
//     (_routing_procedure_kernel) — the whole routing procedure, T iterations
//     of the lazy-update schedule, fp32/bf16/int8 û streams, early exit;
//   repro/kernels/routing/kernel.py::routing_iteration_fused
//     (_routing_iter_kernel) — one lazy-update iteration, returns (s, b_new).
//
// Both are memory-bound on this card: about 4 FLOP per û element per
// iteration (2 for the Eq.4 agreement, 2 for the Eq.2 vote sum) against
// 4 bytes (fp32), 2 (bf16) or 1 (int8) of û — far below the ~20 FLOP/byte
// at which fp32 arithmetic (67 TFLOP/s) would take over from HBM
// (3.35 TB/s).  The bound is the û bytes per iteration over 3.35 TB/s:
// ops.dma_bytes_per_call(form="procedure") counts them.  The û stream of
// the Table-1 shapes (74 MB fp32 for Caps-MN1 at B=100) does not fit the
// 50 MB L2, so every iteration streams it from HBM again.  Measured times
// against this bound are in PERF.md.
//
// The TPU grid runs its (iteration, L-tile) cells in order on one core and
// carries b, v and s in VMEM scratch across them.  Blocks on the H100 run in
// parallel with no order, so each iteration is two launches, and the
// reference tile (`l_tile`: int8 scale rows, early-exit flags, the work
// counter) keeps its meaning while the work under it is cut smaller:
//
//   tile kernel    a row group is `rows` L-rows of one reference tile; a
//                  block takes `batch_chunk` batch rows of it, and the
//                  blocks of a thread-block cluster (at most 8, along B)
//                  take one group's batch chunks.  The grid holds as many
//                  clusters as the card runs at once (`slots`, from the
//                  occupancy API); each walks the row groups `slots` apart.
//                  A block copies its group's û sub-block into shared
//                  memory once, a bulk copy (TMA) a batch row issued by its
//                  last warp and completed on an mbarrier, the next
//                  group's copy and b rows in flight while this group is
//                  worked on.  From that copy it sums
//                  its part of the deferred Eq.4 (four columns a thread);
//                  the cluster adds the parts through distributed shared
//                  memory in rank order, so every block holds the same b
//                  rows bit for bit, and a warp a row takes Eq.5's softmax
//                  across its lanes.  Eq.2 comes from the same copy: û
//                  leaves HBM once an iteration, as in the reference.  Each
//                  block adds its groups' Eq.2 into its own (batch_chunk,
//                  H·C) sums, written once into the slot's slice of the
//                  partials.  Rank 0 writes b, the couplings snapshots and
//                  the group's max|Δb|.  Iteration 0 starts from b = 0,
//                  v = 0, so it skips Eq.4 and the exchange.
//   reduce kernel  sums the (slots, B, H, C) partials in a fixed order (8
//                  warps over ranges of slots, the ranges added in order)
//                  and for the procedure form applies the Eq.3 squash,
//                  writing v for the next iteration.  Under early exit one
//                  more block folds the groups' max|Δb| into the tile flags
//                  and counts the worked tiles.  The kernel boundary is the
//                  grid-wide barrier.
//
// kernels/routing/ops.py::tile_geometry picks the rows, the batch chunk and
// the cluster: blocks two of which share an SM where the shared memory
// allows, one block for all of B (no exchange) where that fits, the
// largest rows that still launch a block for every SM.  Where not even one
// staged L-row fits (Caps-EN3 fp32 at B=128), the block reads û from device
// memory for both equations instead of staging it.  No float atomics: the
// sums run in orders the launch fixes, and two calls agree bitwise.
//
// What bounds it: û once an iteration from HBM is the byte bound, but a
// row group's work is a chain of barriers — the copy's wait, the cluster
// barrier, the exchange and softmax, Eq.2 — each about as long as the
// group's arithmetic (scripts/routing_tile_phases.py measures them), so
// the kernel streams well below HBM's rate; fewer, larger groups help,
// more blocks an SM do not.  b, v and s stay on the card for the whole
// procedure; only v is the output.  The backward (routing_bwd.cu) replays
// the forward through these same launches (routing.cuh), snapshotting c
// and s through c_out and s_out, and runs its reverse sweep as their
// reverse mode (reverse_tile_kernel, reverse_reduce_kernel): the same
// body on the same cells with gs_t, ∂b and c_t for v, b and the softmax.
//
// Arithmetic follows repro/kernels/routing/kernel.py: fp32 accumulation, the
// squash and softmax of routing.cuh (shared with routing_stage.cu), the
// §5.2.2 bit-level helpers with __fmul_rn/__fadd_rn/__fsub_rn where the
// reference rounds each product (so nvcc's FMA contraction cannot change the
// bits the bitcasts see), the fast-exp int32 cast truncating after the clip
// to [0, 254.999], and squash epsilons +1e-9 on |s|^2 (approx) and
// sqrt(|s|^2 + 1e-9) (exact).

#include <cooperative_groups.h>

#include "flash_tc.cuh"
#include "routing.cuh"

namespace cg = cooperative_groups;

namespace {

using routing::kDefaultSmem;
using routing::kReduceThreads;
using routing::kTileThreads;
using routing::squash_row;
using routing::TileArgs;

// û elements from the staged copy or from device memory, as fp32 (int8
// codes times the tile's scale, kernel.py: u.astype(f32) * scale)
__device__ __forceinline__ float elem(const float* p, size_t i, float) {
  return p[i];
}
__device__ __forceinline__ float elem(const __nv_bfloat16* p, size_t i,
                                      float) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float elem(const int8_t* p, size_t i, float s) {
  return __fmul_rn((float)p[i], s);
}

// V consecutive û elements as fp32 (V = 4: one 16-, 8- or 4-byte load)
template <typename T>
__device__ __forceinline__ void loadv(const T* p, float (&o)[1], float s) {
  o[0] = elem(p, 0, s);
}
__device__ __forceinline__ void loadv(const float* p, float (&o)[4], float) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&o)[4],
                                      float) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}
__device__ __forceinline__ void loadv(const int8_t* p, float (&o)[4],
                                      float s) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = __fmul_rn((float)v.x, s); o[1] = __fmul_rn((float)v.y, s);
  o[2] = __fmul_rn((float)v.z, s); o[3] = __fmul_rn((float)v.w, s);
}

// bytes of one staged û sub-block (batch_chunk × rows × H·C), 16-aligned
__host__ __device__ inline size_t stage_bytes(const TileArgs& a,
                                              size_t itemsize) {
  return ((size_t)a.batch_chunk * a.rows * a.H * a.C * itemsize + 15) / 16 *
         16;
}

// shared-memory bytes of one tile block, in this order: staged, two û
// sub-blocks and the block's (batch_chunk, H·C) v_prev rows and Eq.2 sums;
// then the (rows, H·C) Eq.4 column sums, two (rows, H) parts of Eq.4 and
// two (rows, H) b rows / couplings.  ops.py::tile_smem_bytes mirrors it.
size_t tile_smem_bytes(const TileArgs& a, size_t itemsize, bool staged) {
  const size_t rh = (size_t)a.rows * a.H;
  const size_t khc = (size_t)a.batch_chunk * a.H * a.C;
  return sizeof(float) * (rh * a.C + 4 * rh) +
         (staged ? 2 * stage_bytes(a, itemsize) + sizeof(float) * 2 * khc
                 : 0);
}

// ---- bulk copies (TMA) into shared memory, completed on an mbarrier ------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// the issuing thread's arrival, announcing `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// True when every batch row of a staged sub-block (seg elements, kstride
// apart from src on) moves as one 16-byte-aligned bulk copy.
template <typename T>
__device__ __forceinline__ bool bulk_ok(const T* src, size_t kstride,
                                        int seg) {
  return (((size_t)reinterpret_cast<uintptr_t>(src) | seg * sizeof(T) |
           kstride * sizeof(T)) % 16) == 0;
}

// kn batch rows of seg elements each, kstride apart in device memory, into
// dst back to back, by one warp.  BULK: one bulk copy a row, completed on
// `bar`; otherwise 4-byte cp.async where the rows are 4-byte aligned (the
// caller commits the group), element copies where not.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           size_t kstride, int kn, int seg,
                                           bool bulk, uint64_t* bar,
                                           int lane) {
  const size_t seg_b = (size_t)seg * sizeof(T);
  const size_t ks_b = kstride * sizeof(T);
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  if (bulk) {  // lane 0 announces the bytes, then each lane issues rows
    if (lane == 0) mbar_expect(bar, (uint32_t)(kn * seg_b));
    __syncwarp();
    // the buffer's last reads (generic proxy) come before these writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int k = lane; k < kn; k += 32)
      bulk_copy(d + k * seg_b, s + k * ks_b, (uint32_t)seg_b, bar);
    return;
  }
  if ((((size_t)reinterpret_cast<uintptr_t>(s) | seg_b | ks_b) % 4) == 0) {
    const int per = (int)(seg_b / 4);
    for (int i = lane; i < kn * per; i += 32) {
      const int k = i / per;
      const size_t o = (size_t)(i - k * per) * 4;
      flash_tc::cp_async4(d + k * seg_b + o, s + k * ks_b + o, true);
    }
  } else {
    for (int i = lane; i < kn * seg; i += 32) {
      const int k = i / seg;
      dst[(size_t)k * seg + (i - k * seg)] = src[k * kstride + (i - k * seg)];
    }
  }
}

constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kTileWarps = kTileThreads / 32;

// xor-butterfly max and sum over a warp: every lane gets the same bits
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- tile kernel: deferred Eq.4 + Eq.5 softmax + partial Eq.2 -------------
//
// The grid is (cluster, slots) with the cluster along x: block (rank, y)
// takes batch rows k0 = rank·batch_chunk .. k0 + kn and walks the row
// groups g = y, y + slots, … (rows l0 = g·rows .. l0 + rows of reference
// tile j = l0 / l_tile), so the cluster's blocks share every g; its Eq.2
// goes to partial slice y.  With STAGED the next group's û sub-block is
// copied into the second buffer while this one is worked on.  u is the
// lane-packed (B, L, H·C) stream.

template <typename T, bool APPROX, bool EARLY_EXIT, bool STAGED, int V,
          bool REVERSE>
__device__ __forceinline__ void tile_body(const TileArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ float rowmax[kTileThreads];  // max|Δb| of each row
  cg::cluster_group cluster = cg::this_cluster();
  const int H = a.H, C = a.C, HC = H * C, r = a.rows;
  const int groups = a.L / r;
  const int rank = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = rank * a.batch_chunk;
  const int kn = min(a.batch_chunk, a.B - k0);
  const T* u = static_cast<const T*>(a.u) + (size_t)k0 * a.L * HC;
  const size_t kstride_u = (size_t)a.L * HC;
  const size_t sb = STAGED ? stage_bytes(a, sizeof(T)) : 0;
  // staged: v_prev of these batch rows and this slot's Eq.2 sums, (kn,
  // H·C) each, in shared memory; unstaged, in device memory
  float* vs = STAGED ? reinterpret_cast<float*>(smem + 2 * sb) : nullptr;
  float* acc = STAGED ? vs + a.batch_chunk * HC : nullptr;
  float* w = reinterpret_cast<float*>(smem + 2 * sb) +
             (STAGED ? 2 * a.batch_chunk * HC : 0);  // (rows, H·C)
  float* parts = w + r * HC;  // two (rows, H) parts of Eq.4, by parity
  // two (rows, H) buffers, by group parity: the b rows (copied in with the
  // group's û), then the couplings
  float* crs = parts + 2 * r * H;
  const float* vrows = STAGED ? vs : a.v_prev + (size_t)k0 * HC;
  float* out = a.partial + ((size_t)blockIdx.y * a.B + k0) * HC;
  const bool bulk = STAGED && bulk_ok(u, kstride_u, r * HC);

  for (int i = threadIdx.x; STAGED && i < kn * HC; i += blockDim.x) {
    vs[i] = a.v_prev[(size_t)k0 * HC + i];
    acc[i] = 0.0f;
  }
  if (bulk && threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The last warp, which has no Eq.4 columns while a group's rows are few,
  // fetches a group's û sub-block (staged) and b rows one group ahead, in
  // one cp.async group (the û rows as bulk copies where aligned).  Every
  // rank reads b_in before the cluster barrier of the group, and rank 0
  // writes b_out after it, so b_in and b_out may alias; a later group's
  // rows are written only by this cluster, when it works on them.
  const bool fetcher = warp == kTileWarps - 1;
  auto prefetch = [&](int gg, int buf) {
    if (STAGED) {
      stage_rows(reinterpret_cast<T*>(smem + buf * sb),
                 u + (size_t)gg * r * HC, kstride_u, kn, r * HC, bulk,
                 &bars[buf], lane);
    }
    float* dst = crs + buf * r * H;
    const float* b_rows = a.b_in + (size_t)gg * r * H;
    for (int i = lane; i < r * H; i += 32)
      flash_tc::cp_async4(dst + i, b_rows + i, true);
    flash_tc::cp_async_commit();
  };
  int g = blockIdx.y;
  if (fetcher && g < groups) prefetch(g, 0);
  int worked = 0;  // active groups so far: uniform in the cluster
  for (int it = 0; g < groups; ++it, g += gridDim.y) {
    const int next = g + gridDim.y;
    const int l0 = g * r;
    const int j = l0 / a.l_tile;
    const float scale = a.scales != nullptr ? a.scales[j] : 1.0f;
    // uniform in the cluster: its blocks share the tile
    const bool active = !EARLY_EXIT || a.conv[j] == 0;
    const size_t row0 = (size_t)l0 * H;
    float* cr = crs + (it & 1) * r * H;
    const T* src = u + (size_t)l0 * HC;
    size_t kstride = kstride_u;
    if (fetcher) {  // the other buffers were freed by the last closing barrier
      if (next < groups) {
        prefetch(next, (it + 1) & 1);
      } else {
        flash_tc::cp_async_commit();
      }
      flash_tc::cp_async_wait<1>();  // this group's b rows (and û copies)
    }
    if (STAGED) {
      if (bulk) mbar_wait(&bars[it & 1], (uint32_t)((it >> 1) & 1));
      src = reinterpret_cast<const T*>(smem + (it & 1) * sb);
      kstride = (size_t)r * HC;
    }
    __syncthreads();  // the group's copies have landed
    if (!active) {  // a converged tile works from its frozen couplings
      for (int i = threadIdx.x; i < r * H; i += blockDim.x)
        cr[i] = a.c_frozen[row0 + i];
      __syncthreads();
    }

    if (active) {
      float* part = parts + (worked & 1) * r * H;
      ++worked;
      // deferred Eq.4: db[l,h] = Σ_{k,c} û[k,l,h,c] · v_prev[k,h,c], as
      // column sums over this block's batch rows, then, a warp a row, over c
      // (none from a zero state: db = 0 for finite û)
      for (int q = threadIdx.x * V; !a.zero_state && q < r * HC;
           q += blockDim.x * V) {
        const float* vp = vrows + q % HC;
        float t[V] = {}, x[V], y[V];
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          loadv(src + k * kstride + q, x, scale);
          loadv(vp + k * HC, y, 1.0f);
#pragma unroll
          for (int e = 0; e < V; ++e) t[e] += x[e] * y[e];
        }
#pragma unroll
        for (int e = 0; e < V; ++e) w[q + e] = t[e];
      }
      __syncthreads();
      for (int l = warp; !a.zero_state && l < r; l += kTileWarps) {
        for (int h = lane; h < H; h += 32) {
          const float* wr = w + l * HC + h * C;
          float t = 0.0f;
          for (int c = 0; c < C; ++c) t += wr[c];
          part[l * H + h] = t;
        }
      }
      // every rank's part is in place.  A rank
      // overwrites this parity's part two active groups later, after the
      // next barrier, which no rank passes before it has read these parts.
      if (!a.zero_state) cluster.sync();
      // a warp a row: the ranks' parts added in rank order, b_new = b +
      // db, then Eq.5's softmax over H across the lanes
      for (int l = warp; !REVERSE && l < r; l += kTileWarps) {
        float* row = cr + l * H;
        float m = -__int_as_float(0x7f800000), dmax = 0.0f;  // -inf
        for (int h = lane; h < H; h += 32) {
          float db = 0.0f, bn = 0.0f;
          if (!a.zero_state) {
            float got[kMaxCluster];  // all ranks' parts in flight at once
#pragma unroll
            for (int q = 0; q < kMaxCluster; ++q)
              got[q] = q < a.cluster
                  ? cluster.map_shared_rank(part, q)[l * H + h] : 0.0f;
#pragma unroll
            for (int q = 0; q < kMaxCluster; ++q)
              if (q < a.cluster) db += got[q];
            bn = row[h] + db;
          }
          row[h] = bn;
          if (rank == 0) a.b_out[row0 + l * H + h] = bn;
          m = fmaxf(m, bn);
          if (EARLY_EXIT) dmax = fmaxf(dmax, fabsf(db));
        }
        m = warp_max(m);
        float sum = 0.0f;
        for (int h = lane; h < H; h += 32) {
          const float e = APPROX ? routing::fast_exp<true>(__fsub_rn(row[h], m))
                                 : expf(row[h] - m);
          row[h] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        const float inv = APPROX ? routing::fast_recip<true>(sum) : 0.0f;
        for (int h = lane; h < H; h += 32) {
          const float c = APPROX ? __fmul_rn(row[h], inv)
                                 : __fdiv_rn(row[h], sum);
          row[h] = c;
          if (rank == 0) {
            if (EARLY_EXIT) a.c_frozen[row0 + l * H + h] = c;
            if (a.c_out != nullptr) a.c_out[row0 + l * H + h] = c;
          }
        }
        if (EARLY_EXIT) {
          dmax = warp_max(dmax);
          if (lane == 0) rowmax[l] = dmax;
        }
      }
      // reverse, a warp a row: gc = the ranks' parts added in rank order
      // (kept in w, which the cluster barrier freed), then Eq.5's vjp
      // folded into the running ∂b: ∂b += c_t ⊙ (gc − Σ_H c_t·gc)
      for (int l = warp; REVERSE && l < r; l += kTileWarps) {
        float* row = cr + l * H;
        float* gcr = w + l * H;
        const float* ct = a.c_rev + row0 + l * H;
        float dot = 0.0f;
        for (int h = lane; h < H; h += 32) {
          float got[kMaxCluster];
#pragma unroll
          for (int q = 0; q < kMaxCluster; ++q)
            got[q] = q < a.cluster
                ? cluster.map_shared_rank(part, q)[l * H + h] : 0.0f;
          float gc = 0.0f;
#pragma unroll
          for (int q = 0; q < kMaxCluster; ++q)
            if (q < a.cluster) gc += got[q];
          gcr[h] = gc;
          dot += __ldg(ct + h) * gc;
        }
        dot = warp_sum(dot);
        for (int h = lane; h < H; h += 32) {
          const float g = row[h] + __ldg(ct + h) * (gcr[h] - dot);
          row[h] = g;
          if (rank == 0) {
            a.b_out[row0 + l * H + h] = g;
            a.c_out[row0 + l * H + h] = g;
          }
        }
      }
      __syncthreads();
      if (EARLY_EXIT && rank == 0 && threadIdx.x == 0) {
        float d = 0.0f;
        for (int l = 0; l < r; ++l) d = fmaxf(d, rowmax[l]);
        a.gmax[g] = d;
      }
    }

    // partial Eq.2: the slot's sums gather Σ_{l in rows} c[l,h] ·
    // û[k,l,h,c] over its groups in walk order (each element has one
    // owner thread)
    for (int o = threadIdx.x * V; o < kn * HC; o += blockDim.x * V) {
      const int k = o / HC, hc = o - k * HC;
      const T* p = src + k * kstride + hc;
      const float* cp = cr + hc / C;  // V | C: one capsule for the V
      float t[V] = {}, x[V];
#pragma unroll 4
      for (int l = 0; l < r; ++l) {
        loadv(p + (size_t)l * HC, x, scale);
        const float c = cp[l * H];
#pragma unroll
        for (int e = 0; e < V; ++e) t[e] += c * x[e];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (STAGED) {
          acc[o + e] += t[e];
        } else {
          out[o + e] = it == 0 ? t[e] : out[o + e] + t[e];
        }
      }
    }
    __syncthreads();  // this group's buffer, w and cr are free again
  }
  flash_tc::cp_async_wait<0>();
  if (STAGED) {
    for (int o = threadIdx.x; o < kn * HC; o += blockDim.x) out[o] = acc[o];
  }
  // no block leaves while another rank may still read its parts
  cluster.sync();
}

template <typename T, bool APPROX, bool EARLY_EXIT, bool STAGED, int V>
__global__ void __launch_bounds__(kTileThreads, 2)
routing_tile_kernel(const TileArgs a) {
  tile_body<T, APPROX, EARLY_EXIT, STAGED, V, false>(a);
}

// The backward's reverse sweep (routing_bwd.cu) on the same cells: v_prev
// is gs_t, so the Eq.4 pass sums gc = Σ_{k,c} û·gs_t; b_in / b_out are
// the running ∂b and c_out its snapshot ∂b_t; c_rev holds c_t; Eq.2 sums
// Σ_l ∂b_t·û, the ∂v carry.  û is read once, from the staged copy.
template <typename T, bool STAGED, int V>
__global__ void __launch_bounds__(kTileThreads, 2)
reverse_tile_kernel(const TileArgs a) {
  tile_body<T, false, false, STAGED, V, true>(a);
}

// ---- reduce kernel: Σ over row groups in order, then Eq.3 squash ----------
//
// A block owns R = max(1, 32 / C) rows (k, h), R·C elements, 32 at a time
// on the lanes; its 8 warps sum 8 contiguous ranges of the slots, and the
// ranges are then added in order: out[k,h,c] = Σ_y partial[y,k,h,c].
// One thread per row then squashes it over C when SQUASH (procedure form;
// the iteration form returns s unsquashed).  s_out, when set, also
// receives the unsquashed sum (the backward's replay snapshot of s_t).
// Under early exit the last block instead folds each tile's row-group
// maxima into its flag — ‖Δb‖∞ < ε freezes the tile from the next
// iteration on; iteration 0 (v_prev = 0, so Δb ≡ 0) is exempt, and ε = 0
// never freezes — and adds the tiles that worked this iteration to cnt.
// With VJP (the backward's reverse sweep) the sum is ∂v and one thread a
// row turns it into gs = squash_vjp(s_t, ∂v), the exact squash's vjp
// written out: ∂s = f·∂v + 2·f'(n2)·<s,∂v>·s with n2 = |s|²,
// f = n2 / ((1+n2)·sqrt(n2+1e-9)), f' = a·r·(a − n2·r²/2), a = 1/(1+n2),
// r = 1/sqrt(n2+1e-9) — finite at s = 0, where f = 0, so zero (padding)
// lanes get exactly zero gradient.

constexpr int kReduceSegments = kReduceThreads / 32;

template <bool SQUASH, bool APPROX, bool VJP>
__device__ __forceinline__ void reduce_body(const TileArgs& a,
                                            float* __restrict__ out,
                                            float* __restrict__ s_out,
                                            const float* __restrict__ s_t,
                                            bool early_exit) {
  __shared__ float seg_sum[kReduceSegments][32];
  __shared__ int red[kReduceSegments];
  const int C = a.C, BH = a.B * a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (early_exit && blockIdx.x == gridDim.x - 1) {
    const int per_tile = a.l_tile / a.rows;
    int worked = 0;
    for (int j = threadIdx.x; j < a.L / a.l_tile; j += blockDim.x) {
      if (a.conv[j] != 0) continue;
      ++worked;
      float d = 0.0f;
      for (int q = 0; q < per_tile; ++q) d = fmaxf(d, a.gmax[j * per_tile + q]);
      if (a.iteration > 0 && d < a.eps) a.conv[j] = 1;
    }
    for (int o = 16; o > 0; o >>= 1) worked += __shfl_xor_sync(0xffffffffu, worked, o);
    if (lane == 0) red[warp] = worked;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int q = 0; q < kReduceSegments; ++q) total += red[q];
      *a.cnt += total;
    }
    return;
  }
  const int R = C >= 32 ? 1 : 32 / C;
  const int row0 = blockIdx.x * R;
  const int E = min(R, BH - row0) * C;
  const int g0 = warp * a.slots / kReduceSegments;
  const int g1 = (warp + 1) * a.slots / kReduceSegments;
  const size_t stride = (size_t)BH * C;
  const size_t e0 = (size_t)row0 * C;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    float s = 0.0f;
    if (e < E) {
      const float* p = a.partial + e0 + e;
#pragma unroll 4
      for (int g = g0; g < g1; ++g) s += p[(size_t)g * stride];
    }
    seg_sum[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && e < E) {
      float t = seg_sum[0][lane];
      for (int q = 1; q < kReduceSegments; ++q) t += seg_sum[q][lane];
      out[e0 + e] = t;
      if (s_out != nullptr) s_out[e0 + e] = t;
    }
    __syncthreads();
  }
  if (SQUASH) {
    for (int rr = threadIdx.x; rr * C < E; rr += blockDim.x) {
      float* o = out + e0 + (size_t)rr * C;
      float n2 = 0.0f;
      for (int c = 0; c < C; ++c) n2 += o[c] * o[c];
      squash_row<APPROX>(o, C, n2);
    }
  }
  if (VJP) {
    for (int rr = threadIdx.x; rr * C < E; rr += blockDim.x) {
      float* o = out + e0 + (size_t)rr * C;
      const float* s = s_t + e0 + (size_t)rr * C;
      float n2 = 0.0f, dot = 0.0f;
      for (int c = 0; c < C; ++c) {
        n2 += s[c] * s[c];
        dot += s[c] * o[c];
      }
      const float ia = 1.0f / (1.0f + n2);
      const float ir = 1.0f / sqrtf(n2 + 1e-9f);
      const float f = n2 * ia * ir;
      const float fp = ia * ir * (ia - 0.5f * n2 * ir * ir);
      for (int c = 0; c < C; ++c) o[c] = f * o[c] + 2.0f * fp * dot * s[c];
    }
  }
}

template <bool SQUASH, bool APPROX>
__global__ void __launch_bounds__(kReduceThreads)
routing_reduce_kernel(const TileArgs a, float* __restrict__ out,
                      float* __restrict__ s_out, bool early_exit) {
  reduce_body<SQUASH, APPROX, false>(a, out, s_out, nullptr, early_exit);
}

__global__ void __launch_bounds__(kReduceThreads)
reverse_reduce_kernel(const TileArgs a, float* __restrict__ gs_out,
                      const float* __restrict__ s_t) {
  reduce_body<false, false, true>(a, gs_out, nullptr, s_t, false);
}

// ---- host-side dispatch ----------------------------------------------------

// The clusters the card holds at once for this kernel and shared memory
// (cudaOccupancyMaxActiveClusters).  The opt-in to more than 48 KB of
// shared memory and the occupancy are asked once per kernel, device and
// size.
struct SlotCache {
  int dev = -1, cluster = 0, clusters = 0;
  size_t smem = 0;
};

template <typename Kernel>
cudaError_t tile_clusters(Kernel kernel, const TileArgs& a, size_t smem,
                          SlotCache& cache, int* clusters) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cache.dev || smem != cache.smem || a.cluster != cache.cluster) {
    if (smem > (size_t)kDefaultSmem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)a.cluster, 1);
    cfg.blockDim = dim3(kTileThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    cache.dev = dev;
    cache.smem = smem;
    cache.cluster = a.cluster;
    cache.clusters = n;
  }
  *clusters = cache.clusters;
  return cudaSuccess;
}

// Launches the tile kernel on a grid of (cluster, a.slots), or, with
// `clusters` set, only reports the clusters the card holds at once.
template <typename T, bool APPROX, bool EARLY_EXIT, bool STAGED, int V,
          bool REVERSE = false>
cudaError_t launch_tile_t(const TileArgs& a, cudaStream_t stream,
                          int* clusters) {
  const size_t smem = tile_smem_bytes(a, sizeof(T), STAGED);
  void (*kernel)(const TileArgs);
  if constexpr (REVERSE) {
    kernel = reverse_tile_kernel<T, STAGED, V>;
  } else {
    kernel = routing_tile_kernel<T, APPROX, EARLY_EXIT, STAGED, V>;
  }
  static SlotCache cache;  // one per kernel instantiation
  int held = 0;
  cudaError_t err = tile_clusters(kernel, a, smem, cache, &held);
  if (err != cudaSuccess) return err;
  if (clusters != nullptr) {
    *clusters = held;
    return cudaSuccess;
  }
  if (a.slots < 1 || a.slots > held || a.slots > a.L / a.rows) {
    return cudaErrorInvalidValue;  // resolve_slots was not called
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.cluster, (unsigned)a.slots);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Four columns a thread where a capsule's C lanes split into fours and û is
// 16-byte aligned (every Table-1 shape: C = 16), one otherwise; the sums
// run in the same order either way.  a.c_rev set: the reverse sweep.
template <typename T, bool APPROX, bool EARLY_EXIT>
cudaError_t launch_tile_staged(const TileArgs& a, cudaStream_t stream,
                               int* clusters) {
  const bool quad = a.C % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(a.u) % 16 == 0;
  if (a.c_rev != nullptr) {  // fp32 or bf16, exact, no early exit
    if constexpr (sizeof(T) == 1 || APPROX || EARLY_EXIT) {
      return cudaErrorInvalidValue;
    } else if (a.staged) {
      return quad ? launch_tile_t<T, false, false, true, 4, true>(a, stream, clusters)
                  : launch_tile_t<T, false, false, true, 1, true>(a, stream, clusters);
    } else {
      return quad ? launch_tile_t<T, false, false, false, 4, true>(a, stream, clusters)
                  : launch_tile_t<T, false, false, false, 1, true>(a, stream, clusters);
    }
  }
  if (a.staged) {
    return quad ? launch_tile_t<T, APPROX, EARLY_EXIT, true, 4>(a, stream, clusters)
                : launch_tile_t<T, APPROX, EARLY_EXIT, true, 1>(a, stream, clusters);
  }
  return quad ? launch_tile_t<T, APPROX, EARLY_EXIT, false, 4>(a, stream, clusters)
              : launch_tile_t<T, APPROX, EARLY_EXIT, false, 1>(a, stream, clusters);
}

template <typename T>
cudaError_t launch_tile_dtype(const TileArgs& a, bool approx, bool early_exit,
                              cudaStream_t stream, int* clusters) {
  if (approx) {
    return early_exit ? launch_tile_staged<T, true, true>(a, stream, clusters)
                      : launch_tile_staged<T, true, false>(a, stream, clusters);
  }
  return early_exit ? launch_tile_staged<T, false, true>(a, stream, clusters)
                    : launch_tile_staged<T, false, false>(a, stream, clusters);
}

cudaError_t launch_tile_any(const TileArgs& a, int dtype, bool approx,
                            bool early_exit, cudaStream_t stream,
                            int* clusters) {
  if (a.rows < 1 || a.rows > kTileThreads || a.l_tile % a.rows != 0 ||
      a.L % a.l_tile != 0 ||
      a.cluster < 1 || a.cluster > 8 ||
      (long long)a.cluster * a.batch_chunk < a.B ||
      (long long)(a.cluster - 1) * a.batch_chunk >= a.B ||
      (early_exit && a.gmax == nullptr) ||
      (a.c_rev != nullptr && (a.zero_state || a.c_out == nullptr))) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0: return launch_tile_dtype<float>(a, approx, early_exit, stream, clusters);
    case 1: return launch_tile_dtype<__nv_bfloat16>(a, approx, early_exit, stream, clusters);
    case 2: return launch_tile_dtype<int8_t>(a, approx, early_exit, stream, clusters);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace routing {

cudaError_t resolve_slots(TileArgs& a, int dtype, bool approx,
                          bool early_exit) {
  int held = 0;
  cudaError_t err = launch_tile_any(a, dtype, approx, early_exit, nullptr,
                                    &held);
  if (err != cudaSuccess) return err;
  if (a.slots < 1 || a.slots > a.L / a.rows) return cudaErrorInvalidValue;
  a.slots = min(a.slots, held);
  return cudaSuccess;
}

cudaError_t launch_tile(const TileArgs& a, int dtype, bool approx,
                        bool early_exit, cudaStream_t stream) {
  return launch_tile_any(a, dtype, approx, early_exit, stream, nullptr);
}

cudaError_t launch_reduce(const TileArgs& a, float* out, float* s_out,
                          bool squash, bool approx, bool early_exit,
                          cudaStream_t stream) {
  const int R = a.C >= 32 ? 1 : 32 / a.C;
  const int blocks = (a.B * a.H + R - 1) / R + (early_exit ? 1 : 0);
  if (!squash) {
    routing_reduce_kernel<false, false><<<blocks, kReduceThreads, 0, stream>>>(
        a, out, s_out, early_exit);
  } else if (approx) {
    routing_reduce_kernel<true, true><<<blocks, kReduceThreads, 0, stream>>>(
        a, out, s_out, early_exit);
  } else {
    routing_reduce_kernel<true, false><<<blocks, kReduceThreads, 0, stream>>>(
        a, out, s_out, early_exit);
  }
  return cudaGetLastError();
}

cudaError_t launch_reduce_vjp(const TileArgs& a, float* gs_out,
                              const float* s_t, cudaStream_t stream) {
  const int R = a.C >= 32 ? 1 : 32 / a.C;
  const int blocks = (a.B * a.H + R - 1) / R;
  reverse_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(a, gs_out,
                                                               s_t);
  return cudaGetLastError();
}

}  // namespace routing

extern "C" {

// The whole procedure: `iterations` × (tile, reduce+squash) on one stream.
// v (B,H,C) and b (L,H) need no initial values: iteration 0 of the
// lazy-update schedule starts from b = 0, v_prev = 0, which the first tile
// launch takes as given and writes b from; v holds the result.
// partial is (slots, B, H, C).  Early exit: conv (L/l_tile) and cnt (1)
// zero on entry, gmax (L/rows) and c_frozen (L,H) scratch.  Returns the
// CUDA error of the first launch that failed, or 0.
int routing_procedure(const void* u, int dtype, const float* scales,
                      float* v, float* b, float* partial, float* gmax,
                      int* conv, float* c_frozen, int* cnt, int B, int L,
                      int H, int C, int l_tile, int rows, int batch_chunk,
                      int cluster, int staged, int slots, int iterations,
                      int use_approx, int early_exit, float eps,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  routing::TileArgs a{u, scales, v, b, b, partial, gmax, conv, c_frozen, cnt,
                      nullptr, B, L, H, C, l_tile, 0, eps, rows, batch_chunk,
                      cluster, staged, slots};
  cudaError_t err = routing::resolve_slots(a, dtype, use_approx != 0,
                                           early_exit != 0);
  if (err != cudaSuccess) return (int)err;
  for (int it = 0; it < iterations; ++it) {
    a.iteration = it;
    a.zero_state = it == 0;
    err = routing::launch_tile(a, dtype, use_approx != 0, early_exit != 0, s);
    if (err != cudaSuccess) return (int)err;
    err = routing::launch_reduce(a, v, nullptr, true, use_approx != 0,
                                 early_exit != 0, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// One lazy-update iteration: s (B,H,C) = Eq.2 sum, b_out (L,H) = b_in + Eq.4.
int routing_iteration(const void* u, int dtype, const float* b_in,
                      const float* v_prev, float* s, float* b_out,
                      float* partial, int B, int L, int H, int C, int l_tile,
                      int rows, int batch_chunk, int cluster, int staged,
                      int slots, int use_approx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  routing::TileArgs a{u, nullptr, v_prev, b_in, b_out, partial, nullptr,
                      nullptr, nullptr, nullptr, nullptr, B, L, H, C, l_tile,
                      0, 0.0f, rows, batch_chunk, cluster, staged, slots};
  cudaError_t err = routing::resolve_slots(a, dtype, use_approx != 0, false);
  if (err != cudaSuccess) return (int)err;
  err = routing::launch_tile(a, dtype, use_approx != 0, false, st);
  if (err != cudaSuccess) return (int)err;
  return (int)routing::launch_reduce(a, s, nullptr, false, false, false, st);
}

// The tile kernel's launched blocks (cluster × slots after resolve_slots)
// for the geometry, or a negative CUDA error: what routing_procedure and
// routing_iteration launch with the same arguments, or with `reverse` the
// backward's reverse sweep (routing_procedure_backward).
int routing_tile_blocks(int dtype, int B, int L, int H, int C, int l_tile,
                        int rows, int batch_chunk, int cluster, int staged,
                        int slots, int use_approx, int early_exit,
                        int reverse) {
  float dummy = 0.0f;
  routing::TileArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      early_exit ? &dummy : nullptr, nullptr, nullptr,
                      nullptr, reverse ? &dummy : nullptr, B, L, H, C,
                      l_tile, 0, 0.0f, rows, batch_chunk, cluster, staged,
                      slots};
  a.c_rev = reverse ? &dummy : nullptr;
  cudaError_t err = routing::resolve_slots(a, dtype, use_approx != 0,
                                           early_exit != 0);
  return err == cudaSuccess ? a.slots * a.cluster : -(int)err;
}

const char* routing_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
