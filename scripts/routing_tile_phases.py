#!/usr/bin/env python3
"""Per-phase cycle profile of the routing tile kernel on the card.

    python3 scripts/routing_tile_phases.py [--dtype fp32 bf16] [--rows 2 4 8]

Builds an instrumented copy of ``src/repro_torch/csrc/routing.cu`` into
``build/routing_phases/``: thread 0 of every block reads ``clock64`` at
the marks between the kernel's phases and adds each interval to a
per-phase counter (one atomic a mark).  Binds its ``routing_procedure``
with ctypes, runs the whole procedure (3 iterations) at Caps-MN1, B=100,
on seeded random votes for each requested number of rows a group (the
clusters and batch chunks of ``ops.tile_geometry``), checks v against the
plain version (max|Δ| ≤ 1e-5), and prints the mean cycles a block spends
in each phase per row group (over the three iterations; the first, from
a zero state, skips Eq.4 and the exchange), with the call's median time
over 20 CUDA-event-timed calls.  Needs one Hopper card and nvcc; the marks are
found by their text in the source, so an edited kernel fails loudly.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("loop", "fetch + wait", "eq4 + parts", "cluster barrier",
          "exchange + softmax", "gmax", "eq2", "exit barrier")
# (text in routing.cu, the mark that follows or precedes it)
MARKS = (
    ("  int worked = 0;  // active groups so far: uniform in the cluster\n",
     "  int worked = 0;  // active groups so far: uniform in the cluster\n"
     "  long long T0 = clock64(), T1;\n"),
    ("    const int l0 = g * r;\n",
     "    MARK(0)\n    const int l0 = g * r;\n"),
    ("    }\n\n    if (active) {\n      float* part = parts + (worked & 1)",
     "    }\n    MARK(1)\n\n    if (active) {\n"
     "      float* part = parts + (worked & 1)"),
    ("      // every rank's part is in place.",
     "      MARK(2)\n      // every rank's part is in place."),
    ("      if (!a.zero_state) cluster.sync();\n      // a warp a row:",
     "      if (!a.zero_state) cluster.sync();\n      MARK(3)\n"
     "      // a warp a row:"),
    ("      if (EARLY_EXIT && rank == 0 && threadIdx.x == 0) {\n",
     "      MARK(4)\n      if (EARLY_EXIT && rank == 0 && threadIdx.x == 0) {\n"),
    ("    // partial Eq.2: the slot's sums gather",
     "    MARK(5)\n    // partial Eq.2: the slot's sums gather"),
    ("    __syncthreads();  // this group's buffer, w and cr are free again\n"
     "  }",
     "    __syncthreads();  // this group's buffer, w and cr are free again\n"
     "    MARK(6)\n  }"),
    ("  // no block leaves while another rank may still read its parts\n"
     "  cluster.sync();\n}",
     "  // no block leaves while another rank may still read its parts\n"
     "  cluster.sync();\n  MARK(7)\n}"),
)
HEADER = """#include "routing.cuh"
__device__ unsigned long long g_phase[8];
#define MARK(k) if (threadIdx.x == 0) { T1 = clock64(); \\
  atomicAdd(&g_phase[k], (unsigned long long)(T1 - T0)); T0 = T1; }
"""
READER = """
extern "C" int phases_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[8] = {0};
  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return (int)e;
}
"""


def build(cudalib) -> ctypes.CDLL:
    src_dir = os.path.join(ROOT, "src", "repro_torch", "csrc")
    with open(os.path.join(src_dir, "routing.cu")) as f:
        src = f.read()
    for text, marked in MARKS:
        if src.count(text) != 1:
            raise SystemExit(f"routing.cu changed: mark text not found once: "
                             f"{text.strip()[:60]!r}")
        src = src.replace(text, marked)
    src = src.replace('#include "routing.cuh"\n', HEADER, 1) + READER
    out = os.path.join(ROOT, "build", "routing_phases")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "routing_phases.cu"), os.path.join(
        out, "routing_phases.so")
    with open(cu, "w") as f:
        f.write(src)
    flags = [f for f in cudalib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cudalib._nvcc(), *flags, "-shared", f"-I{src_dir}",
                    "-o", so, cu], check=True, timeout=600)
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.routing_procedure.argtypes = [p, i, p] + [p] * 7 + [i] * 13 + [f, p]
    lib.routing_procedure.restype = i
    lib.phases_read.argtypes = [p]
    lib.phases_read.restype = i
    return lib


def median_ms(fn, runs: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", nargs="+", default=["fp32", "bf16"])
    ap.add_argument("--rows", nargs="+", type=int, default=None,
                    help="rows a group (default: ops.tile_geometry's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("routing_tile_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cudalib
    from repro_torch.kernels.routing import kernel, ops
    lib = build(cudalib)
    counters = (ctypes.c_ulonglong * 8)()
    B, L, H, C, iters = 100, 1152, 10, 16, 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    votes = torch.randn(B, L, H, C, device="cuda", generator=gen) * 0.05
    for sd in args.dtype:
        u = votes.to(ops.STREAM_DTYPES[sd]).contiguous()
        l_tile = ops.procedure_l_tile(B, L, H, C, sd)
        chosen = ops.tile_geometry(B, L, H, C, l_tile, sd)
        for rows in args.rows or [chosen.rows]:
            kb, cluster = chosen.batch_chunk, chosen.cluster
            smem = ops.tile_smem_bytes(rows, kb, H, C, u.element_size(),
                                       True)
            slots = max(1, min(L // rows, ops.SM_COUNT
                               * ops.tile_blocks_per_sm(smem) // cluster))
            v = torch.zeros(B, H, C, device="cuda")
            b = torch.zeros(L, H, device="cuda")
            partial = torch.empty(slots, B, H, C, device="cuda")

            def run():
                v.zero_()
                b.zero_()
                err = lib.routing_procedure(
                    u.data_ptr(), {"fp32": 0, "bf16": 1}[sd], None,
                    v.data_ptr(), b.data_ptr(), partial.data_ptr(), None,
                    None, None, None, B, L, H, C, l_tile, rows, kb, cluster,
                    1, slots, iters, 0, 0, 0.0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"routing_procedure: CUDA error {err}")

            run()
            want = kernel.routing_procedure_fused_plain(u, iterations=iters,
                                                        l_tile=l_tile)
            delta = float((v - want).abs().max())
            if delta > 1e-5:
                raise SystemExit(f"{sd} rows={rows}: max|Δ| {delta:.3g}")
            ms = median_ms(run)
            lib.phases_read(counters)
            run()
            lib.phases_read(counters)
            per_group = [c / (L // rows * cluster * iters)
                         for c in counters[:7]]
            exit_wait = counters[7] / (slots * cluster * iters)
            print(f"[phases] {sd} rows={rows} batch_chunk={kb} "
                  f"cluster={cluster} slots={slots} smem={smem} "
                  f"max|Δ|={delta:.2e} {ms:.4f} ms; cycles a block spends "
                  "per row group: " + ", ".join(
                      f"{name} {c:.0f}" for name, c in zip(PHASES,
                                                           per_group))
                  + f"; {PHASES[7]} {exit_wait:.0f} a block")
    return 0


if __name__ == "__main__":
    sys.exit(main())
