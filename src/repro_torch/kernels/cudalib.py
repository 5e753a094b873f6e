"""The port's one CUDA library: the ``nvcc`` build of every source under
``repro_torch/csrc``, its ctypes binding and the launch helpers the kernel
families share (``kernels/routing``, ``kernels/fastmath``,
``kernels/flash_attention``, ``kernels/ssm_scan``).

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use — one
``nvcc`` per source, all started together, then one link — into a shared
library with a plain C interface in ``build/kernels/`` under the checkout,
keyed on a hash of the sources and flags, and bound with ``ctypes``.  One
build and one ``.so`` cover every kernel, so a kernel that does not
compile fails every family's first launch the same way.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = ("routing.cu", "routing_bwd.cu", "routing_stage.cu",
            "em_routing.cu", "fastmath.cu", "flash_attention.cu",
            "flash_attention_bwd.cu", "flash_attention_wide.cu",
            "ssm_scan.cu")
_HEADERS = ("routing.cuh", "flash_tc.cuh")
# build/kernels/ in the checkout (src/repro_torch/kernels -> root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no --use_fast_math: the E-step's logits reach 1e9·(v−μ)² on padded lanes
# and the §5.2.2 helpers rely on IEEE rounding and subnormals
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class BuildInfo:
    """What the last ``build()`` did: the library path, whether it compiled
    (False when the hashed library already existed), the seconds it took
    and the compiler's register/shared-memory report (``-Xptxas -v``)."""
    path: Optional[str] = None
    compiled: bool = False
    seconds: float = 0.0
    log: str = ""


build_info = BuildInfo()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                       "toolkit's bin/ on PATH to build the kernels")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.routing_procedure.argtypes = [
        p, i, p, p, p, p, p, p, p, p,       # u, dtype, scales, v, b, partial,
                                            # gmax, conv, c_frozen, cnt
        i, i, i, i, i,                      # B, L, H, C, l_tile
        i, i, i, i, i,                      # rows, batch_chunk, cluster,
                                            # staged, slots
        i, i, i, f, p]                      # iterations, approx, early exit
    lib.routing_procedure.restype = i
    lib.routing_iteration.argtypes = [
        p, i, p, p, p, p, p,                  # u, dtype, b, v_prev, s, b_out,
                                              # partial
        i, i, i, i, i, i, i, i, i, i, i, p]   # sizes, geometry, approx
    lib.routing_iteration.restype = i
    lib.routing_procedure_backward.argtypes = [
        p, i, p, p, p, p, p, p, p, p, p, p,   # u, dtype, g, du, scratch...
        i, i, i, i, i,                        # B, L, H, C, l_tile
        i, i, i, i, i,                        # rows, batch_chunk, cluster,
                                              # staged, slots
        i, i, p]                              # iterations, approx
    lib.routing_procedure_backward.restype = i
    lib.routing_tile_blocks.argtypes = [i] * 14  # dtype, sizes, geometry,
                                                 # approx, early exit, reverse
    lib.routing_tile_blocks.restype = i
    lib.routing_stage_votes.argtypes = [
        p, i, p, p, p,                        # u, dtype, c, s, partial
        i, i, i, i, i, i, p]                  # B, L, H, C, chunk rows, chunks
    lib.routing_stage_votes.restype = i
    lib.routing_stage_update.argtypes = [
        p, i, p, p, p, p, p, p,               # u, dtype, s, v, db, b, b_out, c
        i, i, i, i, i, i,                     # B, L, H, C, approx, fold
        i, i, i, i, i, i, i, i, i, i, p]      # rows, slices, passes,
                                              # vector, ring, chunk rows,
                                              # chunks, threads, blocks,
                                              # shared bytes
    lib.routing_stage_update.restype = i
    lib.em_stage_stats.argtypes = [
        p, p, p, i, i, p, p, p, p,            # votes, r, a_in + strides, outs
        i, i, i, i, i, i, p]                  # B, L, H, C, chunk rows, chunks
    lib.em_stage_stats.restype = i
    lib.em_stage_estep.argtypes = [
        p, p, p, p, p,                        # votes, mu, isig, bias, r
        i, i, i, i,                           # B, L, H, C
        i, i, i, i, i, i, p]                  # rows a pass, h a lane,
                                              # vector, warps, blocks,
                                              # h-passes
    lib.em_stage_estep.restype = i
    lib.fastmath_apply.argtypes = [p, p, ctypes.c_longlong, i, i, p]
    lib.fastmath_apply.restype = i
    lib.flash_attention_fwd.argtypes = [
        p, p, p, p, p, i,                     # q, k, v, o, lse or NULL, dtype
        i, i, i, i, i, i, f, i, i, p]         # B, Hq, Hkv, Sq, Sk, D, scale,
                                              # causal, window (0: none)
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_bwd.argtypes = [
        p, p, p, p, p, p,                     # q, k, v, dO, lse, delta
        p, p, p, i,                           # dq, dk_h, dv_h, dtype
        i, i, i, i, i, i, f, i, i, p]         # B, Hq, Hkv, Sq, Sk, D, scale,
                                              # causal, window (0: none)
    lib.flash_attention_bwd.restype = i
    # the same interfaces for head dims above 256 (flash_attention_wide.cu),
    # fp32, with the geometry before the stream
    lib.flash_attention_wide_fwd.argtypes = [
        *lib.flash_attention_fwd.argtypes[:-1],
        i, i, i, i, p]                        # pieces, piece columns,
                                              # groups, shared bytes
    lib.flash_attention_wide_fwd.restype = i
    lib.flash_attention_wide_bwd.argtypes = [
        *lib.flash_attention_bwd.argtypes[:-1],
        i, i, i, i, p]                        # pieces, piece columns,
                                              # groups, shared bytes
    lib.flash_attention_wide_bwd.restype = i
    lib.flash_attention_wide_fwd_tc.argtypes = [
        p, p, p, p, p,                        # q, k, v, o, lse or NULL
        i, i, i, i, i, i, f, i, i,            # B, Hq, Hkv, Sq, Sk, D, scale,
                                              # causal, window (0: none)
        i, i, i, i, p]                        # pieces, piece columns,
                                              # pairs, shared bytes
    lib.flash_attention_wide_fwd_tc.restype = i
    lib.flash_attention_wide_bwd_tc.argtypes = [
        p, p, p, p, p, p,                     # q, k, v, dO, lse, delta
        p, p, p,                              # dq, dk_h, dv_h
        i, i, i, i, i, i, f, i, i,            # B, Hq, Hkv, Sq, Sk, D, scale,
                                              # causal, window (0: none)
        i, i, i, i, i, i, i, i, p]            # pairs, ds terms, dq pieces,
                                              # dq columns, dk/dv pieces,
                                              # dk/dv columns, shared bytes
                                              # of each kernel
    lib.flash_attention_wide_bwd_tc.restype = i
    lib.selective_scan_fwd.argtypes = [
        p, p, p, p, p, p, p, p, p,            # x, dt, A, B, C, D, h0, y, hT
        i, i, i, i, i, p]                     # dtype, Bt, T, Din, N
    lib.selective_scan_fwd.restype = i
    lib.routing_error_string.argtypes = [i]
    lib.routing_error_string.restype = ctypes.c_char_p
    return lib


def _compile(out: Path) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link into
    ``out``.  Every started compiler is waited for before a failure is
    raised.  Returns the compilers' output."""
    nvcc = _nvcc()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{name}.o") for name in _SOURCES]
        jobs = []
        for name, obj in zip(_SOURCES, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(_CSRC / name)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in jobs:
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = Path(tmp) / "kernels.so"
        cmd = [nvcc, "-shared", "-o", str(so), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log[-1]}")
        os.replace(so, out)
    return "".join(log)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load every kernel.

    The library lands in ``BUILD_DIR/kernels_<hash>.so``; an edited source
    or flag set gets a new hash and so a rebuild.  The build runs in a
    temporary directory and the library is renamed into place, so a
    concurrent or interrupted build never leaves a half-written library
    behind."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"kernels_{_source_hash()}.so"
        compiled = False
        log = ""
        if not out.exists():
            log = _compile(out)
            compiled = True
        _lib = _bind(ctypes.CDLL(str(out)))
        build_info.path = str(out)
        build_info.compiled = compiled
        build_info.seconds = time.perf_counter() - t0
        build_info.log = log
        return _lib


def check(err: int) -> None:
    """Raise on a launch's ``cudaGetLastError()`` code (0 is success)."""
    if err != 0:
        msg = _lib.routing_error_string(err).decode()
        raise RuntimeError(f"kernel launch failed: CUDA error {err} "
                           f"({msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
