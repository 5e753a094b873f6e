#!/usr/bin/env python3
"""The fp32 attention kernels up to D = 256 (split TF32 on the tensor
cores: ``csrc/flash_attention.cu::flash_fwd_f32_kernel``,
``csrc/flash_attention_bwd.cu::flash_bwd_dq_f32_kernel`` and
``flash_bwd_dkv_f32_kernel``) as the library builds them against variants
of their launch bounds and sums, on the card.

    python3 scripts/flash_f32_variants.py [--out FILE]

Builds each variant's copy of the two sources (and ``flash_tc.cuh``) with
nvcc into its own shared library under ``build/flash_f32_variants/`` (all
at once), binds ``flash_attention_fwd`` and ``flash_attention_bwd`` with
ctypes and times the forward with lse and the backward's two kernels (lse
and delta given; no group sum) with CUDA events, the median of 5 batches
of 20 launches (50 below S = 1024), in the turns of ``TURNS`` (as built,
each variant, each variant again in reverse order, as built), at the fp32
shapes of ``scripts/kernel_ab.py``'s ``FLASH_SHAPES`` (causal) and at D =
160 and 256; each output against the plain version, max|Δ| / max(1,
max|plain|).  Variants:

* ``built``: the sources as they are;
* ``no_count``: ``__launch_bounds__`` without a count of blocks an SM
  (the three kernels ask for one, the forward two at D ≤ 64);
* ``dkv_chunk16``: the dk/dv kernel's sums in chunks of 16 query rows,
  not 32 (half the split A fragments live, twice the fp32 adds).

Needs one Hopper card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

FILES = ("flash_attention.cu", "flash_attention_bwd.cu", "flash_tc.cuh")
VARIANTS = {
    "built": [],
    "no_count": [
        ("flash_attention.cu",
         "__launch_bounds__(32 * fwd_warps<D>(), D <= 64 ? 2 : 1)",
         "__launch_bounds__(32 * fwd_warps<D>())"),
        ("flash_attention_bwd.cu", "__launch_bounds__(32 * dq_warps<D>(), 1)",
         "__launch_bounds__(32 * dq_warps<D>())"),
        ("flash_attention_bwd.cu", "__launch_bounds__(32 * dkv_warps<D>(), 1)",
         "__launch_bounds__(32 * dkv_warps<D>())")],
    "dkv_chunk16": [
        ("flash_attention_bwd.cu",
         "constexpr int KC = NQ < 4 ? NQ : 4;  // 8-row steps a chunk of the "
         "sums", "constexpr int KC = 2;")],
}
# (B, Hq, Hkv, S, D), causal fp32
SHAPES = ([(2, 8, 2, 333, d) for d in (16, 32, 64, 112, 128, 160)]
          + [(8, 32, 8, 1024, 64), (4, 32, 4, 1024, 128),
             (4, 32, 8, 1024, 160), (2, 8, 2, 1024, 256)])
TURNS = ("built", "no_count", "dkv_chunk16", "dkv_chunk16", "no_count",
         "built")


def build(cudalib, name: str) -> tuple:
    """nvcc of the variant's copy into build/flash_f32_variants/<name>/;
    returns (name, the library or None, the ptxas lines of the fp32
    kernels, or the compiler's error)."""
    src = {f: (cudalib._CSRC / f).read_text() for f in FILES}
    for f, old, new in VARIANTS[name]:
        if old not in src[f]:
            raise SystemExit(f"variant {name}: {old!r} not in {f}")
        src[f] = src[f].replace(old, new)
    d = os.path.join(ROOT, "build", "flash_f32_variants", name)
    os.makedirs(d, exist_ok=True)
    for f, text in src.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    so = os.path.join(d, "lib.so")
    r = subprocess.run([cudalib._nvcc(), *cudalib.NVCC_FLAGS, "-shared",
                        "-o", so, os.path.join(d, FILES[0]),
                        os.path.join(d, FILES[1])],
                       capture_output=True, text=True)
    if r.returncode:
        return name, None, r.stderr[-4000:]
    log, fn = [], None
    for line in r.stderr.splitlines():
        if "Compiling entry function" in line and "_f32_kernel" in line:
            fn = line.split("_f32_kernel")[0].split("flash_")[-1] + \
                "_f32<" + line.split("ILi")[1].split("E")[0] + ">"
        elif fn and ("registers" in line or "spill stores" in line):
            log.append(f"{fn}: {line.strip()}")
            if "registers" in line:
                fn = None
    return name, so, "\n".join(log)


def bind(so: str):
    lib = ctypes.CDLL(so)
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [ptr] * 5 + [i] * 7 + [
        ctypes.c_float, i, i, ptr]
    lib.flash_attention_bwd.argtypes = [ptr] * 9 + [i] * 7 + [
        ctypes.c_float, i, i, ptr]
    return lib


def event_ms(torch, call, n: int) -> float:
    """The median over 5 batches of n launches, per launch."""
    for _ in range(3):
        call()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        e0.record()
        for _ in range(n):
            call()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return sorted(times)[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cudalib
    from repro_torch.kernels.flash_attention import kernel as fk
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = list(ex.map(lambda n: build(cudalib, n), VARIANTS))
    libs = {}
    for name, so, log in built:
        print(f"[variants] {name}: {'built' if so else 'FAILED'}\n{log}")
        if so is None:
            return 1
        libs[name] = bind(so)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for B, Hq, Hkv, S, D in SHAPES:
        q, do = (torch.randn(B, Hq, S, D, generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn(B, Hkv, S, D, generator=gen, device="cuda")
                for _ in range(2))
        p_o, p_lse = fk.flash_attention_fwd_lse_plain(q, k, v, causal=True)
        plain = (p_o, p_lse, *fk.flash_attention_bwd_plain(
            q, k, v, p_o, p_lse, do, causal=True))
        delta = fk.bwd_delta(p_o, do)
        scale = 1.0 / D ** 0.5
        res = {name: {"fwd": [], "bwd": [], "err": 0.0} for name in VARIANTS}
        for name in TURNS:
            lib = libs[name]
            o, dq = torch.empty_like(q), torch.empty_like(q)
            lse = torch.empty(B, Hq, S, device="cuda")
            dkv = torch.empty(2, B, Hq, S, D, device="cuda")

            def fwd():
                return lib.flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), 0, B, Hq, Hkv, S, S, D, scale, 1, 0,
                    stream)

            def bwd():
                return lib.flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    p_lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                    dkv[0].data_ptr(), dkv[1].data_ptr(), 0, B, Hq, Hkv, S,
                    S, D, scale, 1, 0, stream)
            if fwd() or bwd():
                raise SystemExit(f"{name}: a launch failed")
            torch.cuda.synchronize()
            got = (o, lse, dq, *(fk.group_sum(t, Hkv, torch.float32)
                                 for t in dkv))
            res[name]["err"] = max(res[name]["err"], max(
                float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                for a, b in zip(got, plain)))
            n = 20 if S >= 1024 else 50
            res[name]["fwd"].append(event_ms(torch, fwd, n))
            res[name]["bwd"].append(event_ms(torch, bwd, n))
        card = torch.cuda.get_device_name(0)
        for name, r in res.items():
            rows.append({"shape": [B, Hq, Hkv, S, D], "variant": name,
                         "fwd_ms": r["fwd"], "bwd_ms": r["bwd"],
                         "rel_err": r["err"], "card": card})
        print(f"[variants] {(B, Hq, Hkv, S, D)} causal fp32: " + "; ".join(
            f"{name} fwd {', '.join(f'{t:.4f}' for t in r['fwd'])} bwd "
            f"{', '.join(f'{t:.4f}' for t in r['bwd'])} ms, max|Δ|/max "
            f"{r['err']:.2e}" for name, r in res.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
