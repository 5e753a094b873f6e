#!/usr/bin/env python3
"""Time the EM E-step, the routing backward, the routing stage-update and
the flash-attention kernels of one tree of this repository, so that two
commits compare side by side in one run on one card.

    python3 scripts/kernel_ab.py --tree DIR [--kernels estep bwd stage flash]
                                 [--out FILE]

Imports ``repro_torch`` from ``DIR/src`` (its kernels build into
``DIR/build/kernels``), makes the inputs of ``chip_smoke.py``'s phases 5–7
— the CapsNet encoder's votes at random weights on synthetic images, a
seeded ∂v, μ, 1/σ² and the bias of one real M-step with the serving mask
as a_in, and the stage operands of ``chip_smoke.stage_inputs`` — and times
``em_stage_estep`` at the four phase-6 shapes (Caps-MN1, Caps-EN3,
Caps-CF3 at B=100, Caps-MN1 at B=8), ``routing_procedure_bwd`` at the five
phase-5 shapes (those and Caps-SV3) in fp32 and bf16 at the training tile,
and ``routing_stage_update`` and ``routing_stage_update_fold`` (exact) at
the four phase-7 shapes in fp32 and bf16, and the three flash-attention
kernels (``flash_attention``, ``flash_attention_fwd_lse``,
``flash_attention_bwd``, causal) in bf16 at granite-3-2b's, qwen3-moe's,
zamba2-7b's and stablelm-12b's shapes and in fp32 at a small shape for
every head dim, and bidirectional in bf16 at S = 1024 with
seamless-m4t-large-v2's 16 heads of 64 and at its cross-attention shape
(1024 text rows over 4096 encoder frames; skipped on a tree whose kernels
take one length), in fp32 at granite-3-2b's and qwen3-moe's shapes, and
at head dims above 256 (the wide route) at the shapes of
``chip_smoke.py``'s ``WIDE_CHECKS`` in bf16 and fp32: the median of 20
CUDA-event-timed calls (``timed_ms``) and the device time (``device_ms``,
the backward's split into replay, reverse sweep and ∂û; the stage and
flash rows against their bound: bf16 at the tensor cores' bf16 rate, fp32
up to D = 256 at split TF32's, 495/3 TFLOP/s, above at the CUDA cores'
67), both from ``chip_smoke.py``.  Each flash
row also prints a digest (sha256) of the bytes of its outputs on seeded
inputs: two trees whose kernels compute the same bits print the same
digest.  Each fp32 flash row also times the library's call for the same
function (``chip_smoke.wide_library``: SDPA on expanded KV heads, the
memory-efficient op with lse for the training forward where it takes the
head dim, SDPA's autograd backward).  A head dim the tree's kernels do not take (one they neither
instantiate nor run on the wide route) is skipped.
``--kernels`` picks the families (all four by default).  Each output's
max|Δ| against its plain version is printed; ``chip_smoke.py`` holds the
gates.  To compare, run the trees in turns (parent, change, change,
parent).  Needs one Hopper card and nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("estep", "bwd", "stage", "flash")
# (B, Hq, Hkv, S, D, dtype, causal[, window]): the bf16 prefill and
# training shapes of granite-3-2b, qwen3-moe-30b-a3b, zamba2-7b and
# stablelm-12b, then fp32 at a small shape for each head dim, causal, and
# at granite-3-2b's and qwen3-moe's shapes; two bidirectional bf16 shapes
# of seamless-m4t-large-v2's heads, the second its cross attention (S as
# (Sq, Sk)); then the wide route (D > 256) at the shapes of
# chip_smoke.WIDE_CHECKS (the d_head 320 model's first), bf16 and fp32
WIDE_SHAPES = ((4, 32, 8, 1024, 320, True), (4, 16, 4, 1024, 288, True),
               (4, 16, 4, 1024, 512, True),
               (4, 16, 16, (256, 1024), 320, False),
               (1, 8, 2, 2048, 384, True, 256),
               (2, 4, 2, (37, 200), 288, False), (1, 4, 2, 1023, 288, True),
               (2, 4, 2, (37, 200), 300, False), (1, 4, 2, 1023, 257, True),
               (2, 8, 2, 1024, 640, True),
               (2, 8, 8, (256, 1024), 1024, False))
FLASH_SHAPES = ((8, 32, 8, 1024, 64, "bf16", True),
                (4, 32, 4, 1024, 128, "bf16", True),
                (4, 32, 32, 1024, 112, "bf16", True),
                (4, 32, 8, 1024, 160, "bf16", True),
                *((2, 8, 2, 333, d, "fp32", True) for d in (16, 32, 64, 112,
                                                            128, 160)),
                (8, 32, 8, 1024, 64, "fp32", True),
                (4, 32, 4, 1024, 128, "fp32", True),
                (4, 16, 16, 1024, 64, "bf16", False),
                (4, 16, 16, (1024, 4096), 64, "bf16", False),
                *((B, Hq, Hkv, S, D, dt, causal, *w)
                  for dt in ("bf16", "fp32")
                  for B, Hq, Hkv, S, D, causal, *w in WIDE_SHAPES))
# the phase-6 and phase-7 shapes: (name, configuration, batch)
SHAPES = (("Caps-MN1", "Caps-MN1", 100), ("Caps-EN3", "Caps-EN3", 100),
          ("Caps-CF3", "Caps-CF3", 100),
          ("Caps-MN1 microbatch 8", "Caps-MN1", 8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--kernels", nargs="+", choices=FAMILIES,
                    default=list(FAMILIES), help="the kernel families timed")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(1, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS as CAPS
    from repro_torch.kernels.routing import kernel, ops
    assert kernel.__file__.startswith(tree), kernel.__file__
    rows = []

    def record(row):
        rows.append(row)
        dev = row["device_ms"]
        bound = (f", bound {row['bound_ms']:.4f} ms" if "bound_ms" in row
                 else "")
        print(f"[ab] {args.tree} {row['kernel']:<25} {row['shape']:<22} "
              f"{row['variant']:<5} kernel {row['ms']:.4f} ms, device "
              f"{'not measured' if dev is None else f'{dev:.4f} ms'}{bound}"
              f"{row.get('split_note', '')}; max|Δ| against the plain "
              f"version {row['max_abs_err']:.2e}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        for name, cfg_name, batch in SHAPES:
            if "estep" not in args.kernels:
                break
            u = cs.votes_for(CAPS[cfg_name], batch)
            B, L, H, C = u.shape
            lt = dict(l_tile=ops.auto_l_tile(B, L, H, C, "fp32"))
            gen = torch.Generator(device="cuda").manual_seed(B * L + H)
            r = torch.softmax(torch.randn((B, L, H), generator=gen,
                                          device="cuda"), dim=-1)
            a_in = torch.ones((B,), device="cuda")[:, None].expand(B, L)
            stats = kernel.em_stage_stats_plain(u, r, a_in, **lt)
            mu, isig, bias, _ = ops.em_m_step(*stats, lam=0.05)

            def estep():
                return kernel.em_stage_estep(u, mu, isig, bias, **lt)
            err = cs.scaled_err(estep(), kernel.em_stage_estep_plain(
                u, mu, isig, bias, **lt))
            record({"kernel": "em_stage_estep", "shape": name,
                    "variant": "fp32", "ms": cs.timed_ms(estep),
                    "device_ms": cs.device_ms(estep)["ms"],
                    "max_abs_err": err})
            del u, r, stats
            torch.cuda.empty_cache()

    for name, cfg_name, batch in (("Caps-MN1", "Caps-MN1", 100),
                                  ("Caps-EN3", "Caps-EN3", 100),
                                  ("Caps-CF3", "Caps-CF3", 100),
                                  ("Caps-SV3", "Caps-SV3", 100),
                                  ("Caps-MN1 microbatch 8", "Caps-MN1",
                                   8)):
        if "bwd" not in args.kernels:
            break
        cfg = CAPS[cfg_name]
        u = cs.votes_for(cfg, batch)
        B, L, H, C = u.shape
        iters = cfg.routing_iters
        gen = torch.Generator(device="cuda").manual_seed(B * L + H)
        g = torch.randn((B, H, C), generator=gen, device="cuda")
        for sd in ("fp32", "bf16"):
            us = u.to(ops.STREAM_DTYPES[sd]).contiguous()
            kw = dict(iterations=iters, l_tile=ops.procedure_train_l_tile(
                B, L, H, C, iters, sd))

            def bwd():
                return kernel.routing_procedure_bwd(us, g, **kw)
            err = float((bwd().float() - kernel.routing_procedure_bwd_plain(
                us, g, **kw).float()).abs().max())
            dev = cs.device_ms(bwd, parts=cs.BWD_PARTS)
            note = ("" if dev["ms"] is None else
                    f" = replay {dev['replay']:.4f} + reverse "
                    f"{dev['reverse']:.4f} + ∂û {dev['du']:.4f} + other "
                    f"{dev['other']:.4f}")
            record({"kernel": "routing_procedure_bwd", "shape": name,
                    "variant": sd, "ms": cs.timed_ms(bwd),
                    "device_ms": dev["ms"],
                    "device_split": {k: dev.get(k) for k in
                                     (*cs.BWD_PARTS, "other")},
                    "split_note": note, "max_abs_err": err})
            del us
        del u
        torch.cuda.empty_cache()
    if "flash" in args.kernels:
        flash_rows(cs, record)
    with torch.no_grad():
        for name, cfg_name, batch in SHAPES:
            if "stage" not in args.kernels:
                break
            u = cs.votes_for(CAPS[cfg_name], batch)
            for sd in ("fp32", "bf16"):
                stage_rows(cs, kernel, ops, name, u, sd, record)
            del u
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"tree": args.tree, "rows": rows}, f, indent=1)
    return 0


def flash_rows(cs, record) -> None:
    """The three flash-attention kernels at ``FLASH_SHAPES``, each with its
    bound (``chip_smoke.py``'s formula) and the digest of its outputs."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    for B, Hq, Hkv, S, D, dt, causal, *window in FLASH_SHAPES:
        window = window[0] if window else None
        S, Sk = S if isinstance(S, tuple) else (S, S)
        shape = (f"{B},{Hq},{Hkv},{S}" + (f"x{Sk}" if Sk != S else "")
                 + f",{D}" + ("" if causal else ",bidir")
                 + (f",w{window}" if window else ""))
        if D not in fk.HEAD_DIMS and D <= getattr(fk, "WIDE_ABOVE", D):
            print(f"[ab] flash {shape}: D = {D} not taken, skipped")
            continue
        dtype = cs.LM_DTYPES[dt]
        gen = torch.Generator(device="cuda").manual_seed(B * S + D)
        q, do = (torch.randn(B, Hq, S, D, generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        c = {"causal": causal, **({"window": window} if window else {})}
        if Sk != S:
            try:      # CPU tensors: the plain version, no launch
                fk.flash_attention(torch.zeros(1, 1, 2, D),
                                   *(torch.zeros(1, 1, 3, D)
                                     for _ in range(2)), causal=False)
            except ValueError:
                print(f"[ab] flash {shape}: the tree's kernels take one "
                      f"length, skipped")
                continue
        with torch.no_grad():
            o, lse = fk.flash_attention_fwd_lse(q, k, v, **c)
            outs = {"flash_attention": (fk.flash_attention(q, k, v, **c),),
                    "flash_attention_fwd_lse": (o, lse),
                    "flash_attention_bwd": fk.flash_attention_bwd(
                        q, k, v, o, lse, do, **c)}
            plain = {"flash_attention": (
                         fk.flash_attention_plain(q, k, v, **c),),
                     "flash_attention_fwd_lse":
                         fk.flash_attention_fwd_lse_plain(q, k, v, **c),
                     "flash_attention_bwd": fk.flash_attention_bwd_plain(
                         q, k, v, o, lse, do, **c)}
        calls = {"flash_attention": lambda: fk.flash_attention(q, k, v, **c),
                 "flash_attention_fwd_lse":
                     lambda: fk.flash_attention_fwd_lse(q, k, v, **c),
                 "flash_attention_bwd":
                     lambda: fk.flash_attention_bwd(q, k, v, o, lse, do, **c)}
        rate = cs.attention_rate(dtype, D)
        lib = (cs.wide_library(q, k, v, causal, window, do) if dt == "fp32"
               else {})
        bounds = {name: cs.bound(*reversed(fk.attention_cost(
                      kind, q, k, causal, window)), rate)
                  for name, kind in (("flash_attention", "fwd"),
                                     ("flash_attention_fwd_lse", "fwd_lse"),
                                     ("flash_attention_bwd", "bwd"))}
        for name, fn in calls.items():
            digest = hashlib.sha256(b"".join(
                t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                for t in outs[name])).hexdigest()[:16]
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(outs[name], plain[name]))
            b_ms = bounds[name][0]
            dev = cs.device_ms(fn, bound_ms=b_ms)
            kind = {"flash_attention": "fwd",
                    "flash_attention_fwd_lse": "fwd_lse",
                    "flash_attention_bwd": "bwd"}[name]
            lib_ms = (cs.timed_ms(lib[kind]) if lib.get(kind) else None)
            lib_note = ("" if dt != "fp32" else ", library " + (
                "none" if lib_ms is None else f"{lib_ms:.4f} ms"))
            record({"kernel": name, "shape": shape, "variant": dt,
                    "ms": cs.timed_ms(fn), "device_ms": dev["ms"],
                    "bound_ms": b_ms, "digest": digest, "library_ms": lib_ms,
                    "library_backend": lib.get("backend"),
                    "split_note": f", digest {digest}{lib_note}",
                    "max_abs_err": err})
        del q, k, v, do, o, lse, outs, plain, lib
        torch.cuda.empty_cache()


def stage_rows(cs, kernel, ops, name, u, sd, record) -> None:
    """``routing_stage_update`` and ``routing_stage_update_fold`` (exact)
    on the phase-7 operands at one stream dtype, with phase 7's bound."""
    us, lt, _, s, b = cs.stage_inputs(kernel, ops, u, sd)
    B, L, H, C = us.shape
    lh, bhc = L * H * 4, B * H * C * 4
    u_bytes = us.numel() * us.element_size()
    for kname, run_k, run_p, bytes_once in (
            ("routing_stage_update",
             lambda: kernel.routing_stage_update(us, s, l_tile=lt),
             lambda: kernel.routing_stage_update_plain(us, s, l_tile=lt),
             u_bytes + 2 * bhc + lh),
            ("routing_stage_update_fold",
             lambda: kernel.routing_stage_update_fold(us, s, b, l_tile=lt),
             lambda: kernel.routing_stage_update_fold_plain(us, s, b,
                                                            l_tile=lt),
             u_bytes + 2 * bhc + 3 * lh)):
        err = max(cs.scaled_err(x, y) for x, y in zip(run_k(), run_p()))
        b_ms = cs.bound(bytes_once, 2 * us.numel())[0]
        dev = cs.device_ms(run_k, bound_ms=b_ms)
        record({"kernel": kname, "shape": name, "variant": sd,
                "ms": cs.timed_ms(run_k), "device_ms": dev["ms"],
                "event_ms": dev["event_ms"], "bound_ms": b_ms,
                "max_abs_err": err})


if __name__ == "__main__":
    sys.exit(main())
