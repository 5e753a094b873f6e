#!/usr/bin/env python3
"""Time the EM E-step and the routing backward of one tree of this
repository, so that two commits compare side by side in one run on one
card.

    python3 scripts/kernel_ab.py --tree DIR [--out FILE]

Imports ``repro_torch`` from ``DIR/src`` (its kernels build into
``DIR/build/kernels``), makes the inputs of ``chip_smoke.py``'s phases 5
and 6 — the CapsNet encoder's votes at random weights on synthetic images,
a seeded ∂v, and μ, 1/σ² and the bias of one real M-step with the serving
mask as a_in — and times ``em_stage_estep`` at the four phase-6 shapes
(Caps-MN1, Caps-EN3, Caps-CF3 at B=100, Caps-MN1 at B=8) and
``routing_procedure_bwd`` at the five phase-5 shapes (Caps-MN1, Caps-EN3,
Caps-CF3, Caps-SV3 at B=100, Caps-MN1 at B=8) in fp32 and bf16 at the
training tile: the median of 20 CUDA-event-timed calls (``timed_ms``) and
the device time (``device_ms``, the backward's split into replay, reverse
sweep and ∂û), both from ``chip_smoke.py``.  Each output's max|Δ| against
its plain version is printed; ``chip_smoke.py`` holds the gates.  To
compare, run the trees in turns (parent, change, change, parent).  Needs
one Hopper card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="root of the checkout whose kernels are timed")
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
        print(f"[ab] {args.tree} {row['kernel']:<21} {row['shape']:<22} "
              f"{row['variant']:<5} kernel {row['ms']:.4f} ms, device "
              f"{'not measured' if dev is None else f'{dev:.4f} ms'}"
              f"{row.get('split_note', '')}; max|Δ| against the plain "
              f"version {row['max_abs_err']:.2e}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        for name, cfg_name, batch in (("Caps-MN1", "Caps-MN1", 100),
                                      ("Caps-EN3", "Caps-EN3", 100),
                                      ("Caps-CF3", "Caps-CF3", 100),
                                      ("Caps-MN1 microbatch 8", "Caps-MN1",
                                       8)):
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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"tree": args.tree, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
