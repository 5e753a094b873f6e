#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's CapsNet serving path on one H100.

    python3 chip_smoke.py [--out results.json]

Phases, each printing its own lines:

1. device — the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, capability; TF32 is switched off for convolutions and
   products so both backends compute in fp32.
2. build — compiles the routing kernels from ``src/repro_torch/csrc`` with
   nvcc (``repro_torch.kernels.routing.kernel.build``).
3. kernels — every routing kernel against its plain PyTorch version on the
   card, on the votes the serving path hands it (the CapsNet encoder at
   random weights on synthetic images) for Caps-MN1, Caps-EN3, Caps-CF3 and
   Caps-MN1 at the CLI's default microbatch of 8: the procedure kernel at
   fp32 (exact and approx), bf16, int8 and early exit at ε = 0, 8 and 1e6;
   the iteration kernel at fp32 and bf16.  Tolerance: max|Δ| ≤ 1e-5 on v
   (and on s and b_new scaled by max(1, max|plain|)); early-exit work
   counters equal, ε = 0 giving iterations · n_tiles.  Times are medians of
   20 CUDA-event-timed calls after 3 warm-up calls.
4. serve — Caps-MN1 at full width through ``CapsServer`` with
   ``RouterSpec(backend="cuda")`` and ``ServeConfig(microbatch=100,
   n_micro=2)``: the wave scores against a ``backend="torch"`` server on
   the same packed waves (max|Δ| ≤ 1e-5, predictions equal wherever the
   top-two margin exceeds 1e-4), one wave's time split into its stages,
   then 600 requests in ragged arrivals in sync and in async mode (the
   main path, whose kernel launches are counted), then 150 in sync mode
   with ``fusion="iteration"`` (the fallback path, counted on its own).

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises and exits
non-zero before it; without a CUDA device the script exits non-zero at
once.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12            # fp32 outside the tensor cores
TOL = 1e-5
MARGIN = 1e-4
EPS_LADDER = (0.0, 8.0, 1e6)
LOAD = 0.3                 # mean arrivals per tick, as a share of a wave
KERNEL_SOURCE = "src/repro_torch/csrc/routing.cu"
REPLACES = {
    "routing_procedure_fused": "src/repro/kernels/routing/kernel.py:303",
    "routing_iteration_fused": "src/repro/kernels/routing/kernel.py:139",
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def timed_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` CUDA-event-timed calls
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: int, flops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"[device] {card}")
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, capability {cap[0]}.{cap[1]}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    check(cap[0] == 9, f"capability {cap} is not Hopper (9.x)")
    return {"card": card, "capability": cap}


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build(kernel) -> dict:
    kernel.build()
    info = kernel.build_info
    print(f"[build] {info.path}: {'compiled' if info.compiled else 'cached'}"
          f" in {info.seconds:.2f} s")
    regs = [line.strip() for line in info.log.splitlines()
            if "registers" in line or "spill" in line]
    for line in sorted(set(regs)):
        print(f"[build] ptxas: {line}")
    return {"seconds": info.seconds, "compiled": info.compiled}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def votes_for(cfg, batch: int, seed: int = 0) -> torch.Tensor:
    """The votes the serving path hands the router: the CapsNet encoder at
    random weights on synthetic images, for ``batch`` lanes."""
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.models import capsnet
    net = capsnet.CapsNet(cfg, device="cuda", seed=seed)
    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    images = torch.from_numpy(ds.batch(seed, batch)["images"]).cuda()
    with torch.inference_mode():
        u_hat = capsnet.encode_votes(net, images)
    return u_hat.clone().contiguous()


def check_procedure(kernel, ops, name, u, iters, results) -> None:
    B, L, H, C = u.shape
    variants = [("fp32", False, None), ("fp32-approx", True, None),
                ("bf16", False, None), ("int8", False, None)]
    variants += [(f"early-exit eps={e:g}", False, e) for e in EPS_LADDER]
    for label, use_approx, eps in variants:
        sd = "int8" if label == "int8" else \
            "bf16" if label == "bf16" else "fp32"
        l_tile = ops.procedure_l_tile(B, L, H, C, sd,
                                      early_exit=eps is not None)
        n = L // l_tile
        if sd == "int8":
            args = ops.quantize_u_stream(u, l_tile)
        else:
            args = (u.to(ops.STREAM_DTYPES[sd]).contiguous(), None)
        kw = dict(iterations=iters, l_tile=l_tile, use_approx=use_approx,
                  early_exit_eps=eps)
        before = kernel.routing_procedure_fused.launches
        out_k = kernel.routing_procedure_fused(*args, **kw)
        out_p = kernel.routing_procedure_fused_plain(*args, **kw)
        torch.cuda.synchronize()
        check(kernel.routing_procedure_fused.launches == before + 1,
              "launch counter did not move")
        eff = iters * n
        if eps is not None:
            (vk, ck), (vp, cp) = out_k, out_p
            ck, cp = int(ck), int(cp)
            check(ck == cp, f"{name} {label}: work counter kernel {ck} != "
                            f"plain {cp}")
            if eps == 0.0:
                check(ck == iters * n, f"{name} eps=0: counter {ck} != "
                                       f"{iters}·{n}")
            eff = ck
        else:
            vk, vp = out_k, out_p
        err = float((vk - vp).abs().max())
        check(bool(torch.isfinite(vk).all()), f"{name} {label}: non-finite")
        check(err <= TOL, f"{name} {label}: max|Δ| {err:.3g} > {TOL}")
        ms = timed_ms(lambda: kernel.routing_procedure_fused(*args, **kw))
        plain_ms = timed_ms(
            lambda: kernel.routing_procedure_fused_plain(*args, **kw))
        item = torch.empty((), dtype=ops.STREAM_DTYPES[sd]).element_size()
        elems = B * L * H * C
        bytes_once = elems * item + B * H * C * 4 + (n * 4 if sd == "int8"
                                                     else 0)
        # Eq.2 (2 FLOP/element) runs every iteration; Eq.4 (2 more) only in
        # the tile-iterations that did work
        flops = 2 * elems * iters + 2 * elems * iters * eff / (iters * n)
        b_ms, b_by = bound(bytes_once, flops)
        stream = ops.dma_bytes_per_call(
            B, L, H, C, iters, form="procedure", stream_dtype=sd,
            early_exit_work_fraction=(eff / (iters * n)
                                      if eps is not None else None))
        stream_ms = stream["total_bytes"] / HBM_BYTES_PER_S * 1e3
        row = {"kernel": "routing_procedure_fused", "shape": name,
               "B": B, "L": L, "H": H, "C": C, "l_tile": l_tile,
               "n_tiles": n, "variant": label, "max_abs_err": err,
               "tol": TOL, "work": eff, "fixed_grid_work": iters * n,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "stream_bound_ms": stream_ms}
        results.append(row)
        print(f"[kernels] {name:<22} procedure {label:<20} l_tile={l_tile:<4}"
              f" max|Δ|={err:.2e} (tol {TOL:g}) work={eff}/{iters * n} "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})  stream bound "
              f"{stream_ms:.4f} ms")


def check_iteration(kernel, ops, name, u, results) -> None:
    from repro_torch.kernels.routing import ref
    B, L, H, C = u.shape
    for sd in ("fp32", "bf16"):
        us = u.to(ops.STREAM_DTYPES[sd]).contiguous()
        l_tile = ops.auto_l_tile(B, L, H, C, sd)
        # the state entering iteration 1: b and v after iteration 0
        b0 = torch.zeros((L, H), device="cuda")
        v0 = torch.zeros((B, H, C), device="cuda")
        s1, b1 = kernel.routing_iteration_fused_plain(us, b0, v0,
                                                      l_tile=l_tile)
        v1 = ref.squash(s1).contiguous()
        before = kernel.routing_iteration_fused.launches
        sk, bk = kernel.routing_iteration_fused(us, b1, v1, l_tile=l_tile)
        sp, bp = kernel.routing_iteration_fused_plain(us, b1, v1,
                                                      l_tile=l_tile)
        torch.cuda.synchronize()
        check(kernel.routing_iteration_fused.launches == before + 1,
              "launch counter did not move")
        err_s = float((sk - sp).abs().max()) / max(1.0,
                                                   float(sp.abs().max()))
        err_b = float((bk - bp).abs().max()) / max(1.0,
                                                   float(bp.abs().max()))
        err = max(err_s, err_b)
        check(err <= TOL, f"{name} iteration {sd}: scaled max|Δ| "
                          f"{err:.3g} > {TOL}")
        ms = timed_ms(lambda: kernel.routing_iteration_fused(
            us, b1, v1, l_tile=l_tile))
        plain_ms = timed_ms(lambda: kernel.routing_iteration_fused_plain(
            us, b1, v1, l_tile=l_tile))
        elems = B * L * H * C
        bytes_once = (elems * us.element_size() + 2 * L * H * 4
                      + 2 * B * H * C * 4)
        b_ms, b_by = bound(bytes_once, 4 * elems)
        stream = ops.dma_bytes_per_call(B, L, H, C, 1, form="iteration",
                                        stream_dtype=sd)
        stream_ms = stream["total_bytes"] / HBM_BYTES_PER_S * 1e3
        results.append({"kernel": "routing_iteration_fused", "shape": name,
                        "B": B, "L": L, "H": H, "C": C, "l_tile": l_tile,
                        "n_tiles": L // l_tile, "variant": sd,
                        "max_abs_err": err, "tol": TOL, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "stream_bound_ms": stream_ms})
        print(f"[kernels] {name:<22} iteration {sd:<20} l_tile={l_tile:<4}"
              f" scaled max|Δ|={err:.2e} (tol {TOL:g}) kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})  "
              f"stream bound {stream_ms:.4f} ms")


def phase_kernels(kernel, ops, CAPS) -> list:
    shapes = [("Caps-MN1", CAPS["Caps-MN1"], 100),
              ("Caps-EN3", CAPS["Caps-EN3"], 100),
              ("Caps-CF3", CAPS["Caps-CF3"], 100),
              ("Caps-MN1 microbatch 8", CAPS["Caps-MN1"], 8)]
    results = []
    before = kernel.launch_counts()
    for name, cfg, batch in shapes:
        u = votes_for(cfg, batch)
        print(f"[kernels] {name}: votes {tuple(u.shape)}, "
              f"max|û| {float(u.abs().max()):.3f}")
        check_procedure(kernel, ops, name, u, cfg.routing_iters, results)
        check_iteration(kernel, ops, name, u, results)
        del u
        torch.cuda.empty_cache()
    after = kernel.launch_counts()
    print("[kernels] launch counter deltas: " + ", ".join(
        f"{k} +{after[k] - before[k]}" for k in after))
    print("[kernels] library_ms: none — no single PyTorch call computes "
          "dynamic routing")
    return results


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def top2_margin(scores):
    top2 = scores.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def phase_agreement(net, cfg, spec_cuda, ds, caps_serve) -> dict:
    """Both adapters' wave functions on the same packed waves."""
    from repro_torch.core.router import RouterSpec
    cuda_ad = caps_serve.CapsAdapter(net, spec_cuda)
    torch_ad = caps_serve.CapsAdapter(
        net, RouterSpec(backend="torch", iterations=net.cfg.routing_iters))
    wave_c = cuda_ad.make_wave_fn(cfg)
    wave_t = torch_ad.make_wave_fn(cfg)
    worst, near, lanes = 0.0, 0, 0
    for index, count in ((0, cfg.wave_lanes), (1, 137)):
        images = ds.batch(10_000 + index, count)["images"]
        packed = cuda_ad.pack(list(images), cfg)
        sc = wave_c(packed).reshape(-1, net.cfg.num_h_caps)[:count]
        st = wave_t(packed).reshape(-1, net.cfg.num_h_caps)[:count]
        torch.cuda.synchronize()
        worst = max(worst, float((sc - st).abs().max()))
        margin = top2_margin(st)
        clear = margin > MARGIN
        near += int((~clear).sum())
        lanes += count
        same = sc.argmax(-1) == st.argmax(-1)
        check(bool(same[clear].all()),
              "cuda and torch servers disagree on a prediction outside "
              "the near-tie margin")
    print(f"[serve] agreement cuda vs torch backend: max|Δ score| "
          f"{worst:.2e} (tol {TOL:g}); predictions equal on all "
          f"{lanes - near}/{lanes} lanes with top-2 margin > {MARGIN:g} "
          f"({near} near-tie lanes)")
    check(worst <= TOL, f"wave scores differ by {worst:.3g} > {TOL}")
    return {"max_abs_score_diff": worst, "near_tie_lanes": near,
            "lanes": lanes}


def wave_breakdown(net, spec, cfg, ds, caps_serve) -> dict:
    """Where one full wave's time goes: host packing (with the copy to the
    card), the encoder and the routing stage of one microbatch (CUDA
    events), the whole wave function, and unpacking (with the copy back)."""
    from repro_torch.core.router import build_router
    from repro_torch.models import capsnet
    adapter = caps_serve.CapsAdapter(net, spec)
    wave = adapter.make_wave_fn(cfg)
    router = build_router(spec, device=net.device)
    images = list(ds.batch(20_000, cfg.wave_lanes)["images"])

    def host_ms(fn, runs=10):
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    packed = adapter.pack(images, cfg)
    micro = {k: v[0] for k, v in packed.items()}

    def encode():
        return capsnet.encode_votes(net, micro["images"]) * \
            micro["mask"][:, None, None, None]

    with torch.inference_mode():
        votes = encode()
        out = {"pack_ms": host_ms(lambda: adapter.pack(images, cfg)),
               "encode_ms": timed_ms(encode, runs=10),
               "route_ms": timed_ms(lambda: router(votes), runs=10),
               "wave_ms": timed_ms(lambda: wave(packed), runs=10)}
        result = wave(packed)
        out["unpack_ms"] = host_ms(
            lambda: adapter.unpack(result, cfg.wave_lanes))
    print(f"[serve] one wave of {cfg.n_micro} x {cfg.microbatch} lanes: "
          f"wave function {out['wave_ms']:.3f} ms = per microbatch encoder "
          f"{out['encode_ms']:.3f} ms + routing {out['route_ms']:.3f} ms "
          f"(x {cfg.n_micro}, plus stacking); host pack + copy in "
          f"{out['pack_ms']:.3f} ms, copy out + unpack "
          f"{out['unpack_ms']:.3f} ms")
    return out


def serve_once(net, spec, cfg, ds, mode, requests, caps_serve, serve_cli,
               kernel, card) -> dict:
    server = caps_serve.CapsServer(net, spec=spec, cfg=cfg)
    schedule = serve_cli.arrival_schedule(requests,
                                          max(1.0, LOAD * cfg.wave_lanes))
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    if mode == "async":
        serve_cli.run_async(server, ds, schedule, 2)
    else:
        serve_cli.run_sync(server, ds, schedule)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel.launch_counts()
    s = serve_cli.check_books(server, requests)
    check(s["submitted"] == s["completed"] == requests,
          f"{mode}: submitted {s['submitted']}, completed "
          f"{s['completed']}, requests {requests}")
    for key in ("wave_errors", "failed", "guard_trips", "shed"):
        check(s[key] == 0, f"{mode}: {key} = {s[key]} ({s['last_error']})")
    print(f"[serve] {mode:<5} fusion={spec.fusion}: {s['completed']} "
          f"requests in {s['waves']} waves ({len(schedule)} ragged ticks, "
          f"{s['padded_lanes']} padded lanes), wave_errors "
          f"{s['wave_errors']}, failed {s['failed']}, guard_trips "
          f"{s['guard_trips']}, shed {s['shed']}; throughput "
          f"{s['throughput_rps']:.1f} req/s, p50 "
          f"{s['p50_latency_s'] * 1e3:.2f} ms, p90 "
          f"{s['p90_latency_s'] * 1e3:.2f} ms, wall {wall:.2f} s on "
          f"{card}; launches {counts}")
    return {"mode": mode, "fusion": spec.fusion, "requests": requests,
            "waves": s["waves"], "throughput_rps": s["throughput_rps"],
            "p50_latency_s": s["p50_latency_s"],
            "p90_latency_s": s["p90_latency_s"], "wall_s": wall,
            "launches": counts}


def phase_serve(kernel, CAPS, card: str) -> dict:
    from repro_torch.core.router import RouterSpec
    from repro_torch.data.synthetic import SyntheticCapsDataset
    from repro_torch.launch import serve_caps as serve_cli
    from repro_torch.models.capsnet import CapsNet
    from repro_torch.runtime import caps_serve
    caps_cfg = CAPS["Caps-MN1"]
    net = CapsNet(caps_cfg, device="cuda", seed=0)
    print(f"[serve] {caps_cfg.name} at full width: conv "
          f"{caps_cfg.conv_channels} channels, L={caps_cfg.num_l_caps}, "
          f"H={caps_cfg.num_h_caps}, C_L={caps_cfg.l_caps_dim}, "
          f"C_H={caps_cfg.h_caps_dim}, {caps_cfg.routing_iters} iterations, "
          f"random weights (seed 0)")
    cfg = caps_serve.ServeConfig(microbatch=100, n_micro=2,
                                 pipeline="software")
    spec = RouterSpec(backend="cuda", iterations=caps_cfg.routing_iters)
    ds = SyntheticCapsDataset(caps_cfg.image_hw, caps_cfg.image_channels,
                              caps_cfg.num_h_caps)
    out = {"agreement": phase_agreement(net, cfg, spec, ds, caps_serve),
           "breakdown": wave_breakdown(net, spec, cfg, ds, caps_serve)}
    runs = [serve_once(net, spec, cfg, ds, mode, 600, caps_serve,
                       serve_cli, kernel, card) for mode in ("sync", "async")]
    main = sum(r["launches"]["routing_procedure_fused"] for r in runs)
    check(main > 0, "the main path launched routing_procedure_fused "
                    "no time")
    waves = sum(r["waves"] for r in runs)
    fallback = serve_once(net, spec._replace(fusion="iteration"), cfg, ds,
                          "sync", 150, caps_serve, serve_cli, kernel, card)
    check(fallback["launches"]["routing_iteration_fused"] > 0,
          "the fusion='iteration' path launched routing_iteration_fused "
          "no time")
    out.update(runs=runs + [fallback], main_waves=waves,
               main_launches={"routing_procedure_fused": main},
               fallback_launches=fallback["launches"])
    print(f"[serve] main path: routing_procedure_fused launched {main} times"
          f" in {waves} waves ({main / waves:.1f} per wave: one per "
          f"microbatch); fallback path: routing_iteration_fused launched "
          f"{fallback['launches']['routing_iteration_fused']} times in "
          f"{fallback['waves']} waves")
    return out


def summary(kernel_rows, serve) -> dict:
    out = []
    launches = {
        "routing_procedure_fused":
            serve["main_launches"]["routing_procedure_fused"],
        "routing_iteration_fused":
            serve["fallback_launches"]["routing_iteration_fused"],
    }
    main_variant = {"routing_procedure_fused": "fp32",
                    "routing_iteration_fused": "fp32"}
    for name in ("routing_procedure_fused", "routing_iteration_fused"):
        rows = [r for r in kernel_rows if r["kernel"] == name]
        main = next(r for r in rows if r["shape"] == "Caps-MN1"
                    and r["variant"] == main_variant[name])
        out.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": REPLACES[name],
                    "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"], "library_ms": None})
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "src"))
    from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS
    from repro_torch.kernels.routing import kernel, ops

    t0 = time.perf_counter()
    device = phase_device()
    build = phase_build(kernel)
    kernel_rows = phase_kernels(kernel, ops, CAPS_BENCHMARKS)
    serve = phase_serve(kernel, CAPS_BENCHMARKS, device["card"])
    result = summary(kernel_rows, serve)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device, "build": build,
                       "kernels": kernel_rows, "serve": serve,
                       "summary": result,
                       "seconds": time.perf_counter() - t0}, f, indent=1)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
