"""Wave-serving launcher — continuous batching over the §4 pipeline.

Port of the JAX package's ``repro/launch/serve_caps.py`` for a single
server: synthetic requests arrive in ragged bursts, the server pads them
into fixed microbatch lanes and every wave streams through the encoder ‖
routing pipeline.  ``--backend cuda`` (the default) routes through the
hand-written Hopper kernels; ``--backend torch`` runs the eager reference.
``--algorithm em`` serves EM routing (the M-step statistics and E-step
kernels on the cuda backend) and scores classes by the EM activations.
``--async`` runs the threaded driver: submitter threads feed the queue
while ``serve_forever`` forms waves on its own thread.

``--plan auto`` distributes the routing stage over the default mesh
(every rank on one "vault" axis — one rank when the CLI runs alone) along
the dimension the §5.1.2 planner picks, through the stage-split kernels.

``--model lm`` serves greedy LM generation waves (granite-3-2b's smoke
config, prompt 8 → +4 tokens) through ``runtime.serve_loop.LMDecodeAdapter``
and the same wave core, single server, tick loop.

The reference's other modes raise ``NotImplementedError`` naming the slice
that ports them: ``--pipeline two_stage`` (the CLI launched as several
ranks; alone it exits with the reference's message, as it needs two), the
fleet (``--replicas``/``--tenants``/``--slo-ms``/``--max-replicas``) and
``--chaos`` (slice 4), and ``--model moe`` (slice 11).

    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke --async
    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke --plan auto
    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke --model lm
    PYTHONPATH=src python -m repro_torch.launch.serve_caps \\
        --network Caps-MN1 --requests 300 --microbatch 100 --n-micro 2
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import slices
from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS, smoke_caps
from repro_torch.core.router import RouterSpec
from repro_torch.data.synthetic import SyntheticCapsDataset
from repro_torch.models.capsnet import CapsNet
from repro_torch.runtime.caps_serve import CapsServer, ServeConfig
from repro_torch.runtime.wave_serve import WaveServer


def arrival_schedule(total: int, mean_per_tick: float, seed: int = 0):
    """Deterministic ragged arrival counts summing to ``total``."""
    rng = np.random.default_rng(seed)
    counts = []
    left = total
    while left > 0:
        c = min(left, int(rng.poisson(mean_per_tick)))
        counts.append(c)
        left -= c
    return counts


def _fmt_ms(v) -> str:
    return "n/a" if v is None else f"{v * 1e3:.1f} ms"


def run_sync(server: CapsServer, ds, schedule):
    """One wave per tick (the caller-cadence loop), then drain."""
    done = []
    for tick, count in enumerate(schedule):
        if count:
            batch = ds.batch(tick, count)
            server.submit(batch["images"])
        done.extend(server.step())
    done.extend(server.drain())
    return done


def run_async(server: CapsServer, ds, schedule, n_submitters: int):
    """Threaded driver: ``serve_forever`` forms waves on a background
    thread while submitter threads feed the queue concurrently."""
    stop = threading.Event()
    done = []
    driver = threading.Thread(
        target=lambda: done.extend(server.serve_forever(stop, poll_s=0.002)))
    driver.start()

    def submitter(worker: int):
        for tick, count in enumerate(schedule[worker::n_submitters]):
            if count:
                batch = ds.batch(1000 * worker + tick, count)
                server.submit(batch["images"])
            time.sleep(0.001)

    threads = [threading.Thread(target=submitter, args=(w,))
               for w in range(n_submitters)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    driver.join()
    return done


def check_books(server: WaveServer, requests: int) -> dict:
    """The reference's exit assertions (``serve_caps.py:401-405``): every
    submitted request completed, was shed or failed, nothing is pending,
    and the count matches what was sent.  Raises on a broken invariant."""
    s = server.metrics.summary()
    if s["submitted"] != s["completed"] + s["shed"] + s["failed"]:
        raise RuntimeError(f"books do not balance: {s}")
    if server.pending() != 0:
        raise RuntimeError(f"{server.pending()} requests still pending")
    if s["completed"] + s["shed"] + s["failed"] != requests:
        raise RuntimeError(f"{requests} requests sent, books show {s}")
    return s


def _refuse_later_modes(args) -> None:
    if args.model == "moe":
        raise slices.not_ported("--model moe", slices.LM_FAMILIES)
    if (args.replicas > 1 or args.tenants > 1 or args.slo_ms is not None
            or args.max_replicas is not None):
        raise slices.not_ported("the serving fleet (--replicas/--tenants/"
                                "--slo-ms/--max-replicas)", slices.FLEET)
    if args.chaos:
        raise slices.not_ported("--chaos fault injection", slices.FLEET)
    if args.pipeline == "two_stage":
        n = dist.get_world_size() if dist.is_initialized() else 1
        if n < 2:
            raise SystemExit("--pipeline two_stage needs >= 2 ranks for the "
                             "2-sized 'pipe' axis (this process group has "
                             f"{n}); use --pipeline software")
        raise slices.not_ported("--pipeline two_stage launched as several "
                                "ranks", slices.MULTI_RANK_CLI)


def run_lm_workload(args) -> dict:
    """``--model lm``: serve greedy LM generation waves through the generic
    wave core (single server, sync tick loop) and check the same books the
    CapsNet paths check."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.runtime.serve_loop import LMDecodeAdapter

    cfg = ServeConfig(microbatch=args.microbatch, n_micro=args.n_micro,
                      pipeline=None, max_queue=args.max_queue)
    rng = np.random.default_rng(1)
    arch = get_smoke_config("granite-3-2b")
    params = lm.init_params(arch, seed=0, device=args.device)
    prompt_len, max_new = 8, 4
    adapter = LMDecodeAdapter(params, arch, prompt_len=prompt_len,
                              max_new_tokens=max_new)
    server = WaveServer(adapter, cfg=cfg)
    schedule = arrival_schedule(args.requests,
                                max(1.0, args.load * cfg.wave_lanes))
    print(f"{arch.name}: greedy decode waves, prompt {prompt_len} -> "
          f"+{max_new} tokens; {args.requests} requests over "
          f"{len(schedule)} ticks, wave = {cfg.n_micro} x "
          f"{cfg.microbatch} lanes, device={adapter.device}")
    done = []
    for count in schedule:
        if count:
            server.submit(rng.integers(0, arch.vocab, (count, prompt_len),
                                       dtype=np.int32))
        done.extend(server.step())
    done.extend(server.drain())

    s = check_books(server, args.requests)
    print(f"served {s['completed']} requests in {s['waves']} waves "
          f"({s['padded_lanes']} padded lanes, {s['shed']} shed, "
          f"{s['failed']} failed)")
    thr = s["throughput_rps"]
    print(f"latency p50 {_fmt_ms(s['p50_latency_s'])}, "
          f"p90 {_fmt_ms(s['p90_latency_s'])}; "
          f"throughput {'n/a' if thr is None else f'{thr:.1f} req/s'}")
    first = min(done, key=lambda c: c.rid) if done else None
    if first is not None:
        print(f"first completion: {first.pred.tolist()}")
    return s


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="Caps-MN1",
                    choices=sorted(CAPS_BENCHMARKS))
    ap.add_argument("--model", default="caps", choices=("caps", "lm", "moe"),
                    help="workload adapter: caps = the paper's CapsNet "
                         "waves; lm = greedy LM decode waves over "
                         "LMDecodeAdapter (moe: slice 11)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny request count")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=8)
    ap.add_argument("--n-micro", type=int, default=4)
    ap.add_argument("--pipeline", default="software",
                    choices=("software", "two_stage", "none"),
                    help="§4 pipeline form (two_stage needs the CLI "
                         "launched as several ranks)")
    ap.add_argument("--plan", default="none", choices=("none", "auto"),
                    help="routing-stage distribution: §5.1.2 planner over "
                         "the default 'vault' mesh, or unsharded")
    ap.add_argument("--algorithm", default="dynamic",
                    choices=("dynamic", "em"),
                    help="routing algorithm")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="cuda = the hand-written Hopper kernels; torch = "
                         "the eager reference")
    ap.add_argument("--device", default="cuda",
                    help="where the server runs; the card by default")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="threaded driver: serve_forever + concurrent "
                         "submitter threads instead of the tick loop")
    ap.add_argument("--submitters", type=int, default=2)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded-queue depth (back-pressure)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving fleet: slice 4")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="serving fleet: slice 4")
    ap.add_argument("--tenants", type=int, default=1,
                    help="serving fleet: slice 4")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="serving fleet: slice 4")
    ap.add_argument("--load", type=float, default=0.75,
                    help="offered load as a fraction of wave capacity "
                         "per tick")
    ap.add_argument("--chaos", action="store_true",
                    help="fault injection: slice 4")
    args = ap.parse_args(argv)
    _refuse_later_modes(args)

    if args.smoke:
        caps_cfg = smoke_caps()
        args.requests = min(args.requests, 24)
        args.microbatch, args.n_micro = 4, 2
    else:
        caps_cfg = CAPS_BENCHMARKS[args.network]
    if args.model == "lm":
        return run_lm_workload(args)

    # fp32 convolutions and products, as the reference computes them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    pipeline = None if args.pipeline == "none" else args.pipeline
    cfg = ServeConfig(microbatch=args.microbatch, n_micro=args.n_micro,
                      pipeline=pipeline,
                      routing_plan="auto" if args.plan == "auto" else None,
                      max_queue=args.max_queue)
    spec = RouterSpec(algorithm=args.algorithm, backend=args.backend,
                      iterations=caps_cfg.routing_iters)
    net = CapsNet(caps_cfg, device=args.device, seed=0)
    ds = SyntheticCapsDataset(caps_cfg.image_hw, caps_cfg.image_channels,
                              caps_cfg.num_h_caps)
    schedule = arrival_schedule(args.requests,
                                max(1.0, args.load * cfg.wave_lanes))
    server = CapsServer(net, spec=spec, cfg=cfg, device=args.device)
    mode = (f"async x {args.submitters} submitters" if args.async_mode
            else "sync tick loop")
    print(f"{caps_cfg.name}: {args.requests} requests over "
          f"{len(schedule)} ticks (ragged), wave = {cfg.n_micro} x "
          f"{cfg.microbatch} lanes, pipeline={pipeline}, "
          f"plan={args.plan}, algorithm={args.algorithm}, "
          f"backend={args.backend}, "
          f"device={net.device}, {mode}")

    if args.async_mode:
        done = run_async(server, ds, schedule, max(1, args.submitters))
    else:
        done = run_sync(server, ds, schedule)

    s = check_books(server, args.requests)
    print(f"served {s['completed']} requests in {s['waves']} waves "
          f"({s['padded_lanes']} padded lanes, {s['shed']} shed, "
          f"{s['failed']} failed, {s['wave_errors']} wave errors)")
    thr = s["throughput_rps"]
    print(f"latency p50 {_fmt_ms(s['p50_latency_s'])}, "
          f"p90 {_fmt_ms(s['p90_latency_s'])}; "
          f"throughput {'n/a' if thr is None else f'{thr:.1f} req/s'}")
    preds = {c.rid: c.pred for c in done}
    print("first predictions:", [preds[r] for r in sorted(preds)[:8]])
    return s


if __name__ == "__main__":
    main()
