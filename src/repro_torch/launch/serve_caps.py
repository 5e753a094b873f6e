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

``--replicas N`` / ``--tenants T`` / ``--slo-ms`` switch to the fleet
front-end (``runtime.caps_fleet``): T tenant threads submit concurrently to
a CapsFleet of N replica servers sharing one device, with deadline-ordered
waves, per-tenant accounting, and — when ``--max-replicas`` exceeds N —
the elastic controller scaling the fleet between the two bounds.

``--chaos`` arms deterministic fault injection (``runtime.faults``): a
seeded ``FaultPlan`` (``--chaos-seed``) of wave exceptions and NaN
corruption — plus a replica crash in fleet mode — runs against the
hardened wave path, and the exit checks prove the books balanced: no
request is lost, only completed, shed, or failed with accounting.

``--model lm`` serves greedy LM generation waves (granite-3-2b's smoke
config, prompt 8 → +4 tokens) through ``runtime.serve_loop.LMDecodeAdapter``
and ``--model moe`` fixed-shape MoE dispatch waves through
``MoEAdapter`` (the 'moe' Router algorithm), each through the same wave
core, single server, tick loop.

On N ≥ 2 ranks (``python -m repro_torch.launch.ranks -n N ...``) rank 0
leads and the other ranks follow (``RankWaves``): rank 0 runs the front
end — arrivals, queue, waves, books, the ``--async`` threads and the
fleet — and announces each wave to the others by one broadcast of its
input before running it; every rank then runs the same wave function on
the same input, so every wave's collectives are called in the same order
on every rank, and the fleet's replicas take their turns through one
lock.  Only rank 0 prints and returns the books.  ``--pipeline two_stage``
builds the reference's mesh, (2, N // 2) over ("pipe", "vault") — with N
odd the last rank is left out, as the reference leaves out the last
device — and runs the encoder on pipe rank 0 and routing on pipe rank 1
(``core.pipeline.two_stage_pipeline``); ``--plan auto`` without it
shards routing over every rank.  Alone, two_stage exits with the
reference's message, as it needs two ranks.

    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke --async
    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke --plan auto
    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke --chaos
    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke --model lm
    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke --model moe
    PYTHONPATH=src python -m repro_torch.launch.serve_caps --smoke \\
        --replicas 2 --tenants 2 --slo-ms 2000 --chaos
    PYTHONPATH=src python -m repro_torch.launch.serve_caps \\
        --network Caps-MN1 --requests 300 --microbatch 100 --n-micro 2
    PYTHONPATH=src python -m repro_torch.launch.ranks -n 2 \\
        repro_torch.launch.serve_caps --smoke --pipeline two_stage \\
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS, smoke_caps
from repro_torch.core.router import RouterSpec, reference_spec
from repro_torch.data.synthetic import SyntheticCapsDataset
from repro_torch.launch import ranks
from repro_torch.models.capsnet import CapsNet
from repro_torch.runtime import mesh_utils
from repro_torch.runtime.caps_fleet import CapsFleet, TenantPolicy
from repro_torch.runtime.caps_serve import (CapsAdapter, ServeConfig,
                                            make_wave_fn)
from repro_torch.runtime.elastic import ElasticPolicy
from repro_torch.runtime.wave_serve import WaveServer


def chaos_plan(args, cfg: ServeConfig, faults, crash: bool):
    """Seeded fault schedule sized to the run: enough scheduled waves to
    cover the request count twice over (retries advance the call index),
    with wave-exception and NaN-corruption rates as in the reference and
    — in fleet mode — one replica crash early in the run."""
    n_waves = max(8, 2 * math.ceil(args.requests / cfg.wave_lanes) + 4)
    return faults.FaultPlan.generate(
        args.chaos_seed, n_waves, p_error=0.15, p_corrupt=0.1,
        crash_wave=1 if crash else None)


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


def run_sync(server: WaveServer, ds, schedule):
    """One wave per tick (the caller-cadence loop), then drain."""
    done = []
    for tick, count in enumerate(schedule):
        if count:
            batch = ds.batch(tick, count)
            server.submit(batch["images"])
        done.extend(server.step())
    done.extend(server.drain())
    return done


def run_async(server: WaveServer, ds, schedule, n_submitters: int):
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


class RankWaves:
    """The waves of several ranks (module docstring): rank 0 leads, the
    others follow.  Each wave function is keyed by its spec's index in
    ``specs`` (0 the served spec, 1 the output guard's reference) and built
    once a rank over ``cfg``; ``lead(key)`` is rank 0's wave function,
    which broadcasts (key, images, mask) to every rank before it runs, and
    ``follow()`` the other ranks' loop, which runs each announced wave
    (a rank outside ``cfg.mesh`` only receives) until ``stop()``."""

    _STOP, _WAVE = 0, 1

    def __init__(self, net: CapsNet, specs, cfg: ServeConfig):
        self.net, self.specs, self.cfg = net, specs, cfg
        mesh = cfg.mesh
        self.in_mesh = mesh is None or mesh.get_coordinate() is not None
        c = net.cfg
        self.shapes = ((cfg.n_micro, cfg.microbatch, c.image_hw, c.image_hw,
                        c.image_channels), (cfg.n_micro, cfg.microbatch))
        self.lock = threading.Lock()
        self.waves = 0            # waves this rank ran
        self._fns = {}

    def _fn(self, key: int):
        if key not in self._fns:
            self._fns[key] = make_wave_fn(self.net, self.specs[key],
                                          self.cfg)
        return self._fns[key]

    def _header(self, code: int, key: int) -> tuple:
        h = torch.tensor([code, key], dtype=torch.int64,
                         device=self.net.device)
        dist.broadcast(h, 0)
        return int(h[0]), int(h[1])

    def lead(self, key: int):
        fn = self._fn(key)

        def wave(micro):
            with self.lock:
                self._header(self._WAVE, key)
                for name in ("images", "mask"):
                    dist.broadcast(micro[name].contiguous(), 0)
                self.waves += 1
                return fn(micro)
        return wave

    def follow(self) -> list:
        while True:
            code, key = self._header(0, 0)
            if code == self._STOP:
                return self._counts()
            micro = {name: torch.empty(shape, dtype=torch.float32,
                                       device=self.net.device)
                     for name, shape in zip(("images", "mask"),
                                            self.shapes)}
            for name in ("images", "mask"):
                dist.broadcast(micro[name], 0)
            if self.in_mesh:
                self._fn(key)(micro)
                self.waves += 1

    def stop(self) -> list:
        """End the followers' loops; every rank's wave count."""
        with self.lock:
            self._header(self._STOP, 0)
            return self._counts()

    def _counts(self) -> list:
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, self.waves)
        return counts


class RankedCapsAdapter(CapsAdapter):
    """``CapsAdapter`` whose wave functions are rank 0's of ``RankWaves``."""

    def __init__(self, net: CapsNet, spec, waves: RankWaves):
        super().__init__(net, spec)
        self.waves = waves

    def make_wave_fn(self, cfg: ServeConfig):
        return self.waves.lead(0)

    def make_reference_wave_fn(self, cfg: ServeConfig):
        return self.waves.lead(1)


def pipeline_mesh(device):
    """The reference's two-stage mesh over this process group: (2, N // 2)
    over ("pipe", "vault"), the last rank left out when N is odd."""
    n = ranks.world_size()
    if n < 2:
        raise SystemExit("--pipeline two_stage needs >= 2 ranks for the "
                         "2-sized 'pipe' axis (this process group has "
                         f"{n}); use --pipeline software")
    half = n // 2
    return mesh_utils.make_mesh((2, half), ("pipe", "vault"), device,
                                ranks=range(2 * half))


def _print_chaos(s: dict) -> None:
    print(f"chaos: {s['wave_errors']} wave errors, {s['retried']} "
          f"retried, {s['requeued']} requeued, {s['guard_trips']} guard "
          f"trips")


def run_fleet(args, net: CapsNet, ds, cfg: ServeConfig,
              adapter: CapsAdapter, schedule) -> dict:
    """Fleet mode: ``--tenants`` submitter threads (one per tenant) feed a
    ``--replicas``-sized CapsFleet whose replicas share the net's device;
    waves are deadline-ordered and the per-tenant books must balance on
    stop.  ``adapter`` serves the one model group.  Returns the fleet's
    summary."""
    slo_s = None if args.slo_ms is None else args.slo_ms / 1e3
    tenants = [TenantPolicy(f"t{i}", slo_s=slo_s, priority=i % 2)
               for i in range(args.tenants)]
    max_replicas = (args.replicas if args.max_replicas is None
                    else args.max_replicas)
    wave_wrap = None
    if args.chaos:
        from repro_torch.runtime import faults   # chaos only: opt-in
        crash = args.replicas > 1                # need a survivor to adopt
        wave_wrap = faults.fleet_wrap(
            {"default/r0": chaos_plan(args, cfg, faults, crash)})
    fleet = CapsFleet(
        net, tenants=tenants,
        models={"default": (adapter,
                            dataclasses.replace(cfg,
                                                queue_order="deadline"))},
        policy=ElasticPolicy(min_replicas=args.replicas,
                             max_replicas=max_replicas),
        control_interval_s=0.05, wave_wrap=wave_wrap)
    print(f"fleet: {args.replicas}..{max_replicas} replicas x "
          f"{args.tenants} tenants on {net.device}, slo="
          f"{'none' if slo_s is None else f'{args.slo_ms:.0f} ms'}, "
          f"deadline-ordered waves")
    fleet.start()

    def submitter(i: int, tenant: TenantPolicy):
        for tick, count in enumerate(schedule[i::args.tenants]):
            if count:
                batch = ds.batch(1000 * i + tick, count)
                fleet.submit(batch["images"], tenant=tenant.name)
            time.sleep(0.002)

    threads = [threading.Thread(target=submitter, args=(i, t))
               for i, t in enumerate(tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    s = fleet.stop()

    if s["pending"] != 0 or \
            s["submitted"] != s["completed"] + s["shed"] + s["failed"]:
        raise RuntimeError(f"fleet books do not balance: {s}")
    if s["submitted"] != args.requests:
        raise RuntimeError(f"{args.requests} requests sent, books show {s}")
    for name, t in s["per_tenant"].items():
        if t["submitted"] != (t["completed"] + t["shed"] + t["failed"]
                              + t["pending"]):
            raise RuntimeError(f"tenant {name} books do not balance: {t}")
    print(f"served {s['completed']} requests in {s['waves']} waves across "
          f"{s['replicas']} replicas ({s['shed']} shed, {s['failed']} "
          f"failed, goodput {s['goodput']}, "
          f"{len(fleet.completions)} completions)")
    if args.chaos:
        _print_chaos(s)
        print(f"  {s['evacuated']} evacuated -> {s['adopted']} adopted, "
              f"{len(s['health_events'])} burials")
    for name, t in s["per_tenant"].items():
        print(f"  {name}: submitted {t['submitted']}, completed "
              f"{t['completed']}, shed {t['shed']}, goodput {t['goodput']}")
    events = [e for evs in s["scale_events"].values() for e in evs]
    print(f"latency p50 {_fmt_ms(s['p50_latency_s'])}, "
          f"p90 {_fmt_ms(s['p90_latency_s'])}; "
          f"{len(events)} scale events")
    return s


def run_model_workload(args) -> dict:
    """``--model lm`` / ``--model moe``: serve a non-CapsNet workload
    adapter through the generic wave core (single server, sync tick loop)
    and check the same books the CapsNet paths check."""
    cfg = ServeConfig(microbatch=args.microbatch, n_micro=args.n_micro,
                      pipeline=None, max_queue=args.max_queue)
    rng = np.random.default_rng(args.chaos_seed + 1)
    if args.model == "lm":
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import lm
        from repro_torch.runtime.serve_loop import LMDecodeAdapter
        arch = get_smoke_config("granite-3-2b")
        params = lm.init_params(arch, seed=0, device=args.device)
        prompt_len, max_new = 8, 4
        adapter = LMDecodeAdapter(params, arch, prompt_len=prompt_len,
                                  max_new_tokens=max_new)
        desc = (f"{arch.name}: greedy decode waves, prompt {prompt_len} "
                f"-> +{max_new} tokens")

        def make_items(count):
            return rng.integers(0, arch.vocab, (count, prompt_len),
                                dtype=np.int32)
    else:
        from repro_torch.kernels import resolve_device
        from repro_torch.models import moe as moe_lib
        from repro_torch.runtime.serve_loop import MoEAdapter
        # capacity_factor >= n_experts/top_k: nothing dropped, so padded
        # lanes can never evict real tokens (see MoEAdapter)
        moe_cfg = moe_lib.MoEConfig(d_model=32, d_ff=64, n_experts=4,
                                    top_k=2, capacity_factor=4.0)
        dev = resolve_device(args.device)
        params = moe_lib.init_moe(torch.Generator(dev).manual_seed(0),
                                  moe_cfg, dtype=torch.float32, device=dev)
        seq_len = 8
        adapter = MoEAdapter(params, moe_cfg, seq_len=seq_len)
        desc = (f"moe-tiny: E={moe_cfg.n_experts} top{moe_cfg.top_k} "
                f"dispatch waves via RouterSpec(algorithm='moe'), "
                f"blocks ({seq_len}, {moe_cfg.d_model})")

        def make_items(count):
            return rng.standard_normal(
                (count, seq_len, moe_cfg.d_model)).astype(np.float32)

    wave_fn = None
    if args.chaos:
        from repro_torch.runtime import faults   # chaos only: opt-in
        wave_fn = faults.chaos_wave_fn(
            adapter.make_wave_fn(cfg),
            chaos_plan(args, cfg, faults, crash=False))
    server = WaveServer(adapter, cfg=cfg, wave_fn=wave_fn)
    schedule = arrival_schedule(args.requests,
                                max(1.0, args.load * cfg.wave_lanes))
    print(f"{desc}; {args.requests} requests over {len(schedule)} ticks, "
          f"wave = {cfg.n_micro} x {cfg.microbatch} lanes, "
          f"device={adapter.device}"
          + (f", chaos seed {args.chaos_seed}" if args.chaos else ""))
    done = []
    for count in schedule:
        if count:
            server.submit(make_items(count))
        done.extend(server.step())
    done.extend(server.drain())

    s = check_books(server, args.requests)
    print(f"served {s['completed']} requests in {s['waves']} waves "
          f"({s['padded_lanes']} padded lanes, {s['shed']} shed, "
          f"{s['failed']} failed)")
    if args.chaos:
        _print_chaos(s)
    thr = s["throughput_rps"]
    print(f"latency p50 {_fmt_ms(s['p50_latency_s'])}, "
          f"p90 {_fmt_ms(s['p90_latency_s'])}; "
          f"throughput {'n/a' if thr is None else f'{thr:.1f} req/s'}")
    return s


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="Caps-MN1",
                    choices=sorted(CAPS_BENCHMARKS))
    ap.add_argument("--model", default="caps", choices=("caps", "lm", "moe"),
                    help="workload adapter: caps = the paper's CapsNet "
                         "waves; lm / moe = the single-server tick loop "
                         "over the LM-decode / MoE adapters (fleet and "
                         "async flags are caps-only)")
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
                    help="> 1 serves through the CapsFleet front-end with "
                         "this many replica servers on one device")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="elastic upper bound for the fleet controller; "
                         "default = --replicas (no elasticity)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="> 1 submits from this many tenant threads with "
                         "per-tenant fleet accounting")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request SLO for fleet mode; waves form "
                         "deadline-first and goodput counts met deadlines")
    ap.add_argument("--load", type=float, default=0.75,
                    help="offered load as a fraction of wave capacity "
                         "per tick")
    ap.add_argument("--chaos", action="store_true",
                    help="deterministic fault injection (runtime.faults): "
                         "seeded wave exceptions + NaN corruption, plus a "
                         "replica crash in fleet mode")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="FaultPlan.generate seed (same seed = same "
                         "schedule, every run)")
    args = ap.parse_args(argv)

    if args.smoke:
        caps_cfg = smoke_caps()
        args.requests = min(args.requests, 24)
        args.microbatch, args.n_micro = 4, 2
    else:
        caps_cfg = CAPS_BENCHMARKS[args.network]
    world = ranks.world_size()
    if args.model != "caps":
        # one server on rank 0: these adapters run on one device
        if world > 1 and dist.get_rank() != 0:
            return None
        return run_model_workload(args)

    # fp32 convolutions and products, as the reference computes them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    pipeline = None if args.pipeline == "none" else args.pipeline
    mesh = pipeline_mesh(args.device) if pipeline == "two_stage" else None
    cfg = ServeConfig(microbatch=args.microbatch, n_micro=args.n_micro,
                      pipeline=pipeline, mesh=mesh,
                      routing_plan="auto" if args.plan == "auto" else None,
                      max_queue=args.max_queue)
    spec = RouterSpec(algorithm=args.algorithm, backend=args.backend,
                      iterations=caps_cfg.routing_iters)
    net = CapsNet(caps_cfg, device=args.device, seed=0)
    ds = SyntheticCapsDataset(caps_cfg.image_hw, caps_cfg.image_channels,
                              caps_cfg.num_h_caps)
    schedule = arrival_schedule(args.requests,
                                max(1.0, args.load * cfg.wave_lanes))

    if world == 1:
        return serve(args, net, ds, cfg, CapsAdapter(net, spec), schedule)
    waves = RankWaves(net, (spec, reference_spec(spec)), cfg)
    if dist.get_rank() != 0:
        waves.follow()
        return None
    s = serve(args, net, ds, cfg, RankedCapsAdapter(net, spec, waves),
              schedule)
    s["rank_waves"] = waves.stop()
    return s


def serve(args, net: CapsNet, ds, cfg: ServeConfig, adapter: CapsAdapter,
          schedule) -> dict:
    """The CapsNet front end: the fleet or one server over ``adapter``
    (rank 0's ``RankedCapsAdapter`` on several ranks).  Returns the books,
    with every request's prediction by id under "predictions"."""
    caps_cfg = net.cfg
    if (args.replicas > 1 or args.tenants > 1 or args.slo_ms is not None
            or args.max_replicas is not None):
        return run_fleet(args, net, ds, cfg, adapter, schedule)

    wave_fn = None
    if args.chaos:
        from repro_torch.runtime import faults   # chaos only: opt-in
        wave_fn = faults.chaos_wave_fn(
            adapter.make_wave_fn(cfg),
            chaos_plan(args, cfg, faults, crash=False))
    server = WaveServer(adapter, cfg=cfg, wave_fn=wave_fn)
    mode = (f"async x {args.submitters} submitters" if args.async_mode
            else "sync tick loop")
    print(f"{caps_cfg.name}: {args.requests} requests over "
          f"{len(schedule)} ticks (ragged), wave = {cfg.n_micro} x "
          f"{cfg.microbatch} lanes, pipeline={cfg.pipeline}, "
          f"plan={args.plan}, algorithm={args.algorithm}, "
          f"backend={args.backend}, "
          f"device={net.device}, {mode}"
          + (f", chaos seed {args.chaos_seed}" if args.chaos else ""))

    if args.async_mode:
        done = run_async(server, ds, schedule, max(1, args.submitters))
    else:
        done = run_sync(server, ds, schedule)

    s = check_books(server, args.requests)
    print(f"served {s['completed']} requests in {s['waves']} waves "
          f"({s['padded_lanes']} padded lanes, {s['shed']} shed, "
          f"{s['failed']} failed, {s['wave_errors']} wave errors)")
    if args.chaos:
        _print_chaos(s)
    thr = s["throughput_rps"]
    print(f"latency p50 {_fmt_ms(s['p50_latency_s'])}, "
          f"p90 {_fmt_ms(s['p90_latency_s'])}; "
          f"throughput {'n/a' if thr is None else f'{thr:.1f} req/s'}")
    preds = {c.rid: c.pred for c in done}
    print("first predictions:", [preds[r] for r in sorted(preds)[:8]])
    return {**s, "predictions": preds}


if __name__ == "__main__":
    main()
