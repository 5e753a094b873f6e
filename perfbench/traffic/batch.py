"""Offline batch classification: a closed loop over the program's wave
function, one wave dispatched ahead of the one being collected.

Each wave is ``n_micro`` x ``microbatch`` images from a pool made on the
card from the seed and held in pinned host memory; the wave is copied to
the card, run through ``runtime.caps_serve.make_wave_fn`` (the function a
``CapsServer`` runs each wave) and its class scores are copied back.
``images_per_s`` is every image of every wave issued in the window over
the time from the window's start until the last of them is on the host.

Correctness: a sample of the window's waves, drawn from the seed, keeps
its scores as they reached the host; once the window has closed the
reference recomputes each from the pool's images and the benchmark's
weights.  Cell parameters (``workloads/<cell>.json``): microbatch,
n_micro, pool_waves, warmup_waves, sample_waves, trace_from, trace_s.
"""
from __future__ import annotations

import collections
import gc

import torch

from perfbench.common import capsnet as caps
from perfbench.common.harness import Check, Outcome
from perfbench.reference import capsnet as ref


def run(ctx) -> Outcome:
    p, cfg, dev = ctx.params, ctx.config, ctx.device
    from repro_torch.runtime.caps_serve import ServeConfig, make_wave_fn

    mb, nm = p["microbatch"], p["n_micro"]
    lanes = mb * nm
    hw, ch = cfg["image_hw"], cfg["image_channels"]
    weights = caps.make_weights(cfg, ctx.seed, dev)
    net = caps.build_net(cfg, weights, dev)
    wave = make_wave_fn(net, caps.router_spec(cfg),
                        ServeConfig(microbatch=mb, n_micro=nm))
    pool_dev = caps.make_images(cfg, p["pool_waves"] * lanes, ctx.seed,
                                "images", dev)
    pool_dev = pool_dev.reshape(p["pool_waves"], nm, mb, hw, hw, ch)
    pin = dev.type == "cuda"
    pool = torch.empty(pool_dev.shape, pin_memory=pin)
    pool.copy_(pool_dev)
    del pool_dev
    mask_host = torch.ones((nm, mb), pin_memory=pin)
    h = cfg["num_h_caps"]
    outs = [torch.empty((nm, mb, h), pin_memory=pin) for _ in range(2)]
    sample = caps.Reservoir(p["sample_waves"], ctx.seed)
    pending = collections.deque()
    n_issued = [0]

    def issue():
        k = n_issued[0]
        n_issued[0] += 1
        with ctx.tracer.span("h2d"):
            micro = {"images": pool[k % len(pool)].to(dev, non_blocking=True),
                     "mask": mask_host.to(dev, non_blocking=True)}
        with ctx.tracer.span("wave"):
            scores = wave(micro)
        host = outs[k % 2]
        with ctx.tracer.span("d2h"):
            host.copy_(scores, non_blocking=True)
        done = torch.cuda.Event() if dev.type == "cuda" else None
        if done is not None:
            done.record()
        pending.append((k, done, host))

    def collect():
        k, done, host = pending.popleft()
        with ctx.tracer.span("wait"):
            if done is not None:
                done.synchronize()
        slot = sample.slot()
        if slot >= 0:
            sample.put(slot, (k % len(pool), host.clone()))
        return k

    for _ in range(p["warmup_waves"]):
        issue()
        collect()
    sample = caps.Reservoir(p["sample_waves"], ctx.seed)
    n_issued[0] = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    ctx.setup_done()
    t0 = ctx.clock()
    traced, untraced = [None, None], (0, 0.0)
    # a traced run goes on until its trace is taken
    while (ctx.clock() - t0 < ctx.seconds
           or (ctx.tracer.enabled and traced[1] is None)):
        elapsed = ctx.clock() - t0
        if (ctx.tracer.enabled and traced[0] is None
                and elapsed >= p["trace_from"] * ctx.seconds):
            while pending:
                collect()
            untraced = (n_issued[0] * lanes, ctx.clock() - t0)
            ctx.tracer.start()
            traced[0], t_traced = n_issued[0], ctx.clock()
        if (traced[0] is not None and traced[1] is None
                and ctx.clock() - t_traced >= p["trace_s"]):
            while pending:
                collect()
            ctx.tracer.stop()
            traced[1] = n_issued[0]
        issue()
        if len(pending) > 1:
            collect()
    while pending:
        collect()
    t1 = ctx.clock()
    ctx.window_closed()

    waves = n_issued[0]
    trace_waves = (traced[1] - traced[0]) if traced[0] is not None else 0
    counters = {"images": waves * lanes, "waves": waves,
                "window_s": t1 - t0,
                "trace_routing_calls": trace_waves * nm,
                "microbatch": mb, "pre_trace_images": untraced[0],
                "pre_trace_s": untraced[1]}
    del wave, net, outs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    mask = torch.ones((nm, mb), device=dev)
    gaps, control = [], []
    for pool_idx, got in sample.items:
        images = pool[pool_idx].to(dev)
        want = ref.wave_scores(weights, images, mask, cfg)
        gaps.append(caps.score_gap(got, want))
        if ctx.control:
            lower = ref.wave_scores(weights, images, mask, cfg, tf32=True)
            control.append(caps.score_gap(lower, want))
    limit = ctx.cell.workload["limits"]["score_gap"]
    checks = [Check("score_gap", max(gaps), limit)]
    if ctx.control:
        ctx.control_checks = [Check("score_gap", max(control), limit)]
    return Outcome({"images_per_s": waves * lanes / (t1 - t0)}, counters,
                   attempted=waves * lanes, failed=0, checks=checks)
