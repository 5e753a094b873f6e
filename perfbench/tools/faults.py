"""Readings of the training cell's comparisons with a fault planted in the
program, at the cell's own size, on several seeds in one process:

    half_batch       half of the batch left out of the loss (the mean over
                     the rest), from the first step on
    step_count_lost  from the first step after set-up on, the optimizer
                     takes every step as its first (schedule and bias
                     correction), while its moments and count go on

A step that returns its state unchanged reads 1 on ``update_gap`` by
construction.

    python3 perfbench/tools/faults.py --workload caps-mn1.train \\
        --seeds 301,302,303 --fault half_batch
"""
import argparse
import json
import time

import _setup

FAULTS = ("half_batch", "step_count_lost")


def plant(fault: str, checked: int) -> None:
    import torch
    from repro_torch.models import capsnet
    from repro_torch.runtime import train_loop
    if fault == "half_batch":
        real = capsnet.loss_fn

        def half(net, images, labels, *a, **kw):
            kept = images.shape[0] // 2
            return real(net, images[:kept], labels[:kept], *a, **kw)
        capsnet.loss_fn = half
        return
    make = train_loop.make_capsnet_train_step

    def later(*args, **kw):
        step = make(*args, **kw)
        calls = [0]

        def run(net, opt_state, images, labels):
            calls[0] += 1
            if calls[0] <= checked:
                return step(net, opt_state, images, labels)
            net, state, metrics = step(
                net, opt_state._replace(step=torch.zeros_like(
                    opt_state.step)), images, labels)
            return net, state._replace(step=opt_state.step + 1), metrics
        return run
    train_loop.make_capsnet_train_step = later


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", choices=FAULTS, default="half_batch")
    args = ap.parse_args()
    dev = _setup.card()
    from perfbench.common import harness, runner
    bench = harness.load_json(_setup.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload)
    plant(args.fault, cell.traffic.CHECKED_STEPS)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        ctx, out, _ = runner.execute(cell, seed, args.seconds, False, dev, t,
                                     time.perf_counter)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": all(c.ok for c in out.checks),
                          "readings": {c.name: c.value
                                       for c in out.checks}}), flush=True)


if __name__ == "__main__":
    main()
