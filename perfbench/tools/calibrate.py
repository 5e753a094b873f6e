"""Readings for the limits of ``correct``: the numbers a cell compares, for
the program and for the control (the reference in TF32 put in the
program's place), on many seeds in one process.

    python3 perfbench/tools/calibrate.py --workload caps-mn1.batch \\
        --seeds 101,102,103 --seconds 3

Prints one JSON line a seed: {"seed", "program": {name: value},
"control": {name: value}}.
"""
import argparse
import json
import time

import _setup


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    dev = _setup.card()
    from perfbench.common import harness, runner
    bench = harness.load_json(_setup.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        ctx, out, _ = runner.execute(cell, seed, args.seconds, False, dev, t,
                                     time.perf_counter, control=True)
        print(json.dumps({
            "seed": seed, "correct": all(c.ok for c in out.checks),
            "program": {c.name: c.value for c in out.checks},
            "control": {c.name: c.value for c in ctx.control_checks},
            "e2e": out.e2e, "setup_s": ctx.setup_s,
            "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
