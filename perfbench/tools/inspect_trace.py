"""The device operations of a traced run, grouped by the host op that
launched them and by name, with the layer each reader's patterns give
them: to check the readers' patterns against what the card ran.

    python3 perfbench/tools/inspect_trace.py --workload caps-mn1.batch
"""
import argparse
import collections
import time

import _setup


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    dev = _setup.card()
    import torch
    print("torch", torch.__version__, torch.version.cuda)
    from perfbench.common import harness, runner, trace as tr
    bench = harness.load_json(_setup.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload)
    t = time.perf_counter()
    ctx, out, readers = runner.execute(cell, args.seed, args.seconds, True,
                                       dev, t, time.perf_counter)
    trace = ctx.tracer.trace
    claims = runner.claims_of(readers)
    groups = collections.defaultdict(lambda: [0, 0.0])
    for d in trace.ops():
        g = groups[(claims.layer_of(d), d.op, d.name[:100])]
        g[0] += 1
        g[1] += d.end - d.start
    print("tracer start and stop took", ctx.tracer.costs_s, "s")
    print("window_s", trace.window_s, "busy_s", tr.busy_s(trace),
          "ops", len(trace.ops()), "counters",
          {k: v for k, v in out.counters.items() if not isinstance(v, list)})
    for (layer, op, name), (n, s) in sorted(groups.items(),
                                            key=lambda kv: -kv[1][1])[:40]:
        print(f"{s:10.6f} {n:6d} {layer:8s} {op[:40]:40s} {name}")
    line = runner.result(ctx, out, readers, torch.cuda.get_device_name(dev),
                         1)
    print(line["metrics"])
    print(line["breakdown"])


if __name__ == "__main__":
    main()
