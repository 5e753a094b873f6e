"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload caps-mn1.batch --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for.  It makes the cell's weights and inputs from ``--seed``, sets up and
warms the program (``src/repro_torch``) on the card, measures for
``--seconds``, compares what the timed path produced with the plain
reference (``perfbench/reference``), and prints one JSON line last on
standard output: the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics from a device trace of part of the window.  The numbers
compared, each beside its limit, close standard error.  Without a card,
or with fewer than the cell asks for, it prints no result and exits 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.common import harness, runner

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, args.workload)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"repro_torch was imported from {repro_torch.__file__}, not "
              f"from this checkout's src/", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    ctx, outcome, readers = runner.execute(
        cell, args.seed, args.seconds, bool(args.trace), device, T_START,
        time.perf_counter)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 4
    line = runner.result(ctx, outcome, readers,
                         torch.cuda.get_device_name(device), chips)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    runner.print_checks(outcome.checks)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
