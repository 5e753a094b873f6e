"""Starting a CLI as several ranks: the port's multi-rank launch.

The reference is one process that sees every device; the port runs one
process a rank.  ``run(main, argv, world, device)`` starts ``world``
processes (``torch.multiprocessing``, start method "spawn": CUDA forbids a
fork once it is initialized), joins them into one process group through a
``FileStore`` in a fresh temporary directory (no network), calls
``main(argv)`` in each, and returns rank 0's result.

* **Backend.**  NCCL on the card when every rank has a card of its own
  (``world <= torch.cuda.device_count()``); gloo on the CPU and for ranks
  that share a card, since NCCL refuses two ranks on one GPU.  Rank r
  selects card ``r % device_count`` before anything touches the card.
* **Failures.**  A rank that raises writes its traceback beside the
  store; the launcher then terminates the other ranks, which may be
  waiting in a collective, and raises ``RankFailed`` with that traceback.
  ``timeout_s`` bounds the run's wall time: past it the launcher
  terminates the ranks and raises ``RankFailed`` naming those still
  running, which catches a rank that hangs outside a collective too.  The
  process group's timeout (``TIMEOUT_S``) is a backstop.
* **The kernels** are built once in the parent before the ranks start
  (``kernels.cudalib.build``), so the ranks load the library instead of
  each compiling every source.
* **The result.**  Rank 0 hands ``keep(result)`` (a module-level function;
  the result itself when None) back through ``torch.save`` in the same
  directory; its tensors arrive on the CPU.
* **Threads.**  Ranks on the CPU each take their share of the host's
  intra-op threads, so that they do not oversubscribe it.  Ranks on the
  card keep PyTorch's default: the same cut made the four gloo ranks of
  ``chip_smoke.py``'s phase 15, which share one H100, a quarter slower.

    PYTHONPATH=src python -m repro_torch.launch.ranks -n 2 \\
        repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.ranks -n 2 \\
        repro_torch.launch.serve_caps --smoke --pipeline two_stage \\
        --device cpu

The CLI runs ``<module>.main`` with the arguments that follow the module;
its ranks run on the device those arguments name (``--device``, the card
when they name none, as every entry point defaults to it).
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import cudalib, resolve_device

TIMEOUT_S = 900          # the process group's backstop for a lost rank
_POLL_S = 0.05


class RankFailed(RuntimeError):
    """A rank of ``run`` raised; the message holds its traceback."""


def backend(world: int, device) -> str:
    """The process group's backend for ``world`` ranks on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank(rank: int, world: int, device: str, d: str, main: Callable,
          argv: list, keep: Optional[Callable]) -> None:
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        dist.init_process_group(
            backend(world, device),
            store=dist.FileStore(os.path.join(d, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            out = main(argv)
        except SystemExit as e:
            if e.code not in (None, 0):
                raise
            out = None
        if rank == 0:
            torch.save(out if keep is None else keep(out),
                       os.path.join(d, "result.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(d, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)


def _failure(procs, d: str) -> Optional[str]:
    """The report of the rank that failed first, or None while none has
    failed.  Once one rank fails, the ranks waiting on it in a collective
    fail too, later: the earliest report names the cause."""
    errs = [os.path.join(d, f"rank{r}.err") for r in range(len(procs))]
    if not any(os.path.exists(e) or p.exitcode not in (None, 0)
               for e, p in zip(errs, procs)):
        return None
    time.sleep(_POLL_S)                 # let the rank finish its report
    written = [(os.path.getmtime(e), r) for r, e in enumerate(errs)
               if os.path.exists(e)]
    if written:
        r = min(written)[1]
        text = open(errs[r]).read()
    else:
        r = next(r for r, p in enumerate(procs)
                 if p.exitcode not in (None, 0))
        text = f"exit code {procs[r].exitcode}, no traceback"
    return f"rank {r} of {len(procs)} failed:\n{text}"


def run(main: Callable[[list], Any], argv: Sequence[str], world: int,
        device="cuda", keep: Optional[Callable[[Any], Any]] = None,
        timeout_s: Optional[float] = None) -> Any:
    """``main(argv)`` on ``world`` ranks (module docstring); rank 0's
    result, or ``keep`` of it.  Raises ``RankFailed`` when a rank raises,
    or when the ranks run past ``timeout_s`` seconds (no limit when
    None)."""
    dev = resolve_device(device)
    if world < 1:
        raise ValueError(f"world must be at least 1; got {world}")
    if dev.type == "cuda":
        cudalib.build()
    d = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, dev.type, d, main,
                                              list(argv), keep))
             for r in range(world)]
    try:
        t0 = time.monotonic()
        for p in procs:
            p.start()
        while True:
            failed = _failure(procs, d)
            if failed is not None:
                raise RankFailed(failed)
            if all(p.exitcode == 0 for p in procs):
                break
            if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                alive = [r for r, p in enumerate(procs) if p.exitcode is None]
                raise RankFailed(f"ranks {alive} of {world} still running "
                                 f"after {timeout_s:g} s; terminated")
            time.sleep(_POLL_S)
        path = os.path.join(d, "result.pt")
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(d, ignore_errors=True)


def world_size() -> int:
    """The ranks of the caller's process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_of(argv: Sequence[str]) -> str:
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return "cuda"


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description="run a repro_torch CLI as several ranks")
    ap.add_argument("-n", "--ranks", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds after which the ranks are terminated "
                         "and the run fails; no limit by default")
    ap.add_argument("module", help="e.g. repro_torch.launch.serve")
    ap.add_argument("args", nargs=argparse.REMAINDER,
                    help="the module's own arguments")
    args = ap.parse_args(argv)
    entry = importlib.import_module(args.module).main
    try:
        run(entry, args.args, args.ranks, _device_of(args.args),
            keep=_nothing, timeout_s=args.timeout)
    except RankFailed as e:
        print(e, file=sys.stderr)
        return 1
    return 0


def _nothing(result) -> None:
    """What the CLI keeps of rank 0's result: the ranks print their own."""
    return None


if __name__ == "__main__":
    sys.exit(main())
