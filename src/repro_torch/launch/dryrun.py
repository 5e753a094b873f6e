"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake
tensors and count what one device does.

The port's counterpart of the JAX package's ``launch/dryrun.py``, which
lowers and compiles each cell through XLA on 512 forced host devices.  Here
each cell runs its real entry point — ``runtime.train_loop.make_train_step``,
``models.lm.prefill`` or ``models.lm.decode_step`` — as rank r of a fake
process group of 256 or 512 ranks (``dist.init_process_group("fake")``,
``torch.testing._internal.distributed.fake_pg``; a ``cpu`` ``DeviceMesh``
over it; no collective moves data), on fake tensors
(``FakeTensorMode``) on the card's device type, so the run takes every
branch the card's run takes; the kernel wrappers take their fake routes
and no kernel or plain version runs.  ``launch.op_analysis.OpAnalysis``
counts the step.  For each cell this:

  1. builds the production mesh ((16,16) or (2,16,16); the smoke mesh
     (2,4) or (2,2,4) with ``--smoke``) over the fake group,
  2. builds every parameter leaf at its local shape (``lm.local_shape``;
     never the global one: mistral-large would be 246 GB), the AdamW
     moments, this rank's batch rows (``configs.input_specs``) and, to
     decode, the caches, whose position comes from the shape cell (the
     last slot of ``seq_len``: a fake tensor's value is known only where
     it is a constant),
  3. runs the step under ``OpAnalysis``: a failure (a sharding mismatch, a
     refused shape) is a bug,
  4. records the peak memory a device and its split (``memory``), the
     FLOPs, HBM bytes and collective bytes by kind (``ops``: the
     counterpart of the reference's ``hlo``), the kernels' calls, and
     ``trace_s`` (the reference's ``compile_s``),
  5. does this for rank 0 and for the last rank — under ``seq_tp`` the
     last rank does more attention — records both under ``ranks`` and
     their maximum at the top,
  6. writes one JSON per cell to ``--out``.

Where no card is visible (a CPU build of torch, or a process the card is
hidden from) the fake tensors lie on the CPU: autograd on fake CUDA
tensors needs CUDA's device guard, and a CPU build aborts the process
there.  The model's branches do not depend on the device type, and the
kernel wrappers take their fake routes on either (``fake_device`` in the
record).
Importing this module sets nothing; every group a cell starts is destroyed
before the next.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out results/dryrun
  python -m repro_torch.launch.dryrun --smoke --all --multi-pod both
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch.checkpoint.ckpt import flatten, unflatten_like
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import lm
from repro_torch.models.layers import NO_RULES, AxisRules
from repro_torch.optim import adamw_init
from repro_torch.runtime import mesh_utils
from repro_torch.runtime import sharding as sh
from repro_torch.runtime import train_loop

# per-arch microbatch counts for train_4k, the reference's (it bounds
# activation memory; (256/n) % dp_size must be 0 on both meshes)
TRAIN_MICROBATCHES: Dict[str, int] = {
    "mistral-large-123b": 8,
    "phi3-medium-14b": 8,
    "stablelm-12b": 8,
    "qwen3-moe-30b-a3b": 8,
    "mixtral-8x7b": 8,
    "zamba2-7b": 8,
    "falcon-mamba-7b": 8,
    "llava-next-mistral-7b": 8,
    "granite-3-2b": 8,
    "seamless-m4t-large-v2": 8,
}

def fake_device() -> str:
    """The device type of the dry run's fake tensors (module docstring)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def num_microbatches(arch: str, global_batch: int, dp: int,
                     multi_pod: bool, smoke: bool) -> int:
    """The reference's microbatch rule: ``TRAIN_MICROBATCHES`` (1 on the
    smoke configs); mistral-large-123b takes 16 on one pod (one sequence a
    device: dp = 16 allows it, dp = 32 caps it at 8); halved until the
    data-parallel size divides each microbatch."""
    n = 1 if smoke else TRAIN_MICROBATCHES.get(arch, 2)
    if arch == "mistral-large-123b" and not multi_pod and not smoke:
        n = 16
    while n > 1 and (global_batch // n) % dp:
        n //= 2
    return max(n, 1)


def fake_params(cfg: lm.ArchConfig, rules: AxisRules, device) -> dict:
    """Every parameter leaf at its local shape under ``rules``, empty,
    under the active ``FakeTensorMode`` (shapes and axes from meta
    tensors, made before it)."""
    meta = lm.init_params(cfg, device="meta")
    axes = flatten(lm.param_logical_axes(cfg))
    return unflatten_like(meta, {
        k: torch.empty(lm.local_shape(tuple(t.shape), axes[k], rules),
                       dtype=t.dtype, device=device)
        for k, t in flatten(meta).items()})


def local_rows(rules: AxisRules, n: int) -> int:
    """This rank's rows of a batch of ``n`` under ``rules``."""
    size = rules.size(rules.axis("batch"))
    return n // size if size > 1 and n % size == 0 else n


def fake_batch(cfg: lm.ArchConfig, shape: C.ShapeCell, rules: AxisRules,
               n_micro: int, device) -> dict:
    """This rank's rows of every input of the cell (``input_specs``),
    empty, under the active ``FakeTensorMode``."""
    dim = 1 if shape.kind == "train" and n_micro > 1 else 0
    out = {}
    for name, (shp, dtype) in C.input_specs(cfg, shape, n_micro).items():
        shp = list(shp)
        shp[dim] = local_rows(rules, shp[dim])
        out[name] = torch.empty(shp, dtype=dtype, device=device)
    return out


@contextlib.contextmanager
def constants_up_to(n: int):
    """Let the fake mode fold constants of up to ``n`` elements.  It keeps
    a constant only while every result computed from it is at most
    ``fake_tensor.CONSTANT_NUMEL_LIMIT`` (1) elements, and a larger view
    of it (``pos[:, None]``) drops it; the decode position is a (batch,)
    constant, and decode asks for its slot (``int(slot[0])``) after such
    views.  Only ops whose every tensor input is a constant fold, and here
    those are the position's own."""
    from torch._subclasses import fake_tensor
    old = fake_tensor.CONSTANT_NUMEL_LIMIT
    fake_tensor.CONSTANT_NUMEL_LIMIT = max(old, n)
    try:
        yield
    finally:
        fake_tensor.CONSTANT_NUMEL_LIMIT = old


def decode_state(cfg: lm.ArchConfig, batch: int, seq_len: int,
                 rules: AxisRules, device, mode,
                 pos: torch.Tensor) -> lm.DecodeState:
    """Zero caches for ``seq_len`` positions under ``mode`` (a
    ``FakeTensorMode``), at position ``pos``, a real (batch,) tensor on
    ``device`` that becomes a constant of the mode: the slot the step
    writes is then known."""
    state = lm.init_decode_state(cfg, batch, seq_len, device=device,
                                 rules=rules)
    return state._replace(pos=mode.fake_tensor_converter.from_real_tensor(
        mode, pos, make_constant=True))


def analyze_step(cfg: lm.ArchConfig, shape: C.ShapeCell,
                 rules: AxisRules = NO_RULES, n_micro: int = 1,
                 device=None, max_len: Optional[int] = None) -> dict:
    """One rank's step of the cell on fake tensors under ``OpAnalysis``:
    {"memory", "ops", "trace_s"}.  With ``NO_RULES`` it is the one-device
    step (the card's own check of the prediction).  ``max_len``: a
    prefill's cache length (the cell's ``seq_len`` by default, as the
    reference's; a serving wave's prompt plus the tokens it generates)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = torch.device(device or fake_device())
    kind = shape.kind
    step = (train_loop.make_train_step(cfg, rules, num_microbatches=n_micro)
            if kind == "train" else None)
    mode = FakeTensorMode()
    rows = local_rows(rules, shape.global_batch)
    # decode at the last slot of the cache (a real tensor, made a constant)
    pos = (torch.full((rows,), shape.seq_len - 1, dtype=torch.int32,
                      device=device) if kind == "decode" else None)
    t0 = time.perf_counter()
    with mode:
        params = fake_params(cfg, rules, device)
        if kind == "train":
            opt = adamw_init(flatten(params))
            batch = fake_batch(cfg, shape, rules, n_micro, device)
            args = (params, opt, batch)
        elif kind == "prefill":
            args = (params, fake_batch(cfg, shape, rules, 1, device))
        else:
            state = decode_state(cfg, rows, shape.seq_len, rules, device,
                                 mode, pos)
            tokens = torch.empty((rows, 1), dtype=torch.int32,
                                 device=device)
            args = (params, state, tokens)
        with OpAnalysis() as a:
            a.arguments(*args)
            if kind == "train":
                out = step(*args)
            else:
                with torch.no_grad():
                    if kind == "prefill":
                        out = lm.prefill(params, cfg, args[1],
                                         max_len=max_len or shape.seq_len,
                                         rules=rules)
                    else:
                        with constants_up_to(rows):
                            out = lm.decode_step(params, cfg, state, tokens,
                                                 rules)
            a.outputs(out)
        del out, args
    return {"memory": a.memory(), "ops": a.stats.as_dict(),
            "trace_s": round(time.perf_counter() - t0, 2)}


def _max_over(ranks: dict) -> tuple:
    """The ranks' maximum of each memory figure and of each ops total."""
    recs = list(ranks.values())
    memory = {k: max(r["memory"][k] for r in recs)
              for k in recs[0]["memory"]}
    keys = ("flops", "product_flops", "hbm_bytes", "hbm_bytes_lower",
            "collective_bytes", "collective_ops")
    ops = {k: max(r["ops"][k] for r in recs) for k in keys}
    kinds = {k for r in recs for k in r["ops"]["collective_by_kind"]}
    ops["collective_by_kind"] = {
        k: max(r["ops"]["collective_by_kind"].get(k, 0.0) for r in recs)
        for k in sorted(kinds)}
    names = {k for r in recs for k in r["ops"]["kernels"]}
    ops["kernel_calls"] = {
        k: max(r["ops"]["kernels"].get(k, {"calls": 0})["calls"]
               for r in recs) for k in sorted(names)}
    return memory, ops


@contextlib.contextmanager
def fake_process_group(rank: int, world: int):
    """This process as rank ``rank`` of a fake group of ``world`` ranks
    (``torch.testing._internal.distributed.fake_pg``: collectives return
    at once and move nothing), destroyed on the way out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts fake process groups of its "
                           "own: run it in a process with no default "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_on_mesh(cfg: lm.ArchConfig, shape: C.ShapeCell, mesh_shape,
                  axes, rank: int, n_micro: int = 1,
                  overrides: Optional[dict] = None) -> dict:
    """``analyze_step`` as rank ``rank`` of a fake group over a mesh of
    ``mesh_shape`` and ``axes``, under the rules of the cell's mode
    (the batch replicated where the global batch is smaller than the
    data-parallel size: long_500k's B = 1)."""
    with fake_process_group(rank, math.prod(mesh_shape)):
        mesh = mesh_utils.make_mesh(mesh_shape, axes, device="cpu")
        rule_overrides = dict(overrides or {})
        if shape.global_batch < mesh_utils.dp_size(mesh):
            rule_overrides.setdefault("batch", None)
        rules = sh.make_rules(cfg, mesh, shape.kind, rule_overrides)
        return analyze_step(cfg, shape, rules, n_micro)


def model_flops_per_device(cfg: lm.ArchConfig, kind: str, global_batch: int,
                           seq_len: int, n_devices: int) -> float:
    """6·N_active·tokens / n_devices to train, 2· to prefill, 2·N_active
    a sequence to decode (the reference's ``roofline.
    model_flops_per_device``; N_active counts top_k of n_experts of an
    MoE's expert weights, as its ``active_param_count``)."""
    n = cfg.param_count()
    if cfg.moe is not None:
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        moe_total = 3 * cfg.moe.d_ff * cfg.d_model * e * cfg.n_layers
        n = n - moe_total + moe_total * k // e
    if kind == "train":
        total = 6.0 * n * global_batch * seq_len
    elif kind == "prefill":
        total = 2.0 * n * global_batch * seq_len
    else:
        total = 2.0 * n * global_batch
    return total / n_devices


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               smoke: bool = False,
               overrides: Optional[dict] = None) -> dict:
    """Trace one cell on rank 0 and on the last rank of a fake group;
    returns the record.  Needs a process with no default process group."""
    shape = C.SHAPES[shape_name]
    runnable, why = C.cell_is_runnable(arch, shape_name)
    if not runnable:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skip", "reason": why}
    cfg = C.get_smoke_config(arch) if smoke else C.get_config(arch)
    mesh_shape, axes = (mesh_lib.SMOKE if smoke
                        else mesh_lib.PRODUCTION)[multi_pod]
    n_dev = math.prod(mesh_shape)
    dp = math.prod(n for n, a in zip(mesh_shape, axes) if a != "model")
    record = {"arch": arch, "shape": shape_name,
              "mesh": "multi" if multi_pod else "single",
              "mesh_shape": list(mesh_shape), "kind": shape.kind,
              "n_devices": n_dev, "seq_len": shape.seq_len,
              "global_batch": shape.global_batch,
              "fake_device": fake_device()}
    n_micro = 1
    if shape.kind == "train":
        n_micro = num_microbatches(arch, shape.global_batch, dp, multi_pod,
                                   smoke)
        record["num_microbatches"] = n_micro
    ranks = {str(r): trace_on_mesh(cfg, shape, mesh_shape, axes, r, n_micro,
                                   overrides)
             for r in sorted({0, n_dev - 1})}
    record["ranks"] = ranks
    record["memory"], record["ops"] = _max_over(ranks)
    record["model_flops_per_device"] = model_flops_per_device(
        cfg, shape.kind, shape.global_batch, shape.seq_len, n_dev)
    record["trace_s"] = round(sum(r["trace_s"] for r in ranks.values()), 2)
    record["status"] = "ok"
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("off", "on", "both"),
                    default="off")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs + (2,4)/(2,2,4) mesh (CI check)")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    archs = C.list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(C.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in pods]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
        out_path = os.path.join(args.out, tag + ".json")
        if os.path.exists(out_path):
            with open(out_path) as f:
                prev = json.load(f)
            if prev.get("status") in ("ok", "skip"):
                print(f"[cached] {tag}: {prev['status']}")
                n_ok += prev["status"] == "ok"
                n_skip += prev["status"] == "skip"
                continue
        print(f"[trace]  {tag} ...", flush=True)
        try:
            rec = lower_cell(arch, shape, mp, smoke=args.smoke)
        except Exception as e:  # a failing cell is a bug: record it loudly
            rec = {"arch": arch, "shape": shape,
                   "mesh": "multi" if mp else "single",
                   "status": "fail", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        n_ok += status == "ok"
        n_skip += status == "skip"
        n_fail += status == "fail"
        extra = ""
        if status == "ok":
            extra = (f" trace={rec['trace_s']}s "
                     f"mem/dev={rec['memory']['peak_bytes_per_device'] / 2 ** 30:.2f}GiB "
                     f"flops/dev={rec['ops']['flops']:.3e}")
        elif status == "fail":
            extra = " " + rec["error"][:160]
        print(f"[{status}]  {tag}{extra}", flush=True)
    print(f"\ndone: ok={n_ok} skip={n_skip} fail={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
