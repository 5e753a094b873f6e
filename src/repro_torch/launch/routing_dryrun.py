"""Paper-technique dry run: the routing procedure distributed over many
ranks, traced on fake tensors, beside the planner's models.

The port's counterpart of the JAX package's ``launch/routing_dryrun.py``.
Four experiments per CapsNet config (DESIGN.md §2 maps a vault to a chip):

  vault32   — the paper's own scale: 32 "vaults" (ranks) on one axis, every
              distribution dimension whose extent 32 divides (B and L; H =
              10..62 is not divisible by 32 — the paper allows imbalanced
              snippets, the port's ``shard_call`` requires divisibility:
              recorded as a skip).
  pod_B1d   — 256 ranks, B distributed.
  pod_BL2d  — beyond the paper: B over the 16-rank "data" axis × L over the
              16-rank "model" axis.
  pod_full_train — the whole CapsNet training step (conv + votes + routing
              + decoder + margin loss + SGD) data-parallel over 256 ranks,
              routing B-distributed (only the (L, H) logit update crosses
              ranks).

Each cell runs rank 0 of a fake process group of its size (every rank does
the same work here) on fake tensors under ``launch.op_analysis.OpAnalysis``
(``launch.dryrun`` says how); the routing cells go through the port's
``build_router`` with ``RouterSpec(backend="cuda")`` and an
``ExecutionPlan``, so the stage kernels of sharded routing take their fake
routes, and ``shard_call`` takes the global û, as a rank of the port holds
it.  Beside each cell: roofline terms (FLOPs over the fp32 rate, the
geometric mean of ``hbm_bytes_lower`` and ``hbm_bytes`` over the HBM rate,
collective bytes over the link rate of the group) at the H100's nominal
rates (``RATES``), and the planner's picks and models (paper Eq. 6–12
and the ring model) with ``DeviceModel.h100``.

    python -m repro_torch.launch.routing_dryrun --out results/routing_dryrun
    python -m repro_torch.launch.routing_dryrun --configs Caps-MN1 --batch 256
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from repro_torch.configs.caps_benchmarks import CAPS_BENCHMARKS
from repro_torch.core import distribution as D
from repro_torch.core import routing
from repro_torch.core.router import ExecutionPlan, RouterSpec, build_router
from repro_torch.launch.dryrun import fake_device, fake_process_group
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.runtime import mesh_utils
from repro_torch.runtime.train_loop import TRAIN_CAPS_CONV

# Nominal rates, not measured.  "NVIDIA H100 SXM5 80GB, 700 W, data sheet":
# fp32 67 TFLOP/s outside the tensor cores (routing runs in fp32), HBM3
# 3.35 TB/s, NVLink 900 GB/s (450 each way) inside one 8-GPU NVLink
# domain.  A group of more than 8 ranks spans several domains, and its
# ring runs at the slowest link it crosses: one 400 Gb/s NDR InfiniBand
# port a GPU, 50 GB/s ("NVIDIA DGX H100 data sheet").
RATES = {"fp32_flop_per_s": 67e12, "hbm_bytes_per_s": 3.35e12,
         "nvlink_bytes_per_s": 450e9, "ib_bytes_per_s": 50e9}
NVLINK_DOMAIN = 8
N_CHIPS = 256
POD_BATCH = 2048   # 256 ranks × 8 inputs (the reference's production batch)


def link_bytes_per_s(group: int) -> float:
    """The link rate that bounds a ring over ``group`` ranks."""
    return (RATES["nvlink_bytes_per_s"] if group <= NVLINK_DOMAIN
            else RATES["ib_bytes_per_s"])


def _terms(stats, group: int) -> dict:
    return {"compute_s": stats["flops"] / RATES["fp32_flop_per_s"],
            "memory_s": math.sqrt(max(stats["hbm_bytes_lower"], 1.0)
                                  * max(stats["hbm_bytes"], 1.0))
            / RATES["hbm_bytes_per_s"],
            "collective_s": stats["collective_bytes"]
            / link_bytes_per_s(group)}


def _trace(mesh_shape, mesh_axes, build) -> tuple:
    """Rank 0 of a fake group over ``mesh_shape``: ``build(mesh, device)``
    -> (arguments, run) under ``FakeTensorMode``; ``run()`` is counted.
    Returns (ops dict, memory dict, seconds)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.perf_counter()
    with fake_process_group(0, math.prod(mesh_shape)):
        mesh = mesh_utils.make_mesh(mesh_shape, mesh_axes, device="cpu")
        with FakeTensorMode():
            args, run = build(mesh, torch.device(fake_device()))
            with OpAnalysis() as a:
                a.arguments(*args)
                a.outputs(run())
    return a.stats.as_dict(), a.memory(), time.perf_counter() - t0


def _record(ops: dict, memory: dict, seconds: float, group: int) -> dict:
    return {"trace_s": round(seconds, 2), "flops": ops["flops"],
            "hbm_bytes": ops["hbm_bytes"],
            "hbm_bytes_lower": ops["hbm_bytes_lower"],
            "collective_bytes": ops["collective_bytes"],
            "collective_by_kind": ops["collective_by_kind"],
            "kernel_calls": {k: v["calls"]
                             for k, v in ops["kernels"].items()},
            "peak_bytes": memory["peak_bytes_per_device"],
            "terms": _terms(ops, group), "status": "ok"}


def lower_routing(mesh_shape, mesh_axes, axes, caps, batch: int,
                  iters: int, use_approx: bool = False) -> dict:
    """The routing procedure on the global û (B, L, H, C) fp32, sharded by
    ``axes`` ((dim, mesh axis) pairs) through the cuda-backend router."""
    group = max(mesh_shape[list(mesh_axes).index(a)] for _, a in axes)

    def build(mesh, device):
        routed = build_router(
            RouterSpec(algorithm="dynamic", backend="cuda", iterations=iters,
                       use_approx=use_approx),
            ExecutionPlan(mesh=mesh, axes=tuple(axes)), device=device)
        u_hat = torch.empty((batch, caps.num_l_caps, caps.num_h_caps,
                             caps.h_caps_dim), dtype=torch.float32,
                            device=device)

        def run():
            with torch.no_grad():
                return routed(u_hat)
        return (u_hat,), run

    return _record(*_trace(mesh_shape, mesh_axes, build), group)


def run_config(name: str, batch: int) -> dict:
    caps = CAPS_BENCHMARKS[name]
    s = D.RPShape(n_b=batch, n_l=caps.num_l_caps, n_h=caps.num_h_caps,
                  c_l=caps.l_caps_dim, c_h=caps.h_caps_dim,
                  iters=caps.routing_iters)
    out = {"config": name, "batch": batch, "rates": RATES, "cells": {}}

    # --- paper scale: 32 vaults, single-dimension choices -----------------
    out["paper_scale"] = {
        "planner_pick": D.plan(s, D.DeviceModel.h100(32)),
        "paper_E": {d: D.workload_E(d, s, 32) for d in D.DIMS},
        "paper_M": {d: D.comm_M(d, s, 32) for d in D.DIMS},
    }
    for dim in D.DIMS:
        extent = {"B": s.n_b, "L": s.n_l, "H": s.n_h}[dim]
        tag = f"vault32_{dim}"
        if extent % 32:
            out["cells"][tag] = {
                "status": "skip",
                "reason": f"{dim}-extent {extent} % 32 != 0 (paper allows "
                          f"imbalanced snippets; shard_call needs "
                          f"divisibility)"}
            continue
        rec = lower_routing((32,), ("vault",), ((dim, "vault"),), caps,
                            batch, s.iters)
        rec["ring_M_model"] = D.comm_M_ring({dim: 32}, s)
        out["cells"][tag] = rec
        print(f"  [{tag}] coll={rec['collective_bytes']:.3e}B "
              f"ringM={rec['ring_M_model']:.3e}B "
              f"mem={rec['terms']['memory_s'] * 1e3:.3f}ms", flush=True)

    # --- pod scale: 1D B over 256 vs 2D B x L over (16,16) ----------------
    candidates = {"B1d": {"B": 256}, "BL2d": {"B": 16, "L": 16}}
    out["pod_scale"] = {
        "planner_pick": D.plan_multi(s, D.DeviceModel.h100(256),
                                     candidates),
        "ring_M_model": {k: D.comm_M_ring(v, s)
                         for k, v in candidates.items()},
        "E_model": {k: D.workload_E_multi(v, s)
                    for k, v in candidates.items()},
    }
    rec = lower_routing((N_CHIPS,), ("vault",), (("B", "vault"),), caps,
                        batch, s.iters)
    out["cells"]["pod_B1d"] = rec
    print(f"  [pod_B1d] coll={rec['collective_bytes']:.3e}B "
          f"mem={rec['terms']['memory_s'] * 1e3:.3f}ms", flush=True)
    if s.n_l % 16 == 0:
        rec = lower_routing((16, 16), ("data", "model"),
                            (("B", "data"), ("L", "model")), caps, batch,
                            s.iters)
        out["cells"]["pod_BL2d"] = rec
        print(f"  [pod_BL2d] coll={rec['collective_bytes']:.3e}B "
              f"mem={rec['terms']['memory_s'] * 1e3:.3f}ms", flush=True)
    else:
        out["cells"]["pod_BL2d"] = {"status": "skip",
                                    "reason": f"N_L={s.n_l} % 16 != 0"}
    ok = {k: c for k, c in out["cells"].items()
          if c.get("status") == "ok" and k.startswith("pod")}
    if ok:
        out["pod_scale"]["best_measured"] = min(
            ok, key=lambda k: max(ok[k]["terms"].values()))
    return out


def full_capsnet_cell(cfg_name: str, batch: int) -> dict:
    """The whole CapsNet training step (conv + votes + routing + decoder +
    margin loss + SGD) as rank 0 of 256 data-parallel ranks: this rank's
    batch / 256 images, routing B-distributed on the torch backend (its
    (L, H) logit update summed over the ranks), the loss and each
    gradient averaged over the ranks (one all-reduce a leaf, as the
    reference's ``pmean``), then SGD at 0.01 in place."""
    from repro_torch.models import capsnet
    caps = CAPS_BENCHMARKS[cfg_name]
    local = batch // N_CHIPS
    rc = routing.RoutingConfig(iterations=caps.routing_iters,
                               axes=(("B", "vault"),))

    def build(mesh, device):
        net = capsnet.CapsNet(caps, device=device)
        params = dict(net.named_parameters())
        images = torch.empty((local, caps.image_hw, caps.image_hw,
                              caps.image_channels), device=device)
        labels = torch.empty((local,), dtype=torch.int32, device=device)

        def run():
            with mesh_utils.active(mesh):
                loss, _ = capsnet.loss_fn(net, images, labels,
                                          routing_cfg=rc,
                                          caps_conv=TRAIN_CAPS_CONV)
                loss = mesh_utils.psum(loss, "vault") / N_CHIPS
                grads = torch.autograd.grad(loss, list(params.values()))
                with torch.no_grad():
                    for p, g in zip(params.values(), grads):
                        p.sub_(0.01 * mesh_utils.psum(g, "vault")
                               / N_CHIPS)
            return loss.detach(), params
        return (params, images, labels), run

    rec = _record(*_trace((N_CHIPS,), ("vault",), build), N_CHIPS)
    return {"config": cfg_name, "batch": batch, "kind": "full_train_step",
            **rec}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/routing_dryrun")
    ap.add_argument("--configs", nargs="*",
                    default=["Caps-MN1", "Caps-EN3", "Caps-SV3"])
    ap.add_argument("--batch", type=int, default=POD_BATCH)
    ap.add_argument("--skip-full", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name in args.configs:
        print(f"[{name}]", flush=True)
        out = run_config(name, args.batch)
        if not args.skip_full:
            rec = full_capsnet_cell(name, args.batch)
            out["cells"]["pod_full_train"] = rec
            print(f"  [pod_full_train] peak={rec['peak_bytes'] / 2 ** 30:.2f}"
                  f"GiB coll={rec['collective_bytes']:.3e}B "
                  f"compute={rec['terms']['compute_s'] * 1e3:.2f}ms "
                  f"mem={rec['terms']['memory_s'] * 1e3:.2f}ms", flush=True)
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(out, f, indent=1)
        pod = out["pod_scale"]
        print(f"[{name}] paper32 planner={out['paper_scale']['planner_pick']}"
              f"  pod planner={pod['planner_pick']} "
              f"best_measured={pod.get('best_measured')}", flush=True)


if __name__ == "__main__":
    main()
