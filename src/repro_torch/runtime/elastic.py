"""Elastic capacity: scale decisions for serving fleets, and training
resumed on a mesh of another size.

Port of the JAX package's ``repro/runtime/elastic.py``.
``ElasticController`` is the hysteresis state machine behind
``runtime.caps_fleet``'s replica scale-up/down — pure decision logic (no
threads) fed per-tick observations of queue depth and wave-latency
percentiles (``straggler.StepWatchdog``).

``resume_or_init`` restores the latest checkpoint onto a mesh (each rank
reads its blocks of every leaf) or draws fresh weights; ``save`` writes
one.  A checkpoint holds whole leaves under the keys the training CLI
writes (``params/<path>``, ``opt/.step``, ``opt/.mu/<path>``,
``opt/.nu/<path>``), so it moves between meshes of any size and between
the two packages.  (The reference's ``resume_or_init`` reads bare
parameter keys, which its own CLI does not write.)  ``rebatch_for_mesh``
re-derives a microbatch count after a mesh-size change.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.checkpoint.ckpt import flatten, unflatten_like
from repro_torch.kernels import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import AxisRules, dim_axis
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import mesh_utils, sharding


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """When to grow/shrink a replica fleet.

    Backlog is measured in *waves per replica* (queued requests /
    (replicas · wave_lanes)) so thresholds are capacity-relative:

    scale_up_backlog:   grow when backlog exceeds this many waves per
                        replica for ``up_patience`` consecutive ticks.
    scale_down_backlog: shrink when backlog stays below this for
                        ``down_patience`` consecutive ticks.
    slow_p90_factor:    a p90 wave latency above ``factor × median`` also
                        counts as an up-signal (straggler pressure — the
                        queue looks fine but waves are stalling; the
                        paper's "intensive synchronization" failure mode
                        surfacing as latency, not depth).
    """
    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_backlog: float = 1.5
    scale_down_backlog: float = 0.25
    up_patience: int = 2
    down_patience: int = 3
    slow_p90_factor: float = 3.0

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas; got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.scale_down_backlog >= self.scale_up_backlog:
            raise ValueError("scale_down_backlog must be < scale_up_backlog "
                             f"(hysteresis); got {self.scale_down_backlog} "
                             f">= {self.scale_up_backlog}")


class ElasticController:
    """Hysteresis state machine: consecutive-tick patience on both edges so
    one bursty arrival never flaps the fleet.

        HOLD --(backlog > up for up_patience ticks, n < max)--> UP
        HOLD --(backlog < down for down_patience ticks, n > min)--> DOWN

    ``observe()`` returns "up" | "down" | "hold"; the caller (the fleet's
    controller thread) starts or drains a replica and keeps ticking.  Every
    decision is recorded in ``events`` with its observation snapshot —
    the bench's elasticity provenance.
    """

    def __init__(self, policy: Optional[ElasticPolicy] = None):
        self.policy = policy if policy is not None else ElasticPolicy()
        self._up_ticks = 0
        self._down_ticks = 0
        self.events: List[dict] = []

    def observe(self, n_replicas: int, queued: int, wave_lanes: int,
                p90_s: Optional[float] = None,
                median_s: Optional[float] = None) -> str:
        """One controller tick: backlog + latency in, decision out."""
        pol = self.policy
        backlog = queued / max(1, n_replicas * wave_lanes)
        slow = (p90_s is not None and median_s is not None and median_s > 0
                and p90_s > pol.slow_p90_factor * median_s)
        if backlog > pol.scale_up_backlog or slow:
            self._up_ticks += 1
            self._down_ticks = 0
        elif backlog < pol.scale_down_backlog:
            self._down_ticks += 1
            self._up_ticks = 0
        else:
            self._up_ticks = self._down_ticks = 0
        decision = "hold"
        if (self._up_ticks >= pol.up_patience
                and n_replicas < pol.max_replicas):
            decision = "up"
        elif (self._down_ticks >= pol.down_patience
                and n_replicas > pol.min_replicas):
            decision = "down"
        if decision != "hold":
            self._up_ticks = self._down_ticks = 0
            self.events.append({"decision": decision,
                                "n_replicas": n_replicas,
                                "queued": queued,
                                "backlog_waves": backlog,
                                "p90_s": p90_s, "median_s": median_s})
        return decision

    def note(self, decision: str, **snapshot) -> None:
        """Record an externally-applied capacity event in ``events`` —
        e.g. the fleet health check restarting a dead replica
        ("restart", DESIGN.md §Faults) — so the scale-event log stays the
        single provenance stream for every capacity change, and resets the
        hysteresis counters (the fleet just changed size out from under
        them)."""
        self._up_ticks = self._down_ticks = 0
        self.events.append({"decision": decision, **snapshot})


# ---------------------------------------------------------------------------
# training on a mesh: checkpoints, resume, rebatching
# ---------------------------------------------------------------------------

def checkpoint_tree(params, opt: AdamWState) -> dict:
    """The tree the training CLI saves (the reference CLI's): ``{"params":
    params, "opt": opt}``, the AdamWState's fields under its ``.step``/
    ``.mu``/``.nu`` path keys, the moments nested like the parameters."""
    return {"params": params,
            "opt": {".step": opt.step,
                    ".mu": unflatten_like(params, opt.mu),
                    ".nu": unflatten_like(params, opt.nu)}}


def save(directory: str, step: int, params, opt: AdamWState,
         cfg: lm.ArchConfig, rules: AxisRules) -> None:
    """Write a checkpoint of whole leaves from every rank's blocks (a
    collective: every rank calls it; the default group's rank 0 writes)."""
    def whole(tree):
        return flatten(lm.gather_params(unflatten_like(params, tree), cfg,
                                        rules))
    full = lm.gather_params(params, cfg, rules)
    opt = AdamWState(step=opt.step, mu=whole(opt.mu), nu=whole(opt.nu))
    if not dist.is_initialized() or dist.get_rank() == 0:
        ckpt_lib.save_checkpoint(directory, step, checkpoint_tree(full, opt))
    if dist.is_initialized():
        dist.barrier()


def _read_blocks(directory: str, step: int, like: dict, prefix: str,
                 cfg: lm.ArchConfig, rules: AxisRules) -> dict:
    """This rank's blocks of the leaves ``prefix/<path>`` of a checkpoint,
    shaped, typed and placed like ``like`` (a whole-leaf meta tree)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    axes = flatten(lm.param_logical_axes(cfg))
    out = {}
    for key, t in flatten(like).items():
        name = f"{prefix}/{key}"
        if name not in manifest:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = np.load(os.path.join(path, manifest[name]["file"]),
                      mmap_mode="r")
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: ckpt {arr.shape} "
                             f"vs {tuple(t.shape)}")
        for d, (a, n) in enumerate(zip(axes[key], arr.shape)):
            ax = dim_axis(rules, a, n)
            if ax is not None:
                c = n // rules.size(ax)
                arr = arr[(slice(None),) * d
                          + (slice(rules.index(ax) * c,
                                   (rules.index(ax) + 1) * c),)]
        out[key] = torch.from_numpy(np.array(arr))
    return out


def resume_or_init(cfg: lm.ArchConfig, mesh, ckpt_dir: str, seed: int = 0,
                   mode: str = "train", device="cuda"
                   ) -> Tuple[dict, AdamWState, int, AxisRules]:
    """(params, opt_state, start_step, rules) on ``mesh``: this rank's
    blocks of the latest checkpoint in ``ckpt_dir``, or of fresh weights
    drawn from ``seed`` where there is none (the same draw on every
    rank)."""
    rules = sharding.make_rules(cfg, mesh, mode)
    step = ckpt_lib.latest_step(ckpt_dir) if ckpt_dir else None
    if step is None:
        params = lm.shard_params(lm.init_params(cfg, seed, device), cfg,
                                 rules)
        return params, adamw_init(flatten(params)), 0, rules
    dev = resolve_device(device)
    meta = lm.init_params(cfg, device="meta")
    flat = _read_blocks(ckpt_dir, step, meta, "params", cfg, rules)
    params = unflatten_like(meta, {
        k: v.to(device=dev, dtype=t.dtype)
        for (k, v), t in zip(flat.items(), flatten(meta).values())})
    mu = _read_blocks(ckpt_dir, step, meta, "opt/.mu", cfg, rules)
    nu = _read_blocks(ckpt_dir, step, meta, "opt/.nu", cfg, rules)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        opt_step = np.load(os.path.join(
            path, json.load(f)["leaves"]["opt/.step"]["file"]))
    opt = AdamWState(
        step=torch.as_tensor(opt_step, dtype=torch.int32, device=dev),
        mu={k: v.to(dev, torch.float32) for k, v in mu.items()},
        nu={k: v.to(dev, torch.float32) for k, v in nu.items()})
    return params, opt, step, rules


def rebatch_for_mesh(global_batch: int, mesh,
                     prev_microbatches: int) -> int:
    """Re-derive a valid microbatch count after a mesh-size change."""
    dp = mesh_utils.dp_size(mesh)
    n = prev_microbatches
    while n > 1 and (global_batch // n) % dp:
        n -= 1
    while (global_batch // n) % dp and n <= global_batch:
        n += 1
    return n
