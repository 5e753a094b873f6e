"""Training: a closed loop of the program's CapsNet train step
(``runtime.train_loop.make_capsnet_train_step``: the routing procedure
kernel and its recompute-b backward, the margin and reconstruction loss,
global-norm clipping, AdamW) at the configuration's batch.

Set-up builds the one train step with its model and optimizer state and
drives it from the seed through its first three steps, on batches whose
rows all differ; the same objects then run the window, in turn through a
pool of distinct batches made on the card, ``pool_batches`` long enough
that a window takes none twice (a window that cycles over a few batches
learns them by heart, and its margin loss then sits on its kinks, where a
rounding flips a term).  ``train_images_per_s`` is the images of every
step issued in the window over the time until the last step is done.

Correctness, twice.  The start: the reference trains the three set-up
steps from the same weights and batches.  After the window: the same step
object takes three more steps on the next batches of the pool, and the
reference takes them from the weights and AdamW moments that the window
left, and from the number of steps that the harness counted, so that a
step count or schedule that the window let go wrong shows.  Compared each time: each step's loss, the norm of each
leaf's first gradient as the optimizer received it (worked out from its
first moment before and after the first step), and the norm of each
leaf's change over the three steps; a leaf's gap is measured against the
larger of the reference's norm of that leaf and of the median leaf, and
leaves whose reference gradient is under a thousandth of the median
leaf's are left out.  Cell parameters: pool_batches, trace_from,
trace_s, and ``optimizer`` (lr, b1, b2, eps, weight_decay, max_grad_norm,
warmup, total_steps).
"""
from __future__ import annotations

import gc
import statistics
from typing import Dict, List

import torch

from perfbench.common import capsnet as caps
from perfbench.common.harness import Check, Outcome
from perfbench.reference import capsnet as ref

CHECKED_STEPS = 3
LEAF_FLOOR = 1e-3


def leaf_gap(program: Dict[str, torch.Tensor],
             reference: Dict[str, torch.Tensor],
             counted: List[str]) -> float:
    """The widest gap between a leaf's norm in the program and in the
    reference, over the larger of that leaf's reference norm and the
    median leaf's."""
    want = {k: float(torch.linalg.vector_norm(reference[k].float()))
            for k in counted}
    floor = statistics.median(want.values())
    return max(abs(float(torch.linalg.vector_norm(program[k].float()))
                   - want[k]) / max(want[k], floor) for k in counted)


def counted_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least LEAF_FLOOR of the median
    leaf's norm: the others move under Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= LEAF_FLOOR * med]


def compare(prog: dict, want: dict, w0: dict, limits: dict,
            prefix: str = "") -> List[Check]:
    """The three numbers of one run of CHECKED_STEPS steps from the weights
    ``w0``: ``prog`` holds the program's losses, first gradients and
    weights after, ``want`` the reference's."""
    counted = counted_leaves(want["first_grads"])
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], want["losses"]))
    change_p = {k: prog["params"][k] - w0[k] for k in counted}
    change_r = {k: want["params"][k] - w0[k] for k in counted}
    return [Check(prefix + "loss_gap", loss, limits[prefix + "loss_gap"]),
            Check(prefix + "grad_gap",
                  leaf_gap(prog["grads"], want["first_grads"], counted),
                  limits[prefix + "grad_gap"]),
            Check(prefix + "update_gap", leaf_gap(change_p, change_r, counted),
                  limits[prefix + "update_gap"])]


def program_steps(step, net, opt_state, batches, b1: float):
    """The program's step over ``batches``: returns (net, opt_state, its
    losses, each leaf's first gradient as AdamW received it, and the
    weights after the last step)."""
    mu0 = {k: m.detach().double() for k, m in opt_state.mu.items()}
    losses, grads = [], None
    for k, (images, labels) in enumerate(batches):
        net, opt_state, metrics = step(net, opt_state, images, labels)
        losses.append(metrics["loss"])
        if k == 0:
            grads = {name: (m.detach().double() - b1 * mu0[name]) / (1 - b1)
                     for name, m in opt_state.mu.items()}
    after = {name: t.detach().clone() for name, t in net.named_parameters()}
    return net, opt_state, {"losses": [float(x) for x in losses],
                            "grads": grads, "params": after}


def reference_checks(ctx, start: dict, late: dict,
                     tf32: bool = False) -> List[Check]:
    """Both comparisons with the reference: of the program's steps, or
    with ``tf32`` of the control's, the reference in TF32 in their
    place."""
    cfg, o = ctx.config, ctx.params["optimizer"]
    limits = ctx.cell.workload["limits"]
    checks = []
    for run_of, label in ((start, ""), (late, "late_")):
        want = ref.train(run_of["w0"], run_of["batches"], cfg, o,
                         start=run_of["state"])
        got = run_of["program"]
        if tf32:
            lower = ref.train(run_of["w0"], run_of["batches"], cfg, o,
                              tf32=True, start=run_of["state"])
            got = dict(lower, grads=lower["first_grads"])
        checks += compare(got, want, run_of["w0"], limits, label)
    return checks


def run(ctx) -> Outcome:
    p, cfg, dev = ctx.params, ctx.config, ctx.device
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train_loop import make_capsnet_train_step

    o = p["optimizer"]
    B = cfg["batch_size"]
    weights = caps.make_weights(cfg, ctx.seed, dev)
    w0 = {k: t.clone() for k, t in weights.items()}
    net = caps.build_net(cfg, weights, dev)
    del weights
    step = make_capsnet_train_step(
        caps.caps_config(cfg), spec=caps.router_spec(cfg),
        opt_cfg=AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                            weight_decay=o["weight_decay"]),
        max_grad_norm=o["max_grad_norm"], total_steps=o["total_steps"],
        warmup=o["warmup"], device=dev)
    opt_state = adamw_init(dict(net.named_parameters()))
    n_pool = p["pool_batches"]
    images = caps.make_images(cfg, n_pool * B, ctx.seed, "images", dev)
    labels = caps.make_labels(cfg, n_pool * B, ctx.seed, "labels", dev)
    batches = [(images[i * B:(i + 1) * B], labels[i * B:(i + 1) * B])
               for i in range(n_pool)]

    first = batches[:CHECKED_STEPS]
    net, opt_state, prog = program_steps(step, net, opt_state, first,
                                         o["b1"])
    start = {"w0": w0, "batches": first, "state": None, "program": prog}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    ctx.setup_done()
    t0 = ctx.clock()
    n, traced = CHECKED_STEPS, [None, None]
    untraced = (0, 0.0)
    # a traced run goes on until its trace is taken
    while (ctx.clock() - t0 < ctx.seconds
           or (ctx.tracer.enabled and traced[1] is None)):
        elapsed = ctx.clock() - t0
        if (ctx.tracer.enabled and traced[0] is None
                and elapsed >= p["trace_from"] * ctx.seconds):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            untraced = (n - CHECKED_STEPS, ctx.clock() - t0)
            ctx.tracer.start()
            traced[0], t_traced = n, ctx.clock()
        if (traced[0] is not None and traced[1] is None
                and ctx.clock() - t_traced >= p["trace_s"]):
            ctx.tracer.stop()
            traced[1] = n
        with ctx.tracer.span("step"):
            net, opt_state, metrics = step(net, opt_state,
                                           *batches[n % n_pool])
        n += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = ctx.clock()
    ctx.window_closed()

    # the window's own state goes on for CHECKED_STEPS more steps
    after = [batches[(n + k) % n_pool] for k in range(CHECKED_STEPS)]
    w_late = {k: t.detach().clone() for k, t in net.named_parameters()}
    state = ({k: m.clone() for k, m in opt_state.mu.items()},
             {k: m.clone() for k, m in opt_state.nu.items()}, n)
    net, opt_state, prog_late = program_steps(step, net, opt_state, after,
                                              o["b1"])
    late = {"w0": w_late, "batches": after, "state": state,
            "program": prog_late}

    steps = n - CHECKED_STEPS
    counters = {"steps": steps, "images": steps * B, "window_s": t1 - t0,
                "batch": B,
                "trace_steps": (traced[1] - traced[0]
                                if traced[0] is not None else 0),
                "pre_trace_images": untraced[0] * B,
                "pre_trace_s": untraced[1]}
    del step, net, opt_state, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = reference_checks(ctx, start, late)
    if ctx.control:
        ctx.control_checks = reference_checks(ctx, start, late, tf32=True)
    return Outcome({"train_images_per_s": steps * B / (t1 - t0)}, counters,
                   attempted=steps * B, failed=0, checks=checks)
