"""Sharded cases of the PyTorch port, run on one rank in-process or on
several CPU gloo ranks.

Each case is a function ``case(inputs, mesh) -> outputs`` of numpy arrays:
the inputs are whole (global) arrays, each rank takes its blocks, and the
outputs come back whole on every rank.  A test calls a case on a 1-rank
mesh in its own process, or writes ``<dir>/cases.json`` (entries ``{"name",
"case", "mesh": [shape, axes], "world"}``) and ``<dir>/<name>.npz`` and runs

    python tests/_torch_ranks.py <dir>

which starts ``world`` gloo ranks (``repro_torch.launch.ranks``: spawned
processes joined through a ``FileStore``, no network) for each run of
cases of one world size, runs them in order, and writes rank 0's outputs
to ``<dir>/<name>.out.npz``.  This file imports ``repro_torch`` and never the
JAX package: the tests compute the reference's values in their own
process and compare.

The gradient convention (``runtime.mesh_utils`` docstring): a loss that
every rank holds, seeded 1 on each, gives each rank's copy of a tensor a
share of n times its gradient; a case sums the shares over the ranks that
hold copies and divides by n.
"""
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from repro_torch import configs as C  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.ckpt import flatten, unflatten_like  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.runtime import mesh_utils, sharding  # noqa: E402

CPU = "cpu"


def _rows(x, rules):
    """This rank's rows of a global batch (split over the batch axes)."""
    ax = rules.axis("batch")
    n, r = rules.size(ax), rules.index(ax)
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]


def _gather_rows(x, rules):
    return mesh_utils.all_gather(x.detach(), rules.axis("batch"), 0,
                                 mesh=rules.mesh)


def _config(inputs):
    cfg = C.get_smoke_config(str(inputs["arch"]))
    if "attn_plan" in inputs:
        cfg = type(cfg)(**{**cfg.__dict__,
                           "attn_plan": str(inputs["attn_plan"])})
    return cfg


def _weights(inputs, cfg):
    flat = {k[2:]: v for k, v in inputs.items() if k.startswith("w/")}
    return convert.lm_params_from_jax(flat, cfg, device=CPU)


def _batch(inputs):
    return {k[2:]: v for k, v in inputs.items() if k.startswith("b/")}


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def case_loss_grads(inputs, mesh):
    """``lm.loss_fn`` under train rules and its whole-tree gradients."""
    cfg = _config(inputs)
    rules = sharding.make_rules(cfg, mesh, "train")
    params = lm.shard_params(_weights(inputs, cfg), cfg, rules)
    leaves = {k: p.requires_grad_(True) for k, p in flatten(params).items()}
    batch = {k: _rows(v, rules) for k, v in _batch(inputs).items()}
    loss, metrics = lm.loss_fn(unflatten_like(params, leaves), cfg, batch,
                               rules)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    grads = sharding.sync_grads(grads, sharding.param_held(cfg, rules),
                                rules)
    whole = flatten(lm.gather_params(unflatten_like(params, grads), cfg,
                                     rules))
    out = {f"g/{k}": v.numpy() for k, v in whole.items()}
    out.update(loss=loss.detach().numpy(), ce=metrics["ce"].detach().numpy(),
               moe_aux=metrics["moe_aux"].detach().numpy(),
               tokens=metrics["tokens"].numpy())
    return out


def case_train_step(inputs, mesh):
    """One ``make_train_step`` step over microbatches with compression."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import compression, train_loop
    cfg = _config(inputs)
    rules = sharding.make_rules(cfg, mesh, "train")
    n = int(inputs["microbatches"])
    params = lm.shard_params(_weights(inputs, cfg), cfg, rules)
    opt = adamw_init(flatten(params))
    step = train_loop.make_train_step(cfg, rules, opt_cfg=AdamWConfig(),
                                      num_microbatches=n, warmup=1,
                                      total_steps=10, compress_grads=True)
    # (n, mb, S) microbatches: this rank's rows of each
    batch = {k: torch.from_numpy(_rows(v.swapaxes(0, 1), rules)
                                 .swapaxes(0, 1).copy())
             for k, v in _batch(inputs).items()}
    fb = compression.init_error_feedback(flatten(params))
    params, opt, metrics, fb = step(params, opt, batch, fb)
    def whole(tree):
        return flatten(lm.gather_params(unflatten_like(params, tree), cfg,
                                        rules))
    out = {f"p/{k}": v.numpy() for k, v in whole(flatten(params)).items()}
    out.update({f"mu/{k}": v.numpy() for k, v in whole(opt.mu).items()})
    out.update({f"e/{k}": v.numpy() for k, v in whole(fb).items()})
    out.update({k: metrics[k].numpy() for k in ("loss", "grad_norm", "ce",
                                                "tokens")})
    return out


def case_xent(inputs, mesh):
    """``sharded_softmax_xent`` on the blocks of (B, S, V) logits: the
    per-token loss and the gradient of its sum."""
    rules = L.AxisRules({"batch": "data", "vocab": "model"}, mesh)
    logits = torch.from_numpy(inputs["logits"])
    V = logits.shape[-1]
    ax = L.vocab_axis(rules, V)
    lg = _rows(logits, rules)
    if ax is not None:
        v = V // rules.size(ax)
        lg = lg[..., rules.index(ax) * v:(rules.index(ax) + 1) * v]
    lg = lg.clone().requires_grad_(True)
    labels = _rows(torch.from_numpy(inputs["labels"]), rules)
    per_tok = L.sharded_softmax_xent(lg, labels, mesh if ax else None, ax)
    (g,) = torch.autograd.grad(per_tok.sum(), lg)
    # per_tok is held by every rank of the vocab axis: n copies seeded
    g = g / rules.size(rules.axis("vocab"))
    g = mesh_utils.all_gather(g, ax, -1, mesh=mesh)
    return {"loss": _gather_rows(per_tok, rules).numpy(),
            "grad": _gather_rows(g, rules).numpy()}


def case_flash_decode(inputs, mesh):
    """``attention_decode`` with the cache split over ``cache_seq``."""
    rules = L.AxisRules({"batch": "data", "cache_seq": "model"}, mesh)
    kw = json.loads(str(inputs["kw"]))
    p = {k[2:]: torch.tensor(v) for k, v in inputs.items()
         if k.startswith("p/")}
    ck, cv = (_rows(torch.tensor(inputs[k]), rules) for k in ("ck", "cv"))
    S = ck.shape[1]
    ax = rules.axis("cache_seq")
    s = S // rules.size(ax)
    ck, cv = (c[:, rules.index(ax) * s:(rules.index(ax) + 1) * s]
              for c in (ck, cv))
    with torch.no_grad():
        o, k, v = L.attention_decode(
            p, _rows(torch.from_numpy(inputs["x"]), rules), ck, cv,
            _rows(torch.from_numpy(inputs["pos"]), rules), rules=rules,
            s_total=S, **kw)
    return {"o": _gather_rows(o, rules).numpy(),
            "k": _gather_rows(k, rules).numpy(),
            "v": _gather_rows(v, rules).numpy()}


def case_moe(inputs, mesh):
    """``moe_forward(rules=...)``: experts over ``model``, tokens over
    ``data``."""
    rules = L.AxisRules({"batch": "data", "experts": "model"}, mesh)
    cfg = moe_lib.MoEConfig(*[float(v) if i == 4 else int(v)
                              for i, v in enumerate(inputs["cfg"])])
    E = cfg.n_shards_experts
    ax = L.local_axis(rules, "experts", E)
    e = E // rules.size(ax)
    p = {k: torch.tensor(inputs[k]) for k in ("router", "w_gate", "w_up",
                                              "w_down")}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = p[k][rules.index(ax) * e:(rules.index(ax) + 1) * e]
    with torch.no_grad():
        y, aux = moe_lib.moe_forward(p, _rows(torch.from_numpy(inputs["x"]),
                                              rules), cfg, rules=rules)
    return {"y": _gather_rows(y, rules).numpy(), "aux": aux.numpy()}


def case_routing_grads(inputs, mesh):
    """Differentiable torch-backend routing under a sharded plan: the
    output and the gradient of <output, w> for each global input."""
    from repro_torch.core.router import (ExecutionPlan, RouterSpec,
                                         build_router)
    spec = RouterSpec(algorithm=str(inputs["algorithm"]),
                      iterations=int(inputs["iterations"]),
                      differentiable=True)
    axis = mesh_utils.axis_names(mesh)[0]
    router = build_router(spec, ExecutionPlan(
        mesh=mesh, axes=((str(inputs["dim"]), axis),)), device=CPU)
    args = [torch.from_numpy(inputs[f"in{i}"]).requires_grad_(True)
            for i in range(int(inputs["n_in"]))]
    out = router(*args)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o * torch.from_numpy(inputs[f"w{i}"])).sum()
               for i, o in enumerate(outs))
    grads = torch.autograd.grad(loss, args)
    res = {f"out{i}": o.detach().numpy() for i, o in enumerate(outs)}
    res.update({f"grad{i}": g.numpy() for i, g in enumerate(grads)})
    return res


def case_resume(inputs, mesh):
    """Train two steps from ``resume_or_init`` and checkpoint them."""
    from repro_torch.runtime import elastic, train_loop
    cfg = _config(inputs)
    ckpt_dir = str(inputs["ckpt_dir"])
    params, opt, start, rules = elastic.resume_or_init(
        cfg, mesh, ckpt_dir, 0, "train", CPU)
    step = train_loop.make_train_step(cfg, rules)
    batch = {k: torch.from_numpy(_rows(v, rules))
             for k, v in _batch(inputs).items()}
    losses = []
    for _ in range(int(inputs["steps"])):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    elastic.save(ckpt_dir, start + len(losses), params, opt, cfg, rules)
    return {"start": np.array(start), "losses": np.array(losses)}


def case_collectives(inputs, mesh):
    """The collectives against their definitions and their backward
    formulas against the transposes: each rank's tensors are drawn from
    its global rank, so every rank rebuilds every rank's input and checks
    its output; and sum_r <A(x)_r, c_r> = sum_r <x_r, (A^T c)_r>, the
    right side by autograd (the adjoint identity of an exact
    transpose)."""
    import torch.distributed as dist
    me = dist.get_rank()
    grid = mesh.mesh                      # global ranks by coordinates
    i, j = (int(v) for v in (grid == me).nonzero()[0])
    seed = int(inputs["seed"])

    def draw(r, shape, salt):
        g = torch.Generator().manual_seed(seed + 1000 * salt + r)
        return torch.randn(shape, generator=g, dtype=torch.float64)

    xs = {int(r): draw(int(r), (4, 6), 0) for r in grid.flatten()}
    row = [int(r) for r in grid[i]]
    m, n = grid.shape
    ops = {
        "psum": (lambda x: mesh_utils.psum(x, "model", mesh=mesh),
                 sum(xs[r] for r in row)),
        "all_gather": (lambda x: mesh_utils.all_gather(x, "model", 0,
                                                       mesh=mesh),
                       torch.cat([xs[r] for r in row], 0)),
        "psum_scatter": (lambda x: mesh_utils.psum_scatter(
            x, "model", 0, mesh=mesh),
            sum(xs[r] for r in row).chunk(n, 0)[j]),
        "psum_all": (lambda x: mesh_utils.psum(x, ("data", "model"),
                                               mesh=mesh),
                     sum(xs.values())),
        "all_gather_all": (lambda x: mesh_utils.all_gather(
            x, ("data", "model"), 1, mesh=mesh),
            torch.cat([xs[int(r)] for r in grid.flatten()], 1)),
    }
    fwd, gap = 0.0, 0.0
    for k, (op, want) in enumerate(ops.values()):
        x = xs[me].clone().requires_grad_(True)
        with mesh_utils.active(mesh):
            y = op(x)
            c = draw(me, tuple(y.shape), k + 1)
            (g,) = torch.autograd.grad(y, x, c)
            sides = mesh_utils.psum(torch.stack([(y.detach() * c).sum(),
                                                 (x.detach() * g).sum()]),
                                    ("data", "model"))
        fwd = max(fwd, float((y.detach() - want).abs().max()))
        gap = max(gap, float((sides[0] - sides[1]).abs()))
    return {"fwd_err": np.array(fwd), "adjoint_gap": np.array(gap)}


def case_step_analysis(inputs, mesh):
    """One ``make_train_step`` step of ``inputs["arch"]``'s smoke config
    under ``launch.op_analysis.OpAnalysis`` on real tensors: this rank's
    collectives (calls and link bytes by kind) and the flash-attention
    wrappers' calls, counted around them (their plain versions run here),
    for the dry run's trace of the same cell."""
    from unittest import mock
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import train_loop
    cfg = C.get_smoke_config(str(inputs["arch"]))
    rules = sharding.make_rules(cfg, mesh, "train")
    params = lm.shard_params(lm.init_params(cfg, seed=0, device=CPU), cfg,
                             rules)
    opt = adamw_init(flatten(params))
    gen = torch.Generator().manual_seed(0)
    rows = int(inputs["batch"]) // rules.size(rules.axis("batch"))
    batch = {k: torch.randint(0, cfg.vocab, (rows, int(inputs["seq"])),
                              generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = train_loop.make_train_step(cfg, rules)
    calls = {}

    def counted(name):
        fn = getattr(fops, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return mock.patch.object(fops, name, wrapper)

    with counted("flash_attention_fwd_lse"), counted("flash_attention_bwd"):
        with OpAnalysis() as a:
            step(params, opt, batch)
    kinds = sorted(a.stats.collective_by_kind)
    return {"kinds": np.array(kinds),
            "bytes": np.array([a.stats.collective_by_kind[k] for k in kinds]),
            "calls": np.array([a.stats.collective_calls[k] for k in kinds]),
            "kernels": np.array(sorted(calls)),
            "kernel_calls": np.array([calls[k] for k in sorted(calls)])}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _run(argv):
    """One rank: the entries ``argv[1]`` (JSON) on the inputs in
    ``argv[0]``."""
    import torch.distributed as dist
    d, entries = argv[0], json.loads(argv[1])
    for entry in entries:
        shape, axes = entry["mesh"]
        mesh = mesh_utils.make_mesh(shape, axes, device=CPU)
        inputs = dict(np.load(os.path.join(d, f"{entry['name']}.npz")))
        out = CASES[entry["case"]](inputs, mesh)
        if dist.get_rank() == 0:
            np.savez(os.path.join(d, f"{entry['name']}.out.npz"), **out)


def main(d):
    """Run the cases of ``<d>/cases.json`` in order, one start of the
    ranks for each run of entries with the same world size."""
    from repro_torch.launch import ranks
    with open(os.path.join(d, "cases.json")) as f:
        entries = json.load(f)
    runs = []
    for entry in entries:
        if runs and runs[-1][0]["world"] == entry["world"]:
            runs[-1].append(entry)
        else:
            runs.append([entry])
    for run in runs:
        ranks.run(_run, [d, json.dumps(run)], run[0]["world"], CPU)


if __name__ == "__main__":
    main(sys.argv[1])
