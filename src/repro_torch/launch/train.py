"""LM training launcher.

Port of the JAX package's ``repro/launch/train.py``: the
config, step-indexed synthetic data with prefetch, gradient accumulation
over microbatches, optional int8 gradient compression with error feedback,
async checkpointing in the reference's format, resume from the latest
checkpoint, and the straggler watchdog.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 100 --global-batch 8 --seq 1024 --ckpt-dir /path/to/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \\
        --smoke --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
        --smoke --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-large-v2 --smoke --steps 3 --device cpu

The MoE family (qwen3-moe-30b-a3b, mixtral-8x7b) trains with the
load-balance aux term in the loss, and each report line gives it;
``--layers N`` cuts the full config's depth to N layers (the full width
of a large model does not fit one card with its AdamW state at full
depth).  A hybrid (zamba2-7b) keeps its structure under the cut: N // 6
super-blocks of 6 Mamba-2 layers and the shared attention block, and the
N % 6 left over as its tail; an encoder-decoder's encoder is cut to at
most N layers too (``configs.with_layers``).  The VLM and the
encoder-decoder train on each batch's stub inputs beside its tokens
(``data.synthetic.modality_stubs``, seeded by the step: zero image
embeddings, whose positions the loss masks, and normal frames), where the
reference's CLI gives seamless no frames and fails.

The card is the default device (``--device cpu`` runs the kernels' plain
versions).  A checkpoint holds ``{"params": ..., "opt": AdamWState}`` keyed
as the reference writes it (``opt/.step``, ``opt/.mu/<path>``,
``opt/.nu/<path>``), every ``--ckpt-every`` steps and at the last step; a
second run with the same ``--ckpt-dir`` resumes at its latest step.
``--compress-grads`` threads the error-feedback tree through the step and
unpacks its four results (the reference's CLI calls its step without one,
so its compression never runs and the step's four results meet a
three-way unpack); the error feedback starts at zero on resume.

``--mesh d,m`` (or ``p,d,m``: pod, data, model) trains under the train
sharding rules (``runtime.sharding.make_rules``) on a ``DeviceMesh`` of
that shape.  Run alone, the CLI starts the mesh's ranks itself
(``launch.ranks.run``: NCCL with a card a rank, gloo for ranks sharing a
card or on the CPU) and returns rank 0's start, steps and losses, as the
reference's ``--mesh`` just runs on the devices it sees; in a process
group of the mesh's size it trains on that group, and in a group of
another size it raises.  Started as N ranks without ``--mesh`` (``python
-m repro_torch.launch.ranks -n N ...``) it trains on an (N, 1) data ×
model mesh, the reference's default.  Each rank trains on its blocks of
the parameters and its rows of each global batch, and rank 0 prints;
with ``--ckpt-dir`` it resumes through ``runtime.elastic.resume_or_init``,
which reads a checkpoint of whole leaves into any mesh's blocks (so a
run may resume onto another mesh), and ``runtime.elastic.save`` writes
one.  The reference's LIBTPU/XLA flags have no counterpart.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
        --mesh 2,2 --device cpu --ckpt-dir /path/to/ckpt
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ck
from repro_torch import configs as C
from repro_torch.data.synthetic import (SyntheticLMDataset,
                                        lm_batch_iterator, modality_stubs)
from repro_torch.kernels import resolve_device
from repro_torch.launch import ranks
from repro_torch.optim import AdamWConfig, AdamWState
from repro_torch.runtime import (compression, elastic, mesh_utils,
                                 sharding, train_loop)
from repro_torch.runtime.elastic import checkpoint_tree
from repro_torch.runtime.straggler import Prefetcher, StepWatchdog

MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def mesh_shape(spec: str) -> tuple:
    """``--mesh``'s shape."""
    shape = tuple(int(v) for v in spec.split(","))
    if len(shape) not in MESH_AXES or min(shape) < 1:
        raise ValueError(f"--mesh takes d,m or p,d,m; got {spec!r}")
    return shape


def summary(result: dict) -> dict:
    """What crosses back from rank 0 when the CLI starts its ranks itself:
    rank 0's parameters and optimizer state are its blocks, not the
    model's, and stay with the rank."""
    return {k: result[k] for k in ("start", "steps", "losses")}


def restore(directory: str, step: int, params, opt: AdamWState):
    """(params, opt) from ``directory``'s checkpoint at ``step``, shaped,
    typed and placed like the given ones."""
    tree = ck.load_checkpoint(directory, step, checkpoint_tree(params, opt))
    o = tree["opt"]
    return tree["params"], AdamWState(step=o[".step"],
                                      mu=ck.flatten(o[".mu"]),
                                      nu=ck.flatten(o[".nu"]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=C.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU dev loop)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="",
                    help="comma mesh shape d,m or p,d,m over the caller's "
                         "process group")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    n = args.microbatches
    if n < 1 or args.global_batch % n:
        raise ValueError(f"--global-batch {args.global_batch} does not split "
                         f"into {n} microbatches")
    device = resolve_device(args.device)
    world = ranks.world_size()
    if args.mesh:
        shape = mesh_shape(args.mesh)
        if math.prod(shape) != world:
            if world > 1:
                raise ValueError(f"--mesh {args.mesh} holds "
                                 f"{math.prod(shape)} ranks; the process "
                                 f"group has {world}")
            return ranks.run(main, sys.argv[1:] if argv is None else argv,
                             math.prod(shape), device, keep=summary)
    elif world > 1:
        shape = (world, 1)
        args.mesh = f"{world},1"
    say = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    cfg = C.get_smoke_config(args.arch) if args.smoke \
        else C.get_config(args.arch)
    if args.layers:
        if not 1 <= args.layers <= cfg.n_layers:
            raise ValueError(f"--layers {args.layers} outside 1.."
                             f"{cfg.n_layers}")
        cfg = C.with_layers(cfg, args.layers)
    rules, rows = None, slice(None)
    if args.mesh:
        mesh = mesh_utils.make_mesh(shape, MESH_AXES[len(shape)], device)
        sharding.batch_shape_check(cfg, mesh, args.global_batch, "train")
        params, opt, start, rules = elastic.resume_or_init(
            cfg, mesh, args.ckpt_dir, 0, "train", device)
        per = args.global_batch // n // rules.size(rules.axis("batch"))
        r = rules.index(rules.axis("batch"))
        rows = slice(r * per, (r + 1) * per)
        say(f"mesh {args.mesh} | {cfg.name} on {device} | "
            f"layers={cfg.n_layers} | dp={mesh_utils.dp_size(mesh)} | "
            f"microbatches={n}")
    else:
        say(f"{cfg.name} on {device} | layers={cfg.n_layers} | "
            f"microbatches={n}")
        params, opt = train_loop.init_train_state(cfg, seed=0, device=device)
        start = 0
        latest = ck.latest_step(args.ckpt_dir) if args.ckpt_dir else None
        if latest is not None:
            params, opt = restore(args.ckpt_dir, latest, params, opt)
            start = latest
    if start:
        say(f"resumed at step {start}")

    step_fn = train_loop.make_train_step(
        cfg, rules, opt_cfg=AdamWConfig(lr=args.lr), num_microbatches=n,
        total_steps=args.steps, compress_grads=args.compress_grads)
    error_fb = compression.init_error_feedback(ck.flatten(params)) \
        if args.compress_grads else None

    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq)
    data = Prefetcher(lm_batch_iterator(ds, args.global_batch,
                                        start_step=start), depth=2)
    ckpt = ck.AsyncCheckpointer(args.ckpt_dir, keep=3) \
        if args.ckpt_dir and rules is None else None

    def save(step):
        if rules is not None:
            elastic.save(args.ckpt_dir, step, params, opt, cfg, rules)
        else:
            ckpt.save(step, checkpoint_tree(params, opt))
    wd = StepWatchdog(on_slow=lambda s, dt, med: say(
        f"[watchdog] step {s}: {dt:.2f}s (median {med:.2f}s)"))

    def to_device(b, step):
        b = {**b, **modality_stubs(cfg, args.global_batch, seed=step)}
        out = {}
        for k, v in b.items():
            t = torch.from_numpy(v).to(device)
            t = t.reshape(n, args.global_batch // n, *t.shape[1:])[:, rows]
            out[k] = t if n > 1 else t[0]
        return out

    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        wd.start(i)
        if args.compress_grads:
            params, opt, metrics, error_fb = step_fn(
                params, opt, to_device(next(data), i), error_fb)
        else:
            params, opt, metrics = step_fn(params, opt,
                                           to_device(next(data), i))
        losses.append(float(metrics["loss"]))
        wd.stop()
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            aux = (f"moe_aux {float(metrics['moe_aux']):.4f}  "
                   if cfg.family == "moe" else "")
            say(f"step {i + 1:5d}  loss {losses[-1]:.4f}  {aux}"
                f"gnorm {float(metrics['grad_norm']):.2f}  "
                f"{(i + 1 - start) / (time.time() - t0):.2f} it/s")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save(i + 1)
    if args.ckpt_dir:
        if args.steps > start and args.steps % args.ckpt_every:
            save(args.steps)
        if ckpt:
            ckpt.wait()
    say("done")
    return {"start": start, "steps": args.steps, "losses": losses,
            "params": params, "opt": opt}


if __name__ == "__main__":
    main()
