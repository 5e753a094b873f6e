"""End-to-end driver: train a CapsNet on the synthetic class-conditional
dataset with the full substrate — AdamW + schedule, routing-mode selection,
async checkpointing, straggler watchdog, step-indexed resume.

Port of the JAX package's ``examples/train_capsnet.py``, with the same
flags plus ``--device`` (the card by default; raises without one):

    PYTHONPATH=src python -m repro_torch.launch.train_capsnet --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train_capsnet --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train_capsnet --smoke \\
        --routing fused
    PYTHONPATH=src python -m repro_torch.launch.train_capsnet --smoke \\
        --steps 2 --device cpu

``--routing fused`` trains through the procedure kernel and its
recompute-b backward kernel (``RouterSpec(backend="cuda",
differentiable=True)``); ``exact`` and ``approx`` run autograd through the
torch routing path.  A second run with the same ``--ckpt-dir`` resumes
from its latest checkpoint, which is written in the reference's format
(``convert.capsnet_to_jax``).  ``main`` returns what it prints: the step
it resumed from (0 for a fresh run), each step's loss and accuracy, and the
eval accuracy; ``examples/torch_train_capsnet.py`` is this driver.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import checkpoint as ck
from repro_torch import convert
from repro_torch.configs.caps_benchmarks import smoke_caps
from repro_torch.core.router import RouterSpec, build_router
from repro_torch.data.synthetic import (SyntheticCapsDataset,
                                        caps_batch_iterator)
from repro_torch.kernels import resolve_device
from repro_torch.models import capsnet
from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine
from repro_torch.runtime.straggler import Prefetcher, StepWatchdog
from repro_torch.runtime.train_loop import apply_adamw_


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_capsnet_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--routing", choices=("exact", "approx", "fused"),
                    default="exact")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: a dozen steps, one tiny eval batch")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps = min(args.steps, 12)
        args.ckpt_every = min(args.ckpt_every, 6)
    device = resolve_device(args.device)

    cfg = smoke_caps()
    router = build_router(RouterSpec(
        iterations=cfg.routing_iters,
        use_approx=args.routing == "approx",
        backend="cuda" if args.routing == "fused" else "torch",
        differentiable=args.routing == "fused"), device=device)
    ocfg = AdamWConfig(lr=1e-3, weight_decay=0.0)

    net = capsnet.CapsNet(cfg, device=device, seed=0)
    start = ck.latest_step(args.ckpt_dir)
    if start is not None:
        tree = ck.load_checkpoint(args.ckpt_dir, start,
                                  convert.capsnet_to_jax(net))
        net = convert.capsnet_from_jax(tree, cfg, device=device)
        print(f"resumed from step {start}")
    start = start or 0
    params = dict(net.named_parameters())
    opt = adamw_init(params)

    ds = SyntheticCapsDataset(cfg.image_hw, cfg.image_channels,
                              cfg.num_h_caps)
    data = Prefetcher(caps_batch_iterator(ds, cfg.batch_size,
                                          start_step=start), depth=2)
    ckpt = ck.AsyncCheckpointer(args.ckpt_dir, keep=2)
    watchdog = StepWatchdog(
        on_slow=lambda s, dt, med: print(
            f"  [watchdog] step {s} took {dt:.2f}s (median {med:.2f}s)"))

    losses, accuracies = {}, {}
    for i in range(start, args.steps):
        b = next(data)
        watchdog.start(i)
        images = torch.from_numpy(b["images"]).to(device)
        labels = torch.from_numpy(b["labels"]).to(device)
        loss, m = capsnet.loss_fn(net, images, labels, router=router)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        lr_scale = linear_warmup_cosine(i + 1, 20, args.steps)
        opt = apply_adamw_(params, grads, opt, ocfg, lr_scale)
        watchdog.stop()
        losses[i + 1] = float(loss.detach())
        accuracies[i + 1] = float(m["accuracy"])
        if (i + 1) % (4 if args.smoke else 20) == 0:
            print(f"step {i + 1:4d}  loss {losses[i + 1]:.4f}  "
                  f"acc {accuracies[i + 1]:.3f}")
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, convert.capsnet_to_jax(net))
    ckpt.wait()

    # final eval
    hits = n = 0
    eval_batches, eval_bs = (1, 32) if args.smoke else (4, 64)
    with torch.no_grad():
        for j in range(1000, 1000 + eval_batches):
            b = ds.batch(j, eval_bs)
            out = capsnet.forward(net, torch.from_numpy(b["images"]).to(
                device), router=router)
            hits += int((torch.argmax(out["class_probs"], -1).cpu()
                         == torch.from_numpy(b["labels"]).long()).sum())
            n += eval_bs
    print(f"eval accuracy ({args.routing} routing): {hits / n:.4f}")
    return {"start": start, "steps": args.steps, "routing": args.routing,
            "losses": losses, "accuracies": accuracies,
            "eval_accuracy": hits / n}


if __name__ == "__main__":
    main()
