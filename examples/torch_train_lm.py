"""End-to-end LM training on the PyTorch/CUDA port, on the H100
(``--device cpu`` for the CPU): train the reduced (smoke) config of any
assigned architecture for a few hundred steps on the synthetic bigram LM
dataset — cross-entropy must fall.  Exercises the training substrate:
gradient accumulation over microbatches, clipping, the schedule,
checkpoints and a step-indexed resume.

The twin of ``train_lm.py``.  The step updates the parameters and the
optimizer state in place; a checkpoint holds the parameters, written every
``--ckpt-every`` steps, and a second run with the same ``--ckpt-dir``
resumes from the latest one with the batches of the steps that follow.

    PYTHONPATH=src python examples/torch_train_lm.py --arch granite-3-2b \\
        --steps 100
    PYTHONPATH=src python examples/torch_train_lm.py --arch mixtral-8x7b \\
        --steps 60
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu
"""
import argparse

import torch

from repro_torch import checkpoint as ck
from repro_torch import configs as C
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.kernels import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import train_loop
from repro_torch.runtime.straggler import StepWatchdog


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=C.list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = C.get_smoke_config(args.arch)
    params, opt = train_loop.init_train_state(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in ck.flatten(params).values())
    print(f"{cfg.name}: {n_params / 1e6:.2f}M params "
          f"(family={cfg.family})")

    start = 0
    if args.ckpt_dir:
        s0 = ck.latest_step(args.ckpt_dir)
        if s0 is not None:
            params = ck.load_checkpoint(args.ckpt_dir, s0, params)
            start = s0
            print(f"resumed from step {start}")

    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq)
    step = train_loop.make_train_step(
        cfg, opt_cfg=AdamWConfig(lr=3e-4, weight_decay=0.01),
        num_microbatches=args.microbatches, total_steps=args.steps,
        warmup=10)
    watchdog = StepWatchdog()

    def to_micro(b):
        n, bs = args.microbatches, args.batch
        lead = (n, bs // n) if n > 1 else (bs,)
        out = {k: torch.from_numpy(v).to(dev).reshape(*lead, *v.shape[1:])
               for k, v in b.items()}
        if cfg.family == "vlm":
            out["image_embeds"] = torch.zeros(
                (*lead, cfg.n_img_tokens, cfg.d_model), device=dev)
        if cfg.enc_dec:
            out["frames"] = torch.zeros(
                (*lead, cfg.source_len, cfg.d_model), device=dev)
        return out

    losses = {}
    for i in range(start, args.steps):
        batch = to_micro(ds.batch(i, args.batch))
        watchdog.start(i)
        params, opt, metrics = step(params, opt, batch)
        watchdog.stop()
        losses[i + 1] = float(metrics["loss"])
        if (i + 1) % 20 == 0:
            print(f"step {i + 1:4d}  loss {losses[i + 1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ck.save_checkpoint(args.ckpt_dir, i + 1, params)

    first, final = losses[start + 1], losses[args.steps]
    print(f"loss: {first:.4f} -> {final:.4f} "
          f"({'fell' if final < first else 'DID NOT FALL'})")
    return {"arch": cfg.name, "device": str(dev), "start": start,
            "losses": losses, "fell": final < first}


if __name__ == "__main__":
    main()
