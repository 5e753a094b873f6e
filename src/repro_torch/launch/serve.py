"""LM serving launcher: batched greedy generation.

Port of the JAX package's ``repro/launch/serve.py``: random weights from a
seed, synthetic prompts from numpy, and ``runtime.serve_loop.generate``
over groups of ``--batch`` requests.  It serves on one rank a card: run
alone on a host of several cards with ``--device cuda`` (no index) it
starts a rank on each (``launch.ranks``), as the reference serves on every
device it sees; ``--device cuda:k`` serves on card k alone.  Under the
launcher (``python -m repro_torch.launch.ranks -n N ...``) it serves on
the launcher's N ranks.  On more than one rank, when ``--batch`` splits
over them, a full group is served under the decode sharding rules on an
(N, 1) data × model mesh: each rank generates its rows, its cache split
by the flash-decoding plan, and the rows are gathered over the data axis.
A group that does not split (a last group shorter than ``--batch``, or
every group when ``--batch`` is no multiple of N) is served whole on every
rank with no rules, as the reference serves every group, so that no rank
holds no rows and nothing couples the group's rows to pad rows (an MoE's
capacity counts every token of the batch).  Every rank returns and prints
every request, and the tokens are those of the 1-rank run.  The
dense (granite-3-2b, phi3-medium-14b, mistral-large-123b, stablelm-12b),
Mamba-1 (falcon-mamba-7b), MoE (qwen3-moe-30b-a3b, and mixtral-8x7b with
its sliding window: a cache of min(prompt + generated, window) slots that
rolls), hybrid (zamba2-7b: Mamba-2 layers and one shared attention
block, a KV cache a super-block), VLM (llava-next-mistral-7b) and
encoder-decoder (seamless-m4t-large-v2) architectures run.  The stub
frontends' inputs are built as the reference's CLI builds them
(``data.synthetic.modality_stubs``): zero image embeddings (n_img_tokens ×
d_model a request, before the text) and standard normal frames (source_len
× d_model a request, from numpy seed 1000).  ``--layers N`` cuts the
decoder to N layers, and an encoder-decoder's encoder to at most N
(``configs.with_layers``).

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --requests 8
    PYTHONPATH=src python -m repro_torch.launch.ranks -n 2 \\
        repro_torch.launch.serve --smoke --requests 6 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-30b-a3b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
        --smoke --prompt-len 40 --gen 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llava-next-mistral-7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless-m4t-large-v2 --smoke --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as C
from repro_torch.data.synthetic import modality_stubs
from repro_torch.kernels import resolve_device
from repro_torch.launch import ranks
from repro_torch.models import lm
from repro_torch.models.layers import NO_RULES
from repro_torch.runtime import mesh_utils, serve_loop, sharding


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=C.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs; the card by default")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if (not dist.is_initialized() and device.type == "cuda"
            and device.index is None and torch.cuda.device_count() > 1):
        return ranks.run(main, sys.argv[1:] if argv is None else argv,
                         torch.cuda.device_count(), device)

    cfg = C.get_smoke_config(args.arch) if args.smoke \
        else C.get_config(args.arch)
    if args.layers:
        if not 1 <= args.layers <= cfg.n_layers:
            raise ValueError(f"--layers {args.layers} outside 1.."
                             f"{cfg.n_layers}")
        cfg = C.with_layers(cfg, args.layers)
    params = lm.init_params(cfg, seed=0, device=device)
    n = ranks.world_size()
    split = n > 1 and args.batch % n == 0
    rules, rows = NO_RULES, slice(None)
    if split:
        mesh = mesh_utils.make_mesh((n, 1), ("data", "model"), device)
        rules = sharding.make_rules(cfg, mesh, "decode")
        params = lm.shard_params(params, cfg, rules)
        per = args.batch // n
        rows = slice(dist.get_rank() * per, (dist.get_rank() + 1) * per)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (args.requests, args.prompt_len), dtype=np.int32)
    stubs = modality_stubs(cfg, args.requests, seed=1000)

    t0 = time.perf_counter()
    results = []
    for lo in range(0, args.requests, args.batch):
        group = {k: v[lo:lo + args.batch]
                 for k, v in {"tokens": prompts, **stubs}.items()}
        if not split:       # one rank, or a --batch that does not split
            out, _ = serve_loop.generate(params, cfg, group, args.gen)
        elif len(group["tokens"]) == args.batch:
            mine = {k: v[rows] for k, v in group.items()}
            out, _ = serve_loop.generate(params, cfg, mine, args.gen, rules)
            out = mesh_utils.all_gather(out, "data", 0, mesh=mesh)
        else:               # the short last group, whole on every rank
            out, _ = serve_loop.generate(
                lm.gather_params(params, cfg, rules), cfg, group, args.gen)
        results.extend(out.cpu().numpy())
    dt = time.perf_counter() - t0
    total = sum(len(r) for r in results)
    where = (torch.cuda.get_device_name(params["embed"]["tok"].device)
             if params["embed"]["tok"].is_cuda else "the CPU")
    print(f"{cfg.name}: served {args.requests} requests ({total} tokens) "
          f"in {dt:.1f}s ({total / dt:.0f} tok/s on {where})")
    for i, r in enumerate(results[:3]):
        print(f"  request {i}: {r[:12].tolist()}")
    return {"requests": args.requests, "tokens": total, "seconds": dt,
            "results": results}


if __name__ == "__main__":
    main()
