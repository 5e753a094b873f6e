"""LM serving on the PyTorch/CUDA port: batched prefill + greedy decode
with KV/SSM caches for any assigned architecture (its reduced smoke
config), on the H100 (``--device cpu`` for the CPU) — the inference-side
end-to-end example.

The twin of ``serve_lm.py``.  The port runs eagerly (no ``jit``), and
``decode_step`` writes the caches in place, so the determinism check
decodes twice from two copies of one state.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch mixtral-8x7b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch falcon-mamba-7b
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.data.synthetic import modality_stubs
from repro_torch.kernels import resolve_device
from repro_torch.models import lm


def _copy(tree):
    """A copy of a decode state's tensors (tuples and NamedTuples of them)."""
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [_copy(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return tree


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=C.list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = C.get_smoke_config(args.arch)
    params = lm.init_params(cfg, seed=0, device=dev)
    max_len = args.prompt_len + args.gen

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in {
        "tokens": prompts, **modality_stubs(cfg, args.batch)}.items()}
    if cfg.family == "vlm":
        max_len += cfg.n_img_tokens

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        t0 = time.perf_counter()
        logits, state = lm.prefill(params, cfg, batch, max_len=max_len)
        sync()
        t_prefill = time.perf_counter() - t0

        tok = logits.argmax(-1)[:, None].int()
        generated = [tok]
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, state = lm.decode_step(params, cfg, state, tok)
            tok = logits.argmax(-1)[:, None].int()
            generated.append(tok)
        sync()
        t_decode = time.perf_counter() - t0

        out = torch.cat(generated, dim=1).cpu()
        toks_per_s = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
        print(f"{cfg.name}: prefill({args.batch}x{args.prompt_len}) "
              f"{t_prefill * 1e3:.1f}ms; decode {args.gen - 1} steps "
              f"{t_decode * 1e3:.1f}ms ({toks_per_s:.0f} tok/s on {dev})")
        print("sample continuation (request 0):", out[0, :16].tolist())
        # sanity: decode must be deterministic given the cache
        logits2, _ = lm.decode_step(params, cfg, _copy(state), tok)
        logits3, _ = lm.decode_step(params, cfg, _copy(state), tok)
        assert torch.allclose(logits2, logits3), "decode must be pure"
        print("decode determinism check passed")
    return {"arch": cfg.name, "device": str(dev), "tokens": out,
            "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
            "tokens_per_s": toks_per_s, "deterministic": True}


if __name__ == "__main__":
    main()
