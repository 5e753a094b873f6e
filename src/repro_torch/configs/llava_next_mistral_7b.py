"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified] (a copy of the JAX package's
``repro/configs/llava_next_mistral_7b.py``).

The modality frontend is a stub, as in the reference: a request carries
precomputed patch embeddings (B, n_img_tokens, d_model); anyres tiling would
produce up to ~2880 tokens — fixed at 2304 (4 tiles × 576) — and a single
learned projection (``img_proj``) puts them in front of the text.  Backbone
= Mistral-7B.
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b", family="vlm", n_layers=32,
        d_model=4096, n_heads=32, n_kv=8, d_head=128, d_ff=14336,
        vocab=32000, norm_type="rms", rope_theta=1e6, n_img_tokens=2304)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b-smoke", family="vlm", n_layers=2,
        d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
        norm_type="rms", n_img_tokens=16, remat=False, dtype=torch.float32)


base.register("llava-next-mistral-7b", full, smoke)
