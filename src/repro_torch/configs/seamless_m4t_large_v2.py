"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf] (a copy of the
JAX package's ``repro/configs/seamless_m4t_large_v2.py``).

The audio frontend is a stub, as in the reference: a request carries
precomputed frame embeddings (B, source_len, d_model).  The 24L/1024/16H/8192
backbone is mirrored as 24 encoder + 24 decoder layers (the text decoder),
each decoder layer with its own cross attention over the encoder's output.
vocab padded 256206→256256.
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2", family="audio", n_layers=24,
        d_model=1024, n_heads=16, n_kv=16, d_head=64, d_ff=8192,
        vocab=256206, norm_type="ln", rope_theta=1e4, enc_dec=True,
        n_enc_layers=24, source_len=4096)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2-smoke", family="audio", n_layers=2,
        d_model=64, n_heads=4, n_kv=4, d_head=16, d_ff=128, vocab=256,
        norm_type="ln", enc_dec=True, n_enc_layers=2, source_len=32,
        remat=False, dtype=torch.float32)


base.register("seamless-m4t-large-v2", full, smoke)
