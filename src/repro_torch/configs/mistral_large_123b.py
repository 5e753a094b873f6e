"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407; unverified] (a copy
of the JAX package's ``repro/configs/mistral_large_123b.py``).

122.61 B parameters, 245 GB in bf16: on one 80 GB card it runs under a
depth cut (1.3841 B a layer, 0.805 B of embeddings).
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b", family="dense", n_layers=88,
        d_model=12288, n_heads=96, n_kv=8, d_head=128, d_ff=28672,
        vocab=32768, norm_type="rms", rope_theta=1e6)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b-smoke", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
        norm_type="rms", remat=False, dtype=torch.float32)


base.register("mistral-large-123b", full, smoke)
