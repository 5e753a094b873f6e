"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219; unverified] (a copy of
the JAX package's ``repro/configs/phi3_medium_14b.py``).

The reference gives it the sequence-sharded attention plan
(``attn_plan="seq_tp"``: 40 heads do not split over a 16-way model axis):
under the sharding tables each rank of the model axis attends for its
slice of the sequence (``layers.attention_plan``).  On one device the plan
changes nothing, and the port runs it as any dense config: D = 128
through the flash-attention kernels.
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv=10, d_head=128, d_ff=17920, vocab=100352,
        norm_type="rms", rope_theta=1e4, attn_plan="seq_tp")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
        norm_type="rms", remat=False, dtype=torch.float32)


base.register("phi3-medium-14b", full, smoke)
