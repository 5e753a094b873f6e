"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8e top-2, SWA [arXiv:2401.04088; hf:
mistralai/Mixtral-8x7B-v0.1] (a copy of the JAX package's
``repro/configs/mixtral_8x7b.py``).

Sliding-window attention (4096): prefill and training attend through the
windowed flash-attention kernels, and the decode cache is 4096 slots that
roll (position p in slot p % 4096).

sub_experts=2: each expert is stored as 2 d_ff-slices (the reference's EP
x TP layout, 16 sub-experts of hidden 7168); gate/up split exactly and the
down products' partials add up in the combine.
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig
from repro_torch.models.moe import MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv=8, d_head=128, d_ff=0, vocab=32000,
        norm_type="rms", rope_theta=1e6, sliding_window=4096,
        moe=MoEConfig(d_model=4096, d_ff=14336, n_experts=8, top_k=2,
                      sub_experts=2))


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=0, vocab=256, norm_type="rms",
        sliding_window=32, remat=False, dtype=torch.float32,
        moe=MoEConfig(d_model=64, d_ff=32, n_experts=4, top_k=2,
                      sub_experts=2))


base.register("mixtral-8x7b", full, smoke)
