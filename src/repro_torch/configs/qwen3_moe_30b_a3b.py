"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf] (a copy of the
JAX package's ``repro/configs/qwen3_moe_30b_a3b.py``).

head_dim=128 (explicit, != d_model/H) and per-head QK-norm per the Qwen3
family.  The per-expert FFN hidden is 768.
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig
from repro_torch.models.moe import MoEConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv=4, d_head=128, d_ff=0, vocab=151936,
        norm_type="rms", rope_theta=1e6, qk_norm=True,
        moe=MoEConfig(d_model=2048, d_ff=768, n_experts=128, top_k=8))


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=0, vocab=256, norm_type="rms",
        qk_norm=True, remat=False, dtype=torch.float32,
        moe=MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2))


base.register("qwen3-moe-30b-a3b", full, smoke)
