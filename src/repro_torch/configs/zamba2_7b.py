"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks [arXiv:2411.15242;
unverified] (a copy of the JAX package's ``repro/configs/zamba2_7b.py``).

Structure: 81 Mamba-2 layers; a single *shared* attention+MLP block (one
set of weights) is applied after every 6th Mamba layer (13 invocations),
the Zamba2 weight-sharing scheme simplified as in the reference (no
per-invocation LoRA); the 81st layer is the tail.  d_inner = 2·d_model =
7168, headdim 64 → 112 SSM heads, d_state 64; the attention's d_head 112
is a head dim the flash-attention kernels instantiate for it.
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig
from repro_torch.models.ssm import SSMConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        n_heads=32, n_kv=32, d_head=112, d_ff=14336, vocab=32000,
        norm_type="rms", rope_theta=1e4, attn_every=6,
        ssm=SSMConfig(d_model=3584, d_inner=7168, d_state=64, dt_rank=224,
                      version=2, headdim=64))


def smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b-smoke", family="hybrid", n_layers=5, d_model=64,
        n_heads=4, n_kv=4, d_head=16, d_ff=128, vocab=256, norm_type="rms",
        attn_every=2, remat=False, dtype=torch.float32,
        ssm=SSMConfig(d_model=64, d_inner=128, d_state=16, dt_rank=8,
                      version=2, headdim=32))


base.register("zamba2-7b", full, smoke)
