"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA [hf:ibm-granite/granite-3.0-2b-base; hf] (a copy of the
JAX package's ``repro/configs/granite_3_2b.py``).

vocab 49155 is padded to 49408 (multiple of 256); d_head = 2048/32 = 64.
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
        n_heads=32, n_kv=8, d_head=64, d_ff=8192, vocab=49155,
        norm_type="rms", rope_theta=1e4)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-3-2b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=250,  # exercises padding
        norm_type="rms", remat=False, dtype=torch.float32)


base.register("granite-3-2b", full, smoke)
