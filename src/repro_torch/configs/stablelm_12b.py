"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-1_6b; hf] (a copy of the JAX
package's ``repro/configs/stablelm_12b.py``).

Uses LayerNorm (with bias) per the StableLM-2 family; d_head = 5120/32 =
160, which the flash-attention kernels instantiate for it.
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="stablelm-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv=8, d_head=160, d_ff=13824, vocab=100352,
        norm_type="ln", rope_theta=1e4)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="stablelm-12b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256,
        norm_type="ln", remat=False, dtype=torch.float32)


base.register("stablelm-12b", full, smoke)
