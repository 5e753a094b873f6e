"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) d_ff=0 vocab=65024,
ssm_state=16 — mamba1 arch [arXiv:2410.05355; unverified] (a copy of the
JAX package's ``repro/configs/falcon_mamba_7b.py``).

d_inner = 2·d_model = 8192, dt_rank = ceil(4096/16) = 256, conv kernel 4.
"""
import torch

from repro_torch.configs import base
from repro_torch.models.lm import ArchConfig
from repro_torch.models.ssm import SSMConfig


def full() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
        vocab=65024, norm_type="rms",
        ssm=SSMConfig(d_model=4096, d_inner=8192, d_state=16, dt_rank=256,
                      version=1))


def smoke() -> ArchConfig:
    return ArchConfig(
        name="falcon-mamba-7b-smoke", family="ssm", n_layers=2, d_model=64,
        vocab=256, norm_type="rms", remat=False, dtype=torch.float32,
        ssm=SSMConfig(d_model=64, d_inner=128, d_state=16, dt_rank=8,
                      version=1))


base.register("falcon-mamba-7b", full, smoke)
