"""Which later slice of the port brings what this slice leaves out.

Every plan, algorithm, option and CLI mode of the JAX package that the port
does not run yet raises ``not_ported(...)`` — a ``NotImplementedError``
naming the slice that ports it — instead of quietly running something else.
ROADMAP.md ("Slices of the port") holds the same map.
"""
from __future__ import annotations

SHARDED_TRAINING = "slice 8 (sharded training)"
MULTI_RANK_CLI = "slice 9 (multi-rank launch)"
SHARDING_TABLES = "slice 11 (the sharding tables)"


def not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is ported in {where}; the PyTorch port so far serves "
        "CapsNet with dynamic or EM routing, unsharded or sharded over a "
        "device mesh, behind one server or a multi-tenant fleet with fault "
        "injection, trains it with dynamic routing on one device, runs "
        "the fast-math kernel, trains and serves the dense, Mamba-1, MoE, "
        "hybrid Mamba-2, VLM and encoder-decoder LMs (sliding-window "
        "attention too) on one device, and runs the MoE dispatch "
        "expert-parallel over a device mesh")
