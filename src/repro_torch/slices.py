"""Which later slice of the port brings what this slice leaves out.

Every plan, algorithm, option and CLI mode of the JAX package that the port
does not run yet raises ``not_ported(...)`` — a ``NotImplementedError``
naming the slice that ports it — instead of quietly running something else.
ROADMAP.md ("Slices of the port") holds the same map.
"""
from __future__ import annotations

MULTI_RANK_CLI = "slice 9 (multi-rank launch)"


def not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is ported in {where}; the PyTorch port so far serves "
        "CapsNet with dynamic or EM routing, unsharded or sharded over a "
        "device mesh, behind one server or a multi-tenant fleet with fault "
        "injection, trains it with dynamic routing on one device or "
        "sharded, runs the fast-math kernel, and trains and serves the "
        "dense, Mamba-1, MoE, hybrid Mamba-2, VLM and encoder-decoder LMs "
        "(sliding-window attention too) on one device or under the "
        "sharding tables on a device mesh of ranks the caller starts")
