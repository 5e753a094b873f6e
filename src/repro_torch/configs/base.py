"""Config registry: architectures × input shapes (a copy of the JAX
package's ``repro/configs/base.py``; the port imports nothing of ``repro``).

Each architecture module registers its published configuration (sources
cited per file).  The port has all ten of the reference's: granite-3-2b,
phi3-medium-14b, mistral-large-123b and stablelm-12b (dense),
falcon-mamba-7b (Mamba-1), qwen3-moe-30b-a3b (MoE), mixtral-8x7b (MoE with
sliding-window attention), zamba2-7b (hybrid: Mamba-2 and a shared
attention block), llava-next-mistral-7b (VLM: projected image embeddings
before the text) and seamless-m4t-large-v2 (audio: an encoder–decoder
with cross attention).  The shapes are the reference's four cells:

    train_4k      seq_len=4,096   global_batch=256   (training)
    prefill_32k   seq_len=32,768  global_batch=32    (inference prefill)
    decode_32k    seq_len=32,768  global_batch=128   (inference decode)
    long_500k     seq_len=524,288 global_batch=1     (long-context decode)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models.lm import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}
# reduced-size factory per arch for CPU smoke tests
_SMOKE_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str, full: Callable[[], ArchConfig],
             smoke: Callable[[], ArchConfig]) -> None:
    _REGISTRY[name] = full
    _SMOKE_REGISTRY[name] = smoke


def _lookup(registry: Dict[str, Callable[[], ArchConfig]],
            name: str) -> ArchConfig:
    if name not in registry:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
    return registry[name]()


def get_config(name: str) -> ArchConfig:
    return _lookup(_REGISTRY, name)


def get_smoke_config(name: str) -> ArchConfig:
    return _lookup(_SMOKE_REGISTRY, name)


def with_layers(cfg: ArchConfig, n: int) -> ArchConfig:
    """``cfg`` cut to ``n`` of its layers: the decoder's, and an
    encoder-decoder's encoder to at most ``n`` too (a hybrid keeps n //
    attn_every super-blocks and the rest as its tail)."""
    if not 1 <= n <= cfg.n_layers:
        raise ValueError(f"a cut to {n} layers of {cfg.n_layers}")
    return dataclasses.replace(cfg, n_layers=n,
                               n_enc_layers=min(n, cfg.n_enc_layers))


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
