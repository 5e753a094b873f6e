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
    long_500k     seq_len=524,288 global_batch=1     (long-context decode;
                  sub-quadratic archs only: ``cell_is_runnable``)

``input_specs(cfg, shape)`` gives the (shape, dtype) of every model input of
a cell; the dry run (``launch.dryrun``) builds its fake inputs from them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

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

# archs that may run long_500k (sub-quadratic attention / SSM / SWA)
SUBQUADRATIC = {"falcon-mamba-7b", "zamba2-7b", "mixtral-8x7b"}

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


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell, with the
    reference's skip reason where it is not."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "SKIP: long_500k needs sub-quadratic attention " \
                      "(pure full-attention arch; DESIGN.md §4)"
    return True, ""


InputSpec = Tuple[tuple, torch.dtype]


def input_specs(cfg: ArchConfig, shape: ShapeCell,
                num_microbatches: int = 1) -> Dict[str, InputSpec]:
    """(shape, dtype) of every model input of this cell.

    train:   {tokens, labels} (+ frontend stubs), microbatch-stacked when
             num_microbatches > 1: (n_micro, mb, S).
    prefill: {tokens} (+ stubs).
    decode:  {tokens (B, 1)}; the KV/SSM cache of length seq_len is the
             decode state, not an input spec.
    A VLM's text is S minus its image tokens; an enc-dec's frames are
    ``cfg.source_len`` long (else S)."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        return {"tokens": ((B, 1), i32)}
    s_text = S - cfg.n_img_tokens if cfg.family == "vlm" else S
    if shape.kind == "train" and num_microbatches > 1:
        lead = (num_microbatches, B // num_microbatches)
    else:
        lead = (B,)
    specs: Dict[str, InputSpec] = {"tokens": ((*lead, s_text), i32)}
    if shape.kind == "train":
        specs["labels"] = ((*lead, s_text), i32)
    if cfg.family == "vlm":
        specs["image_embeds"] = ((*lead, cfg.n_img_tokens, cfg.d_model),
                                 bf16)
    if cfg.enc_dec:
        specs["frames"] = ((*lead, cfg.source_len or S, cfg.d_model), bf16)
    return specs
