"""LM serving: greedy generation and its WaveServe adapter.

Port of the LM half of the JAX package's ``repro/runtime/serve_loop.py``:

  * ``generate`` — prefill then greedy decode for a batch of same-length
    prompts (the reference jit-caches its prefill/step pair; the port runs
    eagerly, so there is nothing to cache);
  * ``LMDecodeAdapter`` — greedy generation as a WaveServe workload, so
    the serving stack's bounded queues, waves, retries and NaN guard apply
    to LM requests unchanged.

``MoEAdapter`` (the 'moe' Router algorithm) comes with the MoE family and
raises, naming its slice.  The CapsNet classifier shim of the reference
lives in ``runtime.caps_serve``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import slices
from repro_torch.kernels import cudalib
from repro_torch.models import lm
from repro_torch.runtime import wave_serve


@dataclasses.dataclass
class ServeStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    steps: int = 0


def generate(params, cfg: lm.ArchConfig, batch: Dict[str, object],
             max_new_tokens: int, eos_id: Optional[int] = None):
    """Greedy generation for a batch of same-length prompts on the device
    of ``params``.

    Returns (generated (B, max_new_tokens) int32 tensor, ServeStats)."""
    with torch.inference_mode():
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"]["tok"].device)
        B, S = tokens.shape
        stats = ServeStats(prefill_tokens=B * S)
        logits, state = lm.prefill(params, cfg, {"tokens": tokens},
                                   max_len=S + max_new_tokens)
        toks = logits.argmax(-1).to(torch.int32)[:, None]
        outs: List[torch.Tensor] = [toks]
        finished = torch.zeros(B, dtype=torch.bool, device=tokens.device)
        for _ in range(max_new_tokens - 1):
            logits, state = lm.decode_step(params, cfg, state, toks)
            toks = logits.argmax(-1).to(torch.int32)[:, None]
            if eos_id is not None:
                finished = finished | (toks[:, 0] == eos_id)
                toks = torch.where(finished[:, None], eos_id, toks)
            outs.append(toks)
            stats.decode_tokens += B
            stats.steps += 1
            if eos_id is not None and bool(finished.all()):
                break
        return torch.cat(outs, dim=1), stats


# ---------------------------------------------------------------------------
# LMDecodeAdapter — greedy LM generation as a WaveServe workload
# ---------------------------------------------------------------------------

class LMDecodeAdapter(wave_serve.WorkloadAdapter):
    """One wave = one full greedy generation over a padded prompt batch.

    Payloads are ``(prompt_len,)`` int32 token rows; a wave packs up to
    ``wave_lanes`` of them (zero-token rows pad the tail — LM batch lanes
    are independent, so padding leaves the real lanes' tokens unchanged)
    and runs ``generate``.  Keeping a whole generation inside one wave
    keeps requests stateless between waves, so the core's retry machinery
    applies unchanged.

    Completions are ``(<=max_new_tokens,)`` int32 token arrays (shorter
    when every lane hit ``eos_id`` early).  The wave output is a float32
    host array, so the NaN/Inf output guard sees an ordinary float array;
    the guard's reference executable is a fresh clean wave.
    """

    def __init__(self, params, cfg: lm.ArchConfig, *, prompt_len: int,
                 max_new_tokens: int, eos_id: Optional[int] = None):
        if prompt_len < 1 or max_new_tokens < 1:
            raise ValueError("LMDecodeAdapter needs prompt_len >= 1 and "
                             f"max_new_tokens >= 1; got {prompt_len}, "
                             f"{max_new_tokens}")
        lm.check_supported(cfg)
        self.params = params
        self.cfg = cfg
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.device = params["embed"]["tok"].device

    def validate(self, items) -> np.ndarray:
        return lm.validate_prompts(items, self.cfg, self.prompt_len)

    def make_wave_fn(self, cfg: wave_serve.ServeConfig):
        if self.device.type == "cuda":
            cudalib.build()   # a kernel that does not build fails here

        def wave(tokens):
            out, _ = generate(self.params, self.cfg, {"tokens": tokens},
                              self.max_new_tokens, eos_id=self.eos_id)
            return out.float().cpu().numpy()
        return wave

    def make_reference_wave_fn(self, cfg: wave_serve.ServeConfig):
        # a fresh greedy generation re-runs the same computation cleanly
        return self.make_wave_fn(cfg)

    def pack(self, payloads, cfg: wave_serve.ServeConfig) -> torch.Tensor:
        tokens = np.zeros((cfg.wave_lanes, self.prompt_len), np.int32)
        for i, payload in enumerate(payloads):
            tokens[i] = payload
        return torch.from_numpy(tokens).to(self.device)

    def unpack(self, out, n: int) -> List[np.ndarray]:
        toks = np.asarray(out)
        return [toks[i].astype(np.int32) for i in range(n)]

    def cache_key(self):
        # id(params): adapters own their params (a fleet may mix LM groups
        # over different checkpoints)
        return ("lm", self.cfg, self.prompt_len, self.max_new_tokens,
                self.eos_id, id(self.params))


class MoEAdapter(wave_serve.WorkloadAdapter):
    """Fixed-shape MoE microbatches through the 'moe' Router algorithm —
    ported with the MoE family."""

    def __init__(self, *args, **kwargs):
        raise slices.not_ported("MoEAdapter (the 'moe' Router algorithm)",
                                slices.LM_FAMILIES)
