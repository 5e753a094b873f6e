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
    # (B,) bool: the lanes whose logits stayed finite at every step (argmax
    # turns a NaN logit into an ordinary token id)
    finite: Optional[torch.Tensor] = None


def generate(params, cfg: lm.ArchConfig, batch: Dict[str, object],
             max_new_tokens: int, eos_id: Optional[int] = None,
             route: str = "kernels"):
    """Greedy generation for a batch of same-length prompts on the device
    of ``params``.  ``route`` is the prefill's (``lm.prefill``): the forward
    kernels, or "plain" for a run free of hand-written kernels.

    Returns (generated (B, max_new_tokens) int32 tensor, ServeStats)."""
    with torch.inference_mode():
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"]["tok"].device)
        B, S = tokens.shape
        stats = ServeStats(prefill_tokens=B * S)
        logits, state = lm.prefill(params, cfg, {"tokens": tokens},
                                   max_len=S + max_new_tokens, route=route)
        toks = logits.argmax(-1).to(torch.int32)[:, None]
        finite = torch.isfinite(logits).all(-1)
        outs: List[torch.Tensor] = [toks]
        finished = torch.zeros(B, dtype=torch.bool, device=tokens.device)
        for _ in range(max_new_tokens - 1):
            logits, state = lm.decode_step(params, cfg, state, toks)
            toks = logits.argmax(-1).to(torch.int32)[:, None]
            finite &= torch.isfinite(logits).all(-1)
            if eos_id is not None:
                finished = finished | (toks[:, 0] == eos_id)
                toks = torch.where(finished[:, None], eos_id, toks)
            outs.append(toks)
            stats.decode_tokens += B
            stats.steps += 1
            if eos_id is not None and bool(finished.all()):
                break
        stats.finite = finite
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
    a lane whose logits turned non-finite at any step comes out as NaN
    tokens, so the guard sees the fault that argmax would hide.  The
    guard's reference executable runs the same generation with the
    prefill's plain route — no hand-written kernel, as the reference's
    pure-JAX wave has none — so a fault that a kernel produces is not
    reproduced by the quarantine re-run.
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

    def _wave(self, route: str):
        def wave(tokens):
            out, stats = generate(self.params, self.cfg, {"tokens": tokens},
                                  self.max_new_tokens, eos_id=self.eos_id,
                                  route=route)
            out = torch.where(stats.finite[:, None], out.float(), torch.nan)
            return out.cpu().numpy()
        return wave

    def make_wave_fn(self, cfg: wave_serve.ServeConfig):
        if self.device.type == "cuda":
            cudalib.build()   # a kernel that does not build fails here
        return self._wave("kernels")

    def make_reference_wave_fn(self, cfg: wave_serve.ServeConfig):
        return self._wave("plain")

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
