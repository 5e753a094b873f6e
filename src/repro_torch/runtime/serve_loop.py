"""LM serving: greedy generation, its WaveServe adapter, MoE dispatch
waves, and the CapsNet classifier shim.

Port of the JAX package's ``repro/runtime/serve_loop.py``:

  * ``generate`` — prefill then greedy decode for a batch of same-length
    prompts, with a VLM's image embeddings or an enc-dec's frames beside
    them (the reference jit-caches its prefill/step pair; the port runs
    eagerly, so there is nothing to cache);
  * ``LMDecodeAdapter`` — greedy generation as a WaveServe workload, so
    the serving stack's bounded queues, waves, retries and NaN guard apply
    to LM requests unchanged;
  * ``MoEAdapter`` — fixed-shape MoE microbatches through the 'moe' Router
    algorithm;
  * ``make_capsnet_classifier`` — the reference's deprecated
    classify(images) endpoint, over ``runtime.caps_serve.CapsAdapter``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import cudalib
from repro_torch.models import lm
from repro_torch.models.layers import NO_RULES, AxisRules
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
             max_new_tokens: int, rules: AxisRules = NO_RULES,
             eos_id: Optional[int] = None, route: str = "kernels"):
    """Greedy generation for a batch of same-length prompts on the device
    of ``params``.  ``batch``: "tokens" (B, S), and a VLM's
    "image_embeds" (B, n_img, d_model) or an enc-dec's "frames" (B, T_src,
    d_model) where the model takes them.  The cache holds n_img + S +
    ``max_new_tokens`` positions: the prefill puts the image tokens before
    the text.  (The reference sizes it S + ``max_new_tokens``, so a VLM's
    prefill keeps only the last positions and decode writes past its
    cache.)  ``route`` is the prefill's (``lm.prefill``): the forward
    kernels, or "plain" for a run free of hand-written kernels.  The
    arguments come in the reference's order; under ``rules``
    (``runtime.sharding.make_rules``, decode mode for flash-decoding)
    ``params`` are this rank's blocks and ``batch`` its rows, and the
    tokens returned are its rows'.

    Returns (generated (B, max_new_tokens) int32 tensor, ServeStats)."""
    with torch.inference_mode():
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params["embed"]["tok"].device)
        B, S = tokens.shape
        inputs = {"tokens": tokens}
        inputs.update((k, batch[k]) for k in ("image_embeds", "frames")
                      if k in batch)
        n_img = inputs["image_embeds"].shape[1] \
            if cfg.family == "vlm" and "image_embeds" in inputs else 0
        stats = ServeStats(prefill_tokens=B * S)
        logits, state = lm.prefill(params, cfg, inputs,
                                   max_len=n_img + S + max_new_tokens,
                                   route=route, rules=rules)
        toks = logits.argmax(-1).to(torch.int32)[:, None]
        finite = torch.isfinite(logits).all(-1)
        outs: List[torch.Tensor] = [toks]
        finished = torch.zeros(B, dtype=torch.bool, device=tokens.device)
        for _ in range(max_new_tokens - 1):
            logits, state = lm.decode_step(params, cfg, state, toks, rules)
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

    Payloads are ``(prompt_len,)`` int32 token rows, as in the reference
    (a VLM is served its text alone; an enc-dec config, whose requests need
    frames, raises ``ValueError`` when the adapter is built, where the
    reference fails at its first wave); a wave packs up to
    ``wave_lanes`` of them (zero-token rows pad the tail — LM batch lanes
    are independent, so padding leaves the real lanes' tokens unchanged)
    and runs ``generate``.  Keeping a whole generation inside one wave
    keeps requests stateless between waves, so the core's retry machinery
    applies unchanged.

    ``rules`` are ``generate``'s: under them ``params`` are this rank's
    blocks and each wave's lanes its rows.

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
                 max_new_tokens: int, rules: AxisRules = NO_RULES,
                 eos_id: Optional[int] = None):
        if prompt_len < 1 or max_new_tokens < 1:
            raise ValueError("LMDecodeAdapter needs prompt_len >= 1 and "
                             f"max_new_tokens >= 1; got {prompt_len}, "
                             f"{max_new_tokens}")
        lm.check_supported(cfg)
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its "
                             f"requests need frames, and LMDecodeAdapter "
                             f"takes token rows only; serve it through "
                             f"generate")
        self.params = params
        self.cfg = cfg
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.rules = rules
        self.eos_id = eos_id
        self.device = params["embed"]["tok"].device

    def validate(self, items) -> np.ndarray:
        return lm.validate_prompts(items, self.cfg, self.prompt_len)

    def _wave(self, route: str):
        def wave(tokens):
            out, stats = generate(self.params, self.cfg, {"tokens": tokens},
                                  self.max_new_tokens, self.rules,
                                  self.eos_id, route)
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
                self.eos_id, id(self.params), id(self.rules))


# ---------------------------------------------------------------------------
# MoEAdapter — fixed-shape MoE microbatches via the 'moe' Router algorithm
# ---------------------------------------------------------------------------

class MoEAdapter(wave_serve.WorkloadAdapter):
    """One wave = one fixed-shape MoE forward over padded token blocks.

    Payloads are ``(seq_len, d_model)`` float32 activation blocks; a wave
    packs up to ``wave_lanes`` of them (zero blocks pad the tail), flattens
    to ``(wave_lanes * seq_len, d_model)`` tokens on the device of
    ``params`` (in the experts' dtype) and dispatches through the 'moe'
    Router algorithm — ``RouterSpec(algorithm="moe")`` resolved by
    ``core.router.build_router``.  Completions are the ``(seq_len,
    d_model)`` output blocks as float32 arrays.

    Capacity note: expert capacity scales with the *total* token count
    (``models.moe._capacity``), so padded lanes compete for expert slots
    and strict padding bit-invariance needs a ``capacity_factor`` high
    enough that nothing is dropped (``>= n_experts / top_k``); at lower
    factors padding can only *drop more* tokens, never change routing
    decisions of surviving ones.  The combine adds each token's experts
    in a fixed order (``models.moe``), so a wave is bitwise repeatable.
    """

    def __init__(self, params, cfg, *, seq_len: int, plan=None):
        if seq_len < 1:
            raise ValueError(f"MoEAdapter needs seq_len >= 1; got {seq_len}")
        self.params = params
        self.cfg = cfg
        self.seq_len = seq_len
        self.plan = plan
        self.device = params["router"].device

    def validate(self, items) -> np.ndarray:
        shape = (self.seq_len, self.cfg.d_model)
        try:
            arr = np.asarray(items, np.float32)
        except (ValueError, TypeError) as e:
            raise ValueError(
                "ragged arrival: could not assemble the activation blocks "
                f"into one (n,) + {shape} float array") from e
        if arr.ndim != 3 or arr.shape[1:] != shape:
            got = arr.shape[1:] if arr.ndim == 3 else arr.shape
            raise ValueError(f"activation block shape {got} != {shape}")
        return arr

    def make_wave_fn(self, cfg: wave_serve.ServeConfig):
        from repro_torch.core import router as router_lib
        from repro_torch.models import moe as moe_lib
        spec = router_lib.RouterSpec(
            algorithm="moe", options=(("moe_cfg", self.cfg),))
        router = router_lib.build_router(spec, self.plan, device=self.device)
        args = moe_lib.router_args(self.params)
        lanes, S, D = cfg.wave_lanes, self.seq_len, self.cfg.d_model

        def wave(x):
            with torch.inference_mode():
                y, _aux = router(x.reshape(lanes * S, D), *args)
                return y.reshape(lanes, S, D)
        return wave

    def pack(self, payloads, cfg: wave_serve.ServeConfig) -> torch.Tensor:
        x = np.zeros((cfg.wave_lanes, self.seq_len, self.cfg.d_model),
                     np.float32)
        for i, payload in enumerate(payloads):
            x[i] = payload
        return torch.from_numpy(x).to(
            self.device, dtype=self.params["w_gate"].dtype)

    def unpack(self, out, n: int) -> List[np.ndarray]:
        y = out.detach().float().cpu().numpy()
        return [y[i] for i in range(n)]

    def cache_key(self):
        try:
            hash(self.plan)
        except TypeError:
            return wave_serve.NO_CACHE
        return ("moe", self.cfg, self.seq_len, self.plan, id(self.params))


# ---------------------------------------------------------------------------
# CapsNet classification serving (the paper's workload, Router API)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CapsServeStats:
    requests: int = 0
    batches: int = 0
    padded_waste: int = 0    # padding images computed and discarded


def make_capsnet_classifier(net, spec=None, plan=None, max_batch: int = 32):
    """Build a classify(images) endpoint over the unified Router API.

    ``net``: a ``CapsNet`` on its device.  spec/plan: forwarded to
    ``core.router.build_router`` (None -> exact unsharded dynamic routing
    at ``net.cfg.routing_iters``).  Requests are chunked/padded to
    ``max_batch`` so every wave has one shape.

    Returns (classify, stats): classify(images (N,H,W,C)) -> (N,) int32
    predicted classes (a CPU tensor); stats is updated in place per call.

    Deprecation shim, as in the reference: each chunk is one queue-less
    wave of the CapsNet WaveServe adapter (``runtime.caps_serve.
    CapsAdapter``) with ``n_micro=1``, so the padding is the adapter's
    mask-invariant lane padding.  A prebuilt Router ``spec`` or a full
    ``ExecutionPlan`` keeps the legacy inline path (zero-image padding
    through ``models.capsnet.forward``) — the wave recipe's routing_plan
    field (None / "auto" / axes) cannot represent them.
    """
    from repro_torch.core import router as router_lib
    from repro_torch.models import capsnet
    from repro_torch.runtime import caps_serve

    stats = CapsServeStats()

    if (callable(spec) and not isinstance(spec, router_lib.RouterSpec)) \
            or isinstance(plan, router_lib.ExecutionPlan):
        router = router_lib.as_router(
            spec, plan, device=net.device,
            default_iterations=net.cfg.routing_iters)

        def classify(images) -> torch.Tensor:
            images = torch.as_tensor(np.asarray(images, np.float32),
                                     device=net.device)
            n = images.shape[0]
            preds: List[torch.Tensor] = []
            with torch.inference_mode():
                for lo in range(0, n, max_batch):
                    chunk = images[lo:lo + max_batch]
                    pad = max_batch - chunk.shape[0]
                    if pad:
                        chunk = torch.cat([chunk, chunk.new_zeros(
                            (pad,) + tuple(chunk.shape[1:]))])
                        stats.padded_waste += pad
                    probs = capsnet.forward(net, chunk,
                                            router=router)["class_probs"]
                    preds.append(probs.argmax(-1)[:max_batch - pad].cpu())
                    stats.batches += 1
            stats.requests += n
            return (torch.cat(preds).to(torch.int32) if preds
                    else torch.zeros((0,), dtype=torch.int32))

        return classify, stats

    # adapter-core path: one queue-less wave per chunk.  class_probs is
    # ‖v‖ — exactly the dynamic wave score — so argmax parity is exact.
    if spec is None:
        spec = router_lib.RouterSpec(iterations=net.cfg.routing_iters)
    adapter = caps_serve.CapsAdapter(net, spec)
    scfg = wave_serve.ServeConfig(microbatch=max_batch, n_micro=1,
                                  pipeline=None, routing_plan=plan)
    wave = adapter.make_wave_fn(scfg)

    def classify(images) -> torch.Tensor:
        arr = adapter.validate(images)
        n = arr.shape[0]
        preds: List[int] = []
        for lo in range(0, n, max_batch):
            chunk = arr[lo:lo + max_batch]
            take = chunk.shape[0]
            out = wave(adapter.pack(list(chunk), scfg))
            preds.extend(adapter.unpack(out, take))
            stats.batches += 1
            stats.padded_waste += max_batch - take
        stats.requests += n
        return torch.tensor(preds, dtype=torch.int32)

    return classify, stats
