"""Config-driven LM family — the dense, MoE, Mamba-1 (ssm) and hybrid
(Mamba-2 + one shared attention block) families, trained and served on one
device.

Port of the JAX package's ``repro/models/lm.py``: the config, parameter
init, the attention and SSM blocks, the teacher-forced forward and its
loss, and the prefill / greedy decode path with its KV and SSM caches.
Parameters are a plain dict tree with the reference's key paths and
stacked layer axes (``layers/attn/wq`` is (L, d_model, H·d_head); a
hybrid's ``blocks`` are stacked twice, (n_super, attn_every, ...), beside
``shared_attn`` and the ``tail`` of leftover SSM layers), so
``convert.lm_params_from_jax`` carries the reference's tree across leaf by
leaf; the reference's scans over layers are Python loops.

Each full-sequence path names its route through the blocks
(``layers.ROUTES``): ``forward_train`` takes "train" (attention through the
forward-with-lse and backward kernels, the SSMs through their
differentiable chunk loops), ``prefill`` takes "kernels" (the
flash-attention and selective-scan forward kernels) or, asked for
explicitly, "plain" (no hand-written kernel: the serving guard's re-run).
With ``cfg.remat`` training rematerialises as the reference does: a stack
of n layers runs under the two-level remat of ``_remat_group`` — groups of
G layers under ``torch.utils.checkpoint``, each layer checkpointed again
inside its group, so L/G + G layer inputs are kept instead of L — and
single-level (each layer checkpointed) where G is 1 or n.  A hybrid's
super-block (its Mamba-2 stack and the shared attention block) is
checkpointed as a whole around its own stack's two-level remat.  Decode is
plain PyTorch.  The caches are written in place (see
``layers.update_cache_stack``): a decode step consumes the state it is
given.

The MoE family's blocks are attention + ``models.moe`` (``attn_moe``);
``forward_train`` sums each block's load-balance aux term over the layers
(once, whatever the remat) and ``loss_fn`` adds it with ``aux_weight``.  A
``sliding_window`` (dense and MoE families: mixtral-8x7b) windows
full-sequence attention on every route, and the decode cache is then
``min(max_len, window)`` slots that roll: position p lives in slot
``p % window``, from prefill on.  The hybrid family (zamba2-7b) applies
its one shared attention block after every ``attn_every`` Mamba-2 layers;
its decode state holds one KV cache per super-block (n_super entries, not
n_layers) beside the SSM state of every Mamba layer.  The vlm and audio
families, enc-dec configs and the sharding tables (``param_logical_axes``,
``param_shardings``) raise naming slice 11; sharding ``rules`` for
training raise naming slice 8.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import slices
from repro_torch.kernels import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

# the chunked scan's preferred chunk: the reference's ArchConfig.ssm_chunk,
# which no configuration changes
SSM_CHUNK = 64

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 0
    d_ff: int = 0
    norm_type: str = "rms"
    rope_theta: float = 1e4
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    moe: Optional[moe_lib.MoEConfig] = None
    ssm: Optional[ssm_lib.SSMConfig] = None
    attn_every: int = 0              # hybrid: shared attn after every N ssm layers
    enc_dec: bool = False
    remat: bool = True               # recompute each layer in the backward
    dtype: Any = torch.bfloat16
    vocab_pad_to: int = 256

    @property
    def vocab_padded(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    @property
    def block_kind(self) -> str:
        if self.family in ("dense", "vlm"):
            return "attn_mlp"
        if self.family == "moe":
            return "attn_moe"
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "hybrid"
        if self.family == "audio":
            return "attn_mlp"
        raise ValueError(self.family)

    def param_count(self) -> int:
        """Total parameters, from shapes alone (``init_params`` on the meta
        device)."""
        params = init_params(self, device="meta")
        return sum(t.numel() for t in _leaves(params))


def check_supported(cfg: ArchConfig) -> None:
    """The port runs the dense, MoE, ssm (Mamba-1 or Mamba-2) and hybrid
    families, the dense and MoE families with or without a sliding window,
    without an encoder; anything else raises."""
    if cfg.family == "moe" and cfg.moe is None:
        raise ValueError(f"{cfg.name}: the moe family needs an MoEConfig")
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise slices.not_ported(f"the {cfg.family} LM family",
                                slices.LM_FAMILIES)
    if cfg.enc_dec:
        raise slices.not_ported("enc-dec LMs", slices.LM_FAMILIES)
    if cfg.sliding_window is not None and cfg.family == "ssm":
        raise ValueError(f"{cfg.name}: a sliding window needs attention")
    if cfg.family == "hybrid":
        if cfg.ssm is None or not 1 <= cfg.attn_every <= cfg.n_layers:
            raise ValueError(f"{cfg.name}: the hybrid family needs an "
                             f"SSMConfig and 1 <= attn_every <= n_layers")
        if cfg.sliding_window is not None:
            # the reference's hybrid cache holds every position
            raise ValueError(f"{cfg.name}: the hybrid family's shared "
                             f"attention takes no sliding window")


def hybrid_layout(cfg: ArchConfig) -> tuple:
    """(n_super, tail) of a hybrid: n_super super-blocks of attn_every
    Mamba layers each followed by the shared attention block, then the
    tail's leftover Mamba layers."""
    n_super = cfg.n_layers // cfg.attn_every
    return n_super, cfg.n_layers - n_super * cfg.attn_every


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts of tensors)
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer(stacked, i: int):
    """Layer ``i`` of a stacked parameter (or state) tree."""
    return _tree_map(lambda t: t[i], stacked)


def unbind_layers(stacked, n: int) -> list:
    """The ``n`` per-layer trees of a stacked tree, each leaf unbound once.
    Under autograd the backward of one ``unbind`` is one stack of the
    per-layer gradients, where ``layer(stacked, i)`` for every i would
    build a zero tensor of the whole stacked leaf per layer."""
    per_leaf = _tree_map(lambda t: t.unbind(0), stacked)
    return [_tree_map(lambda views: views[i], per_leaf) for i in range(n)]


def _stack_init(fn: Callable[[], dict], n: int, device) -> dict:
    """``n`` draws of ``fn()`` stacked on a leading layer axis, written
    into preallocated stacks (no list of n copies is held)."""
    first = fn()
    out = _tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                          device=device), first)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    put(out, first, 0)
    for i in range(1, n):
        put(out, fn(), i)
    return out


def _init_attn_block(gen, cfg: ArchConfig, device,
                     with_moe: bool = False) -> dict:
    p = {
        "attn_norm": L.init_norm(cfg.d_model, cfg.norm_type, device),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                 cfg.d_head, cfg.dtype, device),
        "mlp_norm": L.init_norm(cfg.d_model, cfg.norm_type, device),
    }
    if with_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg.moe, cfg.dtype, device)
    else:
        p["mlp"] = L.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype,
                                 device)
    if cfg.qk_norm:
        p["attn"]["q_norm"] = torch.ones(cfg.d_head, device=device)
        p["attn"]["k_norm"] = torch.ones(cfg.d_head, device=device)
    return p


def _init_ssm_block(gen, cfg: ArchConfig, device) -> dict:
    return {"norm": L.init_norm(cfg.d_model, cfg.norm_type, device),
            "mamba": ssm_lib.init_mamba(gen, cfg.ssm, cfg.dtype, device)}


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda") -> dict:
    """Random weights drawn from ``seed`` on ``device`` (the card unless
    the caller asks for the CPU; "meta" gives shapes only).  Different
    numbers from the reference's ``jax.random`` draw of the same seed."""
    check_supported(cfg)
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab_padded, cfg.d_model,
                                  cfg.dtype, dev),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm_type, dev),
    }
    if cfg.family == "hybrid":
        n_super, tail = hybrid_layout(cfg)
        params["blocks"] = _stack_init(
            lambda: _stack_init(lambda: _init_ssm_block(gen, cfg, dev),
                                cfg.attn_every, dev), n_super, dev)
        params["shared_attn"] = _init_attn_block(gen, cfg, dev)
        if tail:
            params["tail"] = _stack_init(
                lambda: _init_ssm_block(gen, cfg, dev), tail, dev)
        return params
    with_moe = cfg.block_kind == "attn_moe"
    params["layers"] = _stack_init(
        lambda: (_init_ssm_block(gen, cfg, dev) if cfg.family == "ssm"
                 else _init_attn_block(gen, cfg, dev, with_moe)),
        cfg.n_layers, dev)
    return params


def param_logical_axes(cfg: ArchConfig):
    raise slices.not_ported("the LM sharding tables (param_logical_axes)",
                            slices.LM_FAMILIES)


def param_shardings(cfg: ArchConfig, rules=None):
    raise slices.not_ported("the LM sharding tables (param_shardings)",
                            slices.LM_FAMILIES)


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------

def _ffn(p, x, cfg: ArchConfig) -> tuple:
    """The block's feed-forward half on the normed residual: SwiGLU (aux
    0), or the MoE dispatch and its load-balance aux term."""
    hm = L.apply_norm(p["mlp_norm"], x, cfg.norm_type)
    if "moe" in p:
        return moe_lib.moe_forward(p["moe"], hm, cfg.moe)
    return L.swiglu(p["mlp"], hm), torch.zeros((), device=x.device)


def _attn_block_fwd(p, x, positions, cfg: ArchConfig,
                    route: str = "kernels") -> tuple:
    """Attention + SwiGLU or MoE block (causal, the config's sliding
    window, no cross attention).  Returns (x, aux)."""
    h = L.apply_norm(p["attn_norm"], x, cfg.norm_type)
    x = x + L.attention_forward(
        p["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.d_head, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window, route=route)
    y, aux = _ffn(p, x, cfg)
    return x + y, aux


def _ssm_block_fwd(p, x, cfg: ArchConfig,
                   state: Optional[ssm_lib.SSMState] = None,
                   route: str = "kernels"):
    h = L.apply_norm(p["norm"], x, cfg.norm_type)
    y, new_state = ssm_lib.mamba_forward(p["mamba"], h, cfg.ssm,
                                         chunk=SSM_CHUNK, state=state,
                                         route=route)
    return x + y, new_state


def _embed_inputs(params, cfg: ArchConfig, batch: Dict[str, Any]):
    """Token embedding.  Returns (x (B,S,D), positions (B,S))."""
    dev = params["embed"]["tok"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = L.embed(params["embed"], tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=dev).expand(B, S)
    return x, positions


def _remat_group(n: int) -> int:
    """The divisor of n nearest sqrt(n): the two-level remat's group size
    (the reference's ``_remat_group``).  Single-level remat over n layers
    keeps n layer inputs for the backward; groups of G, checkpointed
    around layers checkpointed again, keep n/G + G, least near
    G = sqrt(n).  The backward then runs a layer's forward a third time
    (torch's checkpoint stops a group's recomputation once its last
    layer's input is back, so that layer's is skipped: 3n − n/G forwards a
    step against single-level remat's 2n)."""
    best = 1
    target = n ** 0.5
    for g in range(1, n + 1):
        if n % g == 0 and abs(g - target) < abs(best - target):
            best = g
    return best


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _train_stack(body, x, aux, layers: list, cfg: ArchConfig) -> tuple:
    """``body(lp, x) -> (x, aux term)`` over ``layers`` in order, the aux
    terms added to ``aux`` one layer at a time (the reference's scan
    carry).  With ``cfg.remat`` each layer runs under a checkpoint, and
    where ``_remat_group`` gives 1 < G < n, groups of G layers run under
    a checkpoint too (the reference's ``_nested_scan``).  A layer's aux is
    an output of its checkpointed call, so a recomputation in the backward
    adds nothing to the sum."""
    def run(group, x, aux):
        for lp in group:
            x, a = _checkpoint(body, lp, x) if cfg.remat else body(lp, x)
            aux = aux + a
        return x, aux

    n = len(layers)
    g = _remat_group(n) if cfg.remat else 1
    if g <= 1 or g >= n:
        return run(layers, x, aux)
    for i in range(0, n, g):
        x, aux = _checkpoint(run, layers[i:i + g], x, aux)
    return x, aux


def _train_layer(lp, x, positions, cfg: ArchConfig) -> tuple:
    if cfg.family in ("ssm", "hybrid"):
        return (_ssm_block_fwd(lp, x, cfg, route="train")[0],
                torch.zeros((), device=x.device))
    return _attn_block_fwd(lp, x, positions, cfg, route="train")


def _hybrid_train(params, x, positions, cfg: ArchConfig):
    """The hybrid backbone (the reference's ``_hybrid_fwd``): each
    super-block, checkpointed as a whole under ``cfg.remat``, runs its
    Mamba-2 stack through ``_train_stack`` and then the shared attention
    block; the tail's stack follows."""
    n_super, tail = hybrid_layout(cfg)
    shared = params["shared_attn"]
    zero = torch.zeros((), device=x.device)

    def ssm_layer(lp, x):
        return _train_layer(lp, x, positions, cfg)

    def super_block(blk, x):
        x, _ = _train_stack(ssm_layer, x, zero,
                            unbind_layers(blk, cfg.attn_every), cfg)
        return _attn_block_fwd(shared, x, positions, cfg, route="train")[0]

    for blk in unbind_layers(params["blocks"], n_super):
        x = _checkpoint(super_block, blk, x) if cfg.remat \
            else super_block(blk, x)
    if tail:
        x, _ = _train_stack(ssm_layer, x, zero,
                            unbind_layers(params["tail"], tail), cfg)
    return x


def forward_train(params, cfg: ArchConfig, batch, rules=None):
    """Teacher-forced forward.  Returns (logits (B, S, V), moe aux: the sum
    over layers of each MoE block's load-balance term, a zero for the
    other families).  Gradients reach every parameter leaf that requires
    grad; with ``cfg.remat`` the layers are rematerialised in the backward
    (module docstring)."""
    check_supported(cfg)
    if rules is not None:
        raise slices.not_ported("training under sharding rules",
                                slices.SHARDED_TRAINING)
    x, positions = _embed_inputs(params, cfg, batch)
    aux = torch.zeros((), device=x.device)
    if cfg.family == "hybrid":
        x = _hybrid_train(params, x, positions, cfg)
    else:
        x, aux = _train_stack(
            lambda lp, x: _train_layer(lp, x, positions, cfg), x, aux,
            unbind_layers(params["layers"], cfg.n_layers), cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = L.unembed(params["embed"], x)
    return logits, aux


def loss_fn(params, cfg: ArchConfig, batch, rules=None,
            aux_weight: float = 0.01):
    """Mean cross-entropy over labeled tokens (labels < 0 are masked) plus
    ``aux_weight`` times the MoE aux term.  Returns (loss, metrics)."""
    logits, aux = forward_train(params, cfg, batch, rules)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    mask = labels >= 0
    safe = torch.where(mask, labels, 0)
    per_tok = L.sharded_softmax_xent(logits, safe)
    per_tok = torch.where(mask, per_tok, 0.0)
    n = mask.sum()
    loss = per_tok.sum() / torch.clamp(n, min=1)
    total = loss + aux_weight * aux
    return total, {"ce": loss, "moe_aux": aux, "tokens": n.float()}


# ---------------------------------------------------------------------------
# Serving: decode state, prefill, decode step
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Per-layer caches, stacked on the layer axis.

    kv: (k, v) each (L, B, S, n_kv, d_head) — attention caches (a
        hybrid's: the shared block's, one per super-block, (n_super, B, S,
        ...)).
    ssm: SSMState with a leading layer axis — SSM recurrent state (every
        Mamba layer of a hybrid, the tail's last).
    cross: enc-dec memory (always None in this slice).
    pos: (B,) next position index.
    """
    kv: Optional[tuple]
    ssm: Optional[ssm_lib.SSMState]
    cross: Optional[tuple]
    pos: torch.Tensor


def _cache_len(cfg: ArchConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda") -> DecodeState:
    check_supported(cfg)
    dev = resolve_device(device)
    S = _cache_len(cfg, max_len)
    kv = None
    ssm_state = None
    if cfg.family != "ssm":
        n_kv_layers = hybrid_layout(cfg)[0] if cfg.family == "hybrid" \
            else cfg.n_layers
        kv = tuple(torch.zeros(n_kv_layers, batch, S, cfg.n_kv, cfg.d_head,
                               dtype=cfg.dtype, device=dev)
                   for _ in range(2))
    if cfg.family in ("ssm", "hybrid"):
        ssm_state = ssm_lib.SSMState(
            conv=torch.zeros(cfg.n_layers, batch, cfg.ssm.conv_kernel - 1,
                             cfg.ssm.d_inner, dtype=cfg.dtype, device=dev),
            ssm=torch.zeros(cfg.n_layers, batch, cfg.ssm.d_inner,
                            cfg.ssm.d_state, device=dev))
    return DecodeState(kv=kv, ssm=ssm_state, cross=None,
                       pos=torch.zeros(batch, dtype=torch.int32,
                                       device=dev))


def _attn_decode_layer(lp, x, ck, cv, pos, cfg: ArchConfig) -> tuple:
    """One attention block's decode step against its caches ck, cv (B, S,
    n_kv, d_head): (x, this layer's new k, v (B, 1, n_kv, d_head)); the
    caller writes them once for all layers."""
    h = L.apply_norm(lp["attn_norm"], x, cfg.norm_type)
    o, nk, nv = L.attention_decode(
        lp["attn"], h, ck, cv, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.d_head, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window)
    x = x + o
    return x + _ffn(lp, x, cfg)[0], nk, nv


def _ssm_decode_layer(lp, x, ssm_state: ssm_lib.SSMState, i: int,
                      cfg: ArchConfig):
    """Mamba layer i's decode step; its state slot i is updated in place."""
    h = L.apply_norm(lp["norm"], x, cfg.norm_type)
    y, st = ssm_lib.mamba_decode_step(
        lp["mamba"], h, ssm_lib.SSMState(conv=ssm_state.conv[i],
                                         ssm=ssm_state.ssm[i]), cfg.ssm)
    ssm_state.conv[i] = st.conv
    ssm_state.ssm[i] = st.ssm
    return x + y


def decode_step(params, cfg: ArchConfig, state: DecodeState,
                tokens) -> tuple:
    """One greedy decode step.  tokens: (B, 1) -> (logits (B, V), new
    state).  The caches of ``state`` are updated in place."""
    check_supported(cfg)
    x, _ = _embed_inputs(params, cfg, {"tokens": tokens})   # (B,1,D)
    pos = state.pos
    new_kv = state.kv
    nks, nvs = [], []
    if cfg.family in ("dense", "moe"):
        for i in range(cfg.n_layers):
            x, nk, nv = _attn_decode_layer(layer(params["layers"], i), x,
                                           state.kv[0][i], state.kv[1][i],
                                           pos, cfg)
            nks.append(nk)
            nvs.append(nv)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_decode_layer(layer(params["layers"], i), x, state.ssm,
                                  i, cfg)
    else:   # hybrid: the super-blocks, then the tail
        n_super, tail = hybrid_layout(cfg)
        per = cfg.attn_every
        for s in range(n_super):
            blk = layer(params["blocks"], s)
            for j in range(per):
                x = _ssm_decode_layer(layer(blk, j), x, state.ssm,
                                      s * per + j, cfg)
            x, nk, nv = _attn_decode_layer(params["shared_attn"], x,
                                           state.kv[0][s], state.kv[1][s],
                                           pos, cfg)
            nks.append(nk)
            nvs.append(nv)
        for j in range(tail):
            x = _ssm_decode_layer(layer(params["tail"], j), x, state.ssm,
                                  n_super * per + j, cfg)
    if nks:    # one stacked cache write, after the layers
        new_kv = tuple(L.update_cache_stack(c, torch.stack(n), pos,
                                            cfg.sliding_window)
                       for c, n in zip(state.kv, (nks, nvs)))
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = L.unembed(params["embed"], x)[:, 0]
    return logits, DecodeState(kv=new_kv, ssm=state.ssm, cross=None,
                               pos=pos + 1)


def validate_prompts(tokens, cfg: ArchConfig, prompt_len: int) -> np.ndarray:
    """The validate half of validate-then-mutate serving admission:
    assemble an arrival of token prompts into one ``(n, prompt_len)`` int32
    array or raise ``ValueError`` with no side effects.  Used by
    ``runtime.serve_loop.LMDecodeAdapter``."""
    try:
        arr = np.asarray(tokens, np.int32)
    except (ValueError, TypeError) as e:
        raise ValueError(
            "ragged arrival: could not assemble the prompts into one "
            f"(n, {prompt_len}) int array — every prompt must be "
            f"{prompt_len} token ids") from e
    if arr.ndim != 2 or arr.shape[1] != prompt_len:
        got = arr.shape[1:] if arr.ndim == 2 else arr.shape
        raise ValueError(f"prompt shape {got} != ({prompt_len},)")
    if arr.size and (arr.min() < 0 or arr.max() >= cfg.vocab):
        raise ValueError(
            f"prompt token ids must be in [0, {cfg.vocab}); got range "
            f"[{arr.min()}, {arr.max()}]")
    return arr


def prefill(params, cfg: ArchConfig, batch: Dict[str, Any],
            max_len: int, route: str = "kernels") -> tuple:
    """Process a full prompt, building the decode caches.

    Returns (last-token logits (B, V), DecodeState at pos = prompt
    length).  Each attention block projects its K/V into its cache beside
    the block's own forward, as the reference does (a hybrid's shared block
    into its super-block's cache).
    ``route``: "kernels" (the forward kernels) or "plain" (no hand-written
    kernel; the caller asks for it, it is never a fallback).  A cache
    shorter than the prompt (a sliding window) keeps the last Sc positions,
    position p in slot ``p % Sc`` — where decode's rolling writes and its
    stale-slot mask expect it.  (The reference keeps them in slots
    0..Sc−1, which agrees with that only when Sc divides the prompt
    length.)"""
    check_supported(cfg)
    L.check_route(route)
    x, positions = _embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    state = init_decode_state(cfg, B, max_len, x.device)

    def attn_layer(lp, x, i):
        """The block's forward, its K/V into cache slot i."""
        ck, cv = state.kv[0][i], state.kv[1][i]
        k, v = L.project_kv(lp["attn"], L.apply_norm(
            lp["attn_norm"], x, cfg.norm_type), positions,
            n_kv=cfg.n_kv, d_head=cfg.d_head, rope_theta=cfg.rope_theta)
        x = _attn_block_fwd(lp, x, positions, cfg, route)[0]
        Sc = ck.shape[1]
        if Sc >= S:
            ck[:, :S] = k
            cv[:, :S] = v
        else:  # the last Sc positions, p in slot p % Sc
            ck.copy_(k[:, -Sc:].roll(S % Sc, dims=1))
            cv.copy_(v[:, -Sc:].roll(S % Sc, dims=1))
        return x

    def ssm_layer(lp, x, i):
        """The block's forward, its final state into slot i."""
        x, st = _ssm_block_fwd(lp, x, cfg, route=route)
        state.ssm.conv[i] = st.conv
        state.ssm.ssm[i] = st.ssm
        return x

    if cfg.family in ("dense", "moe"):
        for i in range(cfg.n_layers):
            x = attn_layer(layer(params["layers"], i), x, i)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = ssm_layer(layer(params["layers"], i), x, i)
    else:   # hybrid: the super-blocks, then the tail
        n_super, tail = hybrid_layout(cfg)
        per = cfg.attn_every
        for s in range(n_super):
            blk = layer(params["blocks"], s)
            for j in range(per):
                x = ssm_layer(layer(blk, j), x, s * per + j)
            x = attn_layer(params["shared_attn"], x, s)
        for j in range(tail):
            x = ssm_layer(layer(params["tail"], j), x, n_super * per + j)
    state = state._replace(pos=torch.full((B,), S, dtype=torch.int32,
                                          device=x.device))
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = L.unembed(params["embed"], x[:, -1:])[:, 0]
    return logits, state
