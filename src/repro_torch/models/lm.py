"""Config-driven LM family — the dense, MoE, Mamba-1 (ssm), hybrid (Mamba-2
+ one shared attention block), VLM and audio encoder–decoder families,
trained and served on one device.

Port of the JAX package's ``repro/models/lm.py``: the config, parameter
init, the attention and SSM blocks, the teacher-forced forward and its
loss, and the prefill / greedy decode path with its KV and SSM caches.
Parameters are a plain dict tree with the reference's key paths and
stacked layer axes (``layers/attn/wq`` is (L, d_model, H·d_head); a
hybrid's ``blocks`` are stacked twice, (n_super, attn_every, ...), beside
``shared_attn`` and the ``tail`` of leftover SSM layers), so
``convert.lm_params_from_jax`` carries the reference's tree across leaf by
leaf (an enc-dec's ``encoder/layers`` and ``encoder/final_norm``, its
decoder layers' ``cross_norm`` and ``cross``, a VLM's ``img_proj`` too);
the reference's scans over layers are Python loops.

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
n_layers) beside the SSM state of every Mamba layer.

The vlm family (llava-next-mistral-7b) projects a batch's
``image_embeds`` (B, n_img, d_model) by ``img_proj`` and puts them before
the text (``_embed_inputs``): positions, the caches and the logits count
them, ``loss_fn`` pads the labels with −1 over them, and a cache must hold
n_img + prompt + generated positions (``runtime.serve_loop.generate``
sizes it so).  The audio family (seamless-m4t-large-v2, ``enc_dec``) runs
a bidirectional encoder over a batch's ``frames`` (B, T_src, d_model)
(``encode``); each decoder layer projects the encoder's output with its
own cross-attention weights inside the layer loop (under the remat, so
the backward recomputes the projection) and attends to it after its
causal self-attention.  Full-sequence cross attention runs through the
flash-attention kernels with Sk = T_src ≠ Sq; decode attends to the
cross K/V that prefill kept in ``DecodeState.cross``, all T_src slots
valid.  An enc-dec batch without ``frames`` raises ``ValueError``.

**Sharding.**  ``param_logical_axes`` and ``param_shardings`` are the
reference's tables (``layers.PARAM_AXES``, matched on a leaf's last two
path keys, the stacked-layer axes ``None``); ``runtime.sharding.
make_rules`` gives the rules of a mode on a mesh.  Under ``rules`` every
entry point runs as explicit SPMD (``layers`` docstring): ``params`` is
this rank's blocks (``shard_params``; ``gather_params`` gives the whole
leaves back, for a checkpoint), the batch is this rank's rows of the
global batch (split over the batch axes), and every rank returns its
rows' logits over the whole vocab (``forward_train``: its vocab block,
for the loss).  ``loss_fn`` divides the summed token losses by the global
batch's labeled-token count, so every rank holds the global loss.  The
decode caches are split over ``cache_seq`` where its axis size divides
their length (``DecodeState.kv_len``/``cross_len`` give the global
lengths) and the SSM states over ``ssm_inner``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.kernels import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import NO_RULES, AxisRules, as_rules
from repro_torch.runtime import mesh_utils

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
    n_img_tokens: int = 0            # vlm stub frontend: image tokens a request
    enc_dec: bool = False
    n_enc_layers: int = 0
    attn_plan: str = "head_tp"       # head_tp | seq_tp (runtime.sharding)
    remat: bool = True               # recompute each layer in the backward
    dtype: Any = torch.bfloat16
    vocab_pad_to: int = 256
    source_len: int = 0              # enc-dec: encoder frames (0 = same as S)

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
        device), counted once a config (``make_rules`` asks in every
        serving mode)."""
        n = _PARAM_COUNTS.get(self)
        if n is None:
            params = init_params(self, device="meta")
            n = _PARAM_COUNTS[self] = sum(t.numel() for t in _leaves(params))
        return n


_PARAM_COUNTS: Dict[ArchConfig, int] = {}


ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")   # attention blocks only


def check_supported(cfg: ArchConfig) -> None:
    """The port runs every family of the reference: dense, MoE, ssm
    (Mamba-1 or Mamba-2), hybrid, vlm and audio (the encoder–decoder, and
    only it, ``enc_dec``); a sliding window needs attention.  A config
    outside that raises ``ValueError``."""
    if cfg.family not in ATTN_FAMILIES + ("ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: unknown LM family {cfg.family!r}")
    if cfg.family == "moe" and cfg.moe is None:
        raise ValueError(f"{cfg.name}: the moe family needs an MoEConfig")
    if cfg.enc_dec != (cfg.family == "audio"):
        # the reference's decode runs cross attention for the audio
        # family alone, and only an enc-dec config has its memory
        raise ValueError(f"{cfg.name}: enc_dec={cfg.enc_dec} with the "
                         f"{cfg.family} family; the audio family is the "
                         f"encoder-decoder")
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


def _init_attn_block(gen, cfg: ArchConfig, device, with_moe: bool = False,
                     cross: bool = False) -> dict:
    p = {
        "attn_norm": L.init_norm(cfg.d_model, cfg.norm_type, device),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                 cfg.d_head, cfg.dtype, device),
        "mlp_norm": L.init_norm(cfg.d_model, cfg.norm_type, device),
    }
    if cross:
        p["cross_norm"] = L.init_norm(cfg.d_model, cfg.norm_type, device)
        p["cross"] = L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                      cfg.n_kv, cfg.d_head, cfg.dtype,
                                      device)
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
                 else _init_attn_block(gen, cfg, dev, with_moe,
                                       cross=cfg.enc_dec)),
        cfg.n_layers, dev)
    if cfg.enc_dec:
        params["encoder"] = {
            "layers": _stack_init(lambda: _init_attn_block(gen, cfg, dev),
                                  cfg.n_enc_layers, dev),
            "final_norm": L.init_norm(cfg.d_model, cfg.norm_type, dev),
        }
    if cfg.family == "vlm":
        params["img_proj"] = L.init_linear(gen, cfg.d_model, cfg.d_model,
                                           cfg.dtype, dev)
    return params


def _axes_for(keys: list, ndim: int) -> tuple:
    """A leaf's logical axes: the ``PARAM_AXES`` row of the first pair of
    adjacent path keys that has one (else of its last key), led by a
    ``None`` for each stacked axis; ``None`` everywhere for the rest
    (norms, biases)."""
    for i in range(len(keys) - 1):
        ax = L.PARAM_AXES.get(f"{keys[i]}/{keys[i + 1]}")
        if ax is not None:
            return (None,) * (ndim - len(ax)) + ax
    if keys and keys[-1] in L.PARAM_AXES:
        ax = L.PARAM_AXES[keys[-1]]
        return (None,) * (ndim - len(ax)) + ax
    return (None,) * ndim


def _map_with_path(fn: Callable, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(list(path), tree)


def param_logical_axes(cfg: ArchConfig):
    """The tree (matching ``init_params``) of each leaf's logical-axis
    tuple, from shapes alone (``init_params`` on the meta device)."""
    return _map_with_path(lambda keys, t: _axes_for(keys, t.dim()),
                          init_params(cfg, device="meta"))


def param_shardings(cfg: ArchConfig, rules: AxisRules):
    """The tree of each leaf's ``PartitionSpec`` under ``rules``."""
    return _tree_map(lambda ax: rules.spec(*ax), param_logical_axes(cfg))


def local_shape(shape: tuple, axes: tuple, rules: AxisRules) -> tuple:
    """A leaf's shape on one rank: each dimension split over its mesh axis
    where the axis size divides it (``layers.dim_axis``)."""
    return tuple(n // rules.size(L.dim_axis(rules, a, n))
                 for n, a in zip(shape, axes))


def shard_params(params, cfg: ArchConfig, rules: AxisRules):
    """This rank's blocks of the whole-leaf tree ``params`` under
    ``rules`` (copies, so each rank's leaves are its own)."""
    rules = as_rules(rules)

    def block(keys, t):
        for d, (a, n) in enumerate(zip(_axes_for(keys, t.dim()), t.shape)):
            ax = L.dim_axis(rules, a, n)
            if ax is not None:
                c = n // rules.size(ax)
                t = t.narrow(d, rules.index(ax) * c, c)
        return t.clone()
    return _map_with_path(block, params)


def gather_params(params, cfg: ArchConfig, rules: AxisRules):
    """The whole leaves of this rank's blocks ``params`` (a collective:
    every rank calls it), e.g. for a checkpoint; no gradient."""
    rules = as_rules(rules)
    full = init_params(cfg, device="meta")

    def whole(keys, t):
        ref = full
        for k in keys:
            ref = ref[k]
        with torch.no_grad():
            return L.leaf(t, rules, _axes_for(keys, t.dim()),
                          tuple(ref.shape))
    return _map_with_path(whole, params)


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------

def _ffn(p, x, cfg: ArchConfig, rules: AxisRules = NO_RULES) -> tuple:
    """The block's feed-forward half on the normed residual: SwiGLU (aux
    0), or the MoE dispatch and its load-balance aux term."""
    hm = L.apply_norm(p["mlp_norm"], x, cfg.norm_type)
    if "moe" in p:
        return moe_lib.moe_forward(p["moe"], hm, cfg.moe, rules=rules)
    return (L.swiglu(p["mlp"], hm, rules, cfg.d_ff),
            torch.zeros((), device=x.device))


def _attn_block_fwd(p, x, positions, cfg: ArchConfig, route: str = "kernels",
                    causal: bool = True, memory: Optional[tuple] = None,
                    rules: AxisRules = NO_RULES) -> tuple:
    """Attention (+ cross attention) + SwiGLU or MoE block.  Self-attention
    is causal with the config's sliding window, or bidirectional (an
    encoder's); ``memory``: this layer's cross K/V (B, T_src, n_kv,
    d_head) of the encoder's output (``_cross_kv``).  Returns (x, aux)."""
    h = L.apply_norm(p["attn_norm"], x, cfg.norm_type)
    x = x + L.attention_forward(
        p["attn"], h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.d_head, rope_theta=cfg.rope_theta, causal=causal,
        window=cfg.sliding_window if causal else None, route=route,
        rules=rules)
    if memory is not None:
        hc = L.apply_norm(p["cross_norm"], x, cfg.norm_type)
        x = x + L.attention_forward(
            p["cross"], hc, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            d_head=cfg.d_head, rope_theta=cfg.rope_theta, causal=False,
            use_rope=False, kv_override=memory, route=route, rules=rules)
    y, aux = _ffn(p, x, cfg, rules)
    return x + y, aux


def _cross_kv(p, memory: torch.Tensor, cfg: ArchConfig,
              rules: AxisRules = NO_RULES) -> tuple:
    """A decoder layer's cross-attention K/V of the encoder's output
    (B, T_src, d_model): no RoPE, as in the reference."""
    return L.project_kv(p["cross"], memory, None, n_kv=cfg.n_kv,
                        d_head=cfg.d_head, rope_theta=cfg.rope_theta,
                        use_rope=False, rules=rules)


def _ssm_block_fwd(p, x, cfg: ArchConfig,
                   state: Optional[ssm_lib.SSMState] = None,
                   route: str = "kernels", rules: AxisRules = NO_RULES):
    h = L.apply_norm(p["norm"], x, cfg.norm_type)
    y, new_state = ssm_lib.mamba_forward(p["mamba"], h, cfg.ssm,
                                         chunk=SSM_CHUNK, state=state,
                                         route=route, rules=rules)
    return x + y, new_state


def _embed_inputs(params, cfg: ArchConfig, batch: Dict[str, Any],
                  rules: AxisRules = NO_RULES):
    """Token (+ image) embedding: a VLM's projected ``image_embeds`` come
    first.  Returns (x (B,S,D), positions (B,S)), S counting both."""
    dev = params["embed"]["tok"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = L.embed(params["embed"], tokens, rules,
                (cfg.vocab_padded, cfg.d_model))
    if cfg.family == "vlm" and "image_embeds" in batch:
        img = torch.as_tensor(batch["image_embeds"], device=dev)
        w = L.leaf(params["img_proj"], as_rules(rules),
                   L.PARAM_AXES["img_proj"], (cfg.d_model, cfg.d_model))
        x = torch.cat([img.to(cfg.dtype) @ w, x], dim=1)
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


def _train_layer(lp, x, positions, cfg: ArchConfig,
                 memory: Optional[torch.Tensor] = None,
                 rules: AxisRules = NO_RULES) -> tuple:
    """One layer of the training forward; an enc-dec decoder layer projects
    its cross K/V from the encoder's output ``memory`` here, inside the
    layer's checkpoint (the reference's ``_backbone_with_memory``)."""
    if cfg.family in ("ssm", "hybrid"):
        return (_ssm_block_fwd(lp, x, cfg, route="train", rules=rules)[0],
                torch.zeros((), device=x.device))
    mem_kv = None if memory is None else _cross_kv(lp, memory, cfg, rules)
    return _attn_block_fwd(lp, x, positions, cfg, route="train",
                           memory=mem_kv, rules=rules)


def _hybrid_train(params, x, positions, cfg: ArchConfig,
                  rules: AxisRules = NO_RULES):
    """The hybrid backbone (the reference's ``_hybrid_fwd``): each
    super-block, checkpointed as a whole under ``cfg.remat``, runs its
    Mamba-2 stack through ``_train_stack`` and then the shared attention
    block; the tail's stack follows."""
    n_super, tail = hybrid_layout(cfg)
    shared = params["shared_attn"]
    zero = torch.zeros((), device=x.device)

    def ssm_layer(lp, x):
        return _train_layer(lp, x, positions, cfg, rules=rules)

    def super_block(blk, x):
        x, _ = _train_stack(ssm_layer, x, zero,
                            unbind_layers(blk, cfg.attn_every), cfg)
        return _attn_block_fwd(shared, x, positions, cfg, route="train",
                               rules=rules)[0]

    for blk in unbind_layers(params["blocks"], n_super):
        x = _checkpoint(super_block, blk, x) if cfg.remat \
            else super_block(blk, x)
    if tail:
        x, _ = _train_stack(ssm_layer, x, zero,
                            unbind_layers(params["tail"], tail), cfg)
    return x


def encode(params, cfg: ArchConfig, frames, route: str = "kernels",
           rules: AxisRules = NO_RULES) -> torch.Tensor:
    """The bidirectional encoder over stub frame embeddings (B, T_src,
    d_model), in ``cfg.dtype``, then its final norm.  ``route`` as the
    blocks' (``layers.ROUTES``); "train" runs the stack under the remat of
    ``_train_stack``."""
    L.check_route(route)
    rules = as_rules(rules)
    dev = params["embed"]["tok"].device
    x = torch.as_tensor(frames, device=dev).to(cfg.dtype)
    B, T, _ = x.shape
    positions = torch.arange(T, device=dev).expand(B, T)
    enc = params["encoder"]

    def body(lp, x):
        return _attn_block_fwd(lp, x, positions, cfg, route, causal=False,
                               rules=rules)

    layers = unbind_layers(enc["layers"], cfg.n_enc_layers)
    if route == "train":
        x, _ = _train_stack(body, x, torch.zeros((), device=dev), layers,
                            cfg)
    else:
        for lp in layers:
            x = body(lp, x)[0]
    return L.apply_norm(enc["final_norm"], x, cfg.norm_type)


def _memory(params, cfg: ArchConfig, batch, route: str,
            rules: AxisRules = NO_RULES):
    """An enc-dec batch's encoder output, None for the other families."""
    if not cfg.enc_dec:
        return None
    if "frames" not in batch:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its batch "
                         f"needs 'frames' (B, T_src, d_model) beside the "
                         f"tokens")
    return encode(params, cfg, batch["frames"], route, rules)


def _forward(params, cfg: ArchConfig, batch, rules: AxisRules,
             gather: bool) -> tuple:
    check_supported(cfg)
    x, positions = _embed_inputs(params, cfg, batch, rules)
    memory = _memory(params, cfg, batch, "train", rules)
    extra = () if memory is None else (memory,)   # an enc-dec's decoder
    sharded = {"rules": rules} if rules.enabled else {}
    aux = torch.zeros((), device=x.device)
    if cfg.family == "hybrid":
        x = _hybrid_train(params, x, positions, cfg, rules)
    else:
        x, aux = _train_stack(
            lambda lp, x: _train_layer(lp, x, positions, cfg, *extra,
                                       **sharded), x,
            aux, unbind_layers(params["layers"], cfg.n_layers), cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    return L.unembed(params["embed"], x, rules, cfg.vocab_padded,
                     gather), aux


def forward_train(params, cfg: ArchConfig, batch,
                  rules: AxisRules = NO_RULES):
    """Teacher-forced forward.  Returns (logits (B, S, V), moe aux: the sum
    over layers of each MoE block's load-balance term, a zero for the
    other families).  Gradients reach every parameter leaf that requires
    grad; with ``cfg.remat`` the layers are rematerialised in the backward
    (module docstring), an encoder's too.  A VLM's S counts its image
    tokens.  Under ``rules``: this rank's rows, the whole vocab."""
    return _forward(params, cfg, batch, as_rules(rules), True)


def loss_fn(params, cfg: ArchConfig, batch, rules: AxisRules = NO_RULES,
            aux_weight: float = 0.01):
    """Mean cross-entropy over labeled tokens (labels < 0 are masked) plus
    ``aux_weight`` times the MoE aux term.  A VLM's image positions get
    the label −1.  Returns (loss, metrics).  Under ``rules`` the logits
    stay in vocab blocks (``layers.sharded_softmax_xent``), and the sum of
    the rank's token losses and its token count are ``psum``'d over the
    batch axes: the mean is the global batch's, held by every rank."""
    rules = as_rules(rules)
    logits, aux = _forward(params, cfg, batch, rules, False)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    if cfg.family == "vlm" and "image_embeds" in batch:
        n_img = batch["image_embeds"].shape[1]
        labels = torch.cat([labels.new_full((labels.shape[0], n_img), -1),
                            labels], dim=1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0)
    vax = L.vocab_axis(rules, cfg.vocab_padded)
    per_tok = L.sharded_softmax_xent(logits, safe,
                                     rules.mesh if vax else None, vax)
    per_tok = torch.where(mask, per_tok, 0.0)
    bax = rules.axis("batch")
    n = mesh_utils.psum(mask.sum().float(), bax, mesh=rules.mesh)
    loss = mesh_utils.psum(per_tok.sum(), bax, mesh=rules.mesh) \
        / torch.clamp(n, min=1)
    total = loss + aux_weight * aux
    return total, {"ce": loss, "moe_aux": aux, "tokens": n}


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
    cross: an enc-dec's (k, v) each (L, B, T_src, n_kv, d_head): every
        decoder layer's cross K/V of the encoder's output, written by
        prefill and only read by decode.
    pos: (B,) next position index.
    kv_len, cross_len: the global sequence lengths of the kv and cross
        caches where this rank holds a block of them (flash-decoding under
        ``cache_seq``); 0 where the caches are whole.
    """
    kv: Optional[tuple]
    ssm: Optional[ssm_lib.SSMState]
    cross: Optional[tuple]
    pos: torch.Tensor
    kv_len: int = 0
    cross_len: int = 0


def _cache_len(cfg: ArchConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def _seq_split(rules: AxisRules, S: int) -> tuple:
    """(this rank's slots, the global length or 0) of a cache of S slots
    under ``rules``: a block over ``cache_seq`` where its axis divides S."""
    ax = L.dim_axis(rules, "cache_seq", S)
    return (S, 0) if ax is None else (S // rules.size(ax), S)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device="cuda", rules: AxisRules = NO_RULES
                      ) -> DecodeState:
    """Zero caches for ``batch`` sequences of up to ``max_len`` positions
    (a VLM's image tokens count).  An enc-dec's cross caches hold
    ``cfg.source_len`` frames (else ``max_len``), as the reference's;
    ``prefill`` builds them from the encoder's output instead.  Under
    ``rules``, ``batch`` counts this rank's sequences and the caches are
    its blocks (``DecodeState``)."""
    rules = as_rules(rules)
    state = _self_caches(cfg, batch, max_len, resolve_device(device), rules)
    if not cfg.enc_dec:
        return state
    src, src_len = _seq_split(rules, cfg.source_len or max_len)
    return state._replace(cross=tuple(
        torch.zeros(cfg.n_layers, batch, src, cfg.n_kv, cfg.d_head,
                    dtype=cfg.dtype, device=state.pos.device)
        for _ in range(2)), cross_len=src_len)


def _self_caches(cfg: ArchConfig, batch: int, max_len: int,
                 dev: torch.device, rules: AxisRules = NO_RULES
                 ) -> DecodeState:
    """``init_decode_state`` without an enc-dec's cross caches."""
    check_supported(cfg)
    S, kv_len = _seq_split(rules, _cache_len(cfg, max_len))
    kv = None
    ssm_state = None
    if cfg.family != "ssm":
        n_kv_layers = hybrid_layout(cfg)[0] if cfg.family == "hybrid" \
            else cfg.n_layers
        kv = tuple(torch.zeros(n_kv_layers, batch, S, cfg.n_kv, cfg.d_head,
                               dtype=cfg.dtype, device=dev)
                   for _ in range(2))
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm.d_inner
        di //= rules.size(L.local_axis(
            rules, "ssm_inner", di,
            cfg.ssm.headdim if cfg.ssm.version == 2 else 1))
        ssm_state = ssm_lib.SSMState(
            conv=torch.zeros(cfg.n_layers, batch, cfg.ssm.conv_kernel - 1,
                             di, dtype=cfg.dtype, device=dev),
            ssm=torch.zeros(cfg.n_layers, batch, di, cfg.ssm.d_state,
                            device=dev))
    return DecodeState(kv=kv, ssm=ssm_state, cross=None,
                       pos=torch.zeros(batch, dtype=torch.int32,
                                       device=dev), kv_len=kv_len)


def _attn_decode_layer(lp, x, ck, cv, pos, cfg: ArchConfig,
                       cross: Optional[tuple] = None,
                       rules: AxisRules = NO_RULES, kv_len: int = 0,
                       cross_len: int = 0) -> tuple:
    """One attention block's decode step against its caches ck, cv (B, S,
    n_kv, d_head): (x, this layer's new k, v (B, 1, n_kv, d_head)); the
    caller writes them once for all layers.  ``cross``: an enc-dec
    layer's cross K/V (B, T_src, n_kv, d_head), every slot valid (the
    reference's pos = T_src − 1, no new-token term)."""
    h = L.apply_norm(lp["attn_norm"], x, cfg.norm_type)
    o, nk, nv = L.attention_decode(
        lp["attn"], h, ck, cv, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.d_head, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window, rules=rules, s_total=kv_len)
    x = x + o
    if cross is not None:
        xk, xv = cross
        t_src = cross_len or xk.shape[1]
        hc = L.apply_norm(lp["cross_norm"], x, cfg.norm_type)
        oc, _, _ = L.attention_decode(
            lp["cross"], hc, xk, xv, torch.full_like(pos, t_src - 1),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta, use_rope=False, update_cache=False,
            rules=rules, s_total=cross_len)
        x = x + oc
    return x + _ffn(lp, x, cfg, rules)[0], nk, nv


def _ssm_decode_layer(lp, x, ssm_state: ssm_lib.SSMState, i: int,
                      cfg: ArchConfig, rules: AxisRules = NO_RULES):
    """Mamba layer i's decode step; its state slot i is updated in place."""
    h = L.apply_norm(lp["norm"], x, cfg.norm_type)
    y, st = ssm_lib.mamba_decode_step(
        lp["mamba"], h, ssm_lib.SSMState(conv=ssm_state.conv[i],
                                         ssm=ssm_state.ssm[i]), cfg.ssm,
        rules)
    ssm_state.conv[i] = st.conv
    ssm_state.ssm[i] = st.ssm
    return x + y


def decode_step(params, cfg: ArchConfig, state: DecodeState,
                tokens, rules: AxisRules = NO_RULES) -> tuple:
    """One greedy decode step.  tokens: (B, 1) -> (logits (B, V), new
    state).  The caches of ``state`` are updated in place."""
    check_supported(cfg)
    rules = as_rules(rules)
    lens = dict(rules=rules, kv_len=state.kv_len,
                cross_len=state.cross_len)
    x, _ = _embed_inputs(params, cfg, {"tokens": tokens}, rules)
    pos = state.pos
    new_kv = state.kv
    nks, nvs = [], []
    if cfg.family in ATTN_FAMILIES:
        for i in range(cfg.n_layers):
            cross = None if state.cross is None else (state.cross[0][i],
                                                      state.cross[1][i])
            x, nk, nv = _attn_decode_layer(layer(params["layers"], i), x,
                                           state.kv[0][i], state.kv[1][i],
                                           pos, cfg, cross, **lens)
            nks.append(nk)
            nvs.append(nv)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_decode_layer(layer(params["layers"], i), x, state.ssm,
                                  i, cfg, rules)
    else:   # hybrid: the super-blocks, then the tail
        n_super, tail = hybrid_layout(cfg)
        per = cfg.attn_every
        for s in range(n_super):
            blk = layer(params["blocks"], s)
            for j in range(per):
                x = _ssm_decode_layer(layer(blk, j), x, state.ssm,
                                      s * per + j, cfg, rules)
            x, nk, nv = _attn_decode_layer(params["shared_attn"], x,
                                           state.kv[0][s], state.kv[1][s],
                                           pos, cfg, **lens)
            nks.append(nk)
            nvs.append(nv)
        for j in range(tail):
            x = _ssm_decode_layer(layer(params["tail"], j), x, state.ssm,
                                  n_super * per + j, cfg, rules)
    if nks:    # one stacked cache write, after the layers
        new_kv = tuple(L.update_cache_stack(c, torch.stack(n), pos,
                                            cfg.sliding_window,
                                            state.kv_len, rules)
                       for c, n in zip(state.kv, (nks, nvs)))
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = L.unembed(params["embed"], x, rules, cfg.vocab_padded)[:, 0]
    return logits, state._replace(kv=new_kv, pos=pos + 1)


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
            max_len: int, route: str = "kernels",
            rules: AxisRules = NO_RULES) -> tuple:
    """Process a full prompt, building the decode caches.

    Returns (last-token logits (B, V), DecodeState at pos = prompt
    length, a VLM's image tokens included).  Each attention block projects
    its K/V into its cache beside the block's own forward, as the
    reference does (a hybrid's shared block into its super-block's cache;
    an enc-dec decoder layer its cross K/V of the encoder's output into
    ``DecodeState.cross`` too).  Without a sliding window ``max_len`` must
    hold the whole prompt (``ValueError`` otherwise).
    ``route``: "kernels" (the forward kernels) or "plain" (no hand-written
    kernel; the caller asks for it, it is never a fallback).  A cache
    shorter than the prompt (a sliding window) keeps the last Sc positions,
    position p in slot ``p % Sc`` — where decode's rolling writes and its
    stale-slot mask expect it.  (The reference keeps them in slots
    0..Sc−1, which agrees with that only when Sc divides the prompt
    length.)"""
    check_supported(cfg)
    L.check_route(route)
    rules = as_rules(rules)
    x, positions = _embed_inputs(params, cfg, batch, rules)
    B, S, _ = x.shape
    if cfg.sliding_window is None and max_len < S:
        raise ValueError(f"max_len {max_len} cannot hold the prompt's {S} "
                         f"positions (image tokens included)")
    memory = _memory(params, cfg, batch, route, rules)
    state = _self_caches(cfg, B, max_len, x.device, rules)
    cross = []      # an enc-dec's cross K/V, layer by layer

    def rank_block(t, total, dim=1):
        """This rank's block along ``dim`` of a sequence of ``total`` slots
        held over ``cache_seq`` (``DecodeState``); the whole when 0."""
        if not total:
            return t
        ax = rules.axis("cache_seq")
        n = total // rules.size(ax)
        return t.narrow(dim, rules.index(ax) * n, n)

    def attn_layer(lp, x, i):
        """The block's forward, its K/V into cache slot i (an enc-dec
        layer's cross K/V appended to ``cross``)."""
        ck, cv = state.kv[0][i], state.kv[1][i]
        k, v = L.project_kv(lp["attn"], L.apply_norm(
            lp["attn_norm"], x, cfg.norm_type), positions,
            n_kv=cfg.n_kv, d_head=cfg.d_head, rope_theta=cfg.rope_theta,
            rules=rules)
        mem_kv = None
        if memory is not None:
            mem_kv = _cross_kv(lp, memory, cfg, rules)
            cross.append(mem_kv)
        x = _attn_block_fwd(lp, x, positions, cfg, route, memory=mem_kv,
                            rules=rules)[0]
        Sc = state.kv_len or ck.shape[1]
        if Sc >= S:
            k = torch.cat([k, k.new_zeros(B, Sc - S, *k.shape[2:])], 1)
            v = torch.cat([v, v.new_zeros(B, Sc - S, *v.shape[2:])], 1)
        else:  # the last Sc positions, p in slot p % Sc
            k, v = (t[:, -Sc:].roll(S % Sc, dims=1) for t in (k, v))
        ck.copy_(rank_block(k, state.kv_len))
        cv.copy_(rank_block(v, state.kv_len))
        return x

    def ssm_layer(lp, x, i):
        """The block's forward, its final state into slot i."""
        x, st = _ssm_block_fwd(lp, x, cfg, route=route, rules=rules)
        state.ssm.conv[i] = st.conv
        state.ssm.ssm[i] = st.ssm
        return x

    if cfg.family in ATTN_FAMILIES:
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
    state = state._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=x.device))
    if cross:
        t_src = cross[0][0].shape[1]
        state = state._replace(cross_len=_seq_split(rules, t_src)[1])
        state = state._replace(cross=tuple(
            rank_block(torch.stack(t), state.cross_len, 2)
            .to(cfg.dtype).contiguous() for t in zip(*cross)))
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type)
    logits = L.unembed(params["embed"], x[:, -1:], rules,
                       cfg.vocab_padded)[:, 0]
    return logits, state
