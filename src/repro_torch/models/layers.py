"""Shared LM layers: norms, RoPE, GQA attention, SwiGLU, embeddings and
the token cross-entropy.

Port of the JAX package's ``repro/models/layers.py`` for one device: the
logical-axis sharding rules (``AxisRules``), the cache-sharded decode branch
and the vocab-sharded loss wait for later slices.  Layouts are the
reference's — activations (B, S, d), attention heads (B, S, H, d_head),
stacked caches (L, B, S, n_kv, d_head) — so the tests compare like with
like.

Full-sequence attention computes the function of the reference's pure-JAX
``_chunked_attention``: causal self-attention with or without a sliding
window, bidirectional self-attention (an encoder's), and cross attention
over another sequence's keys and values (``kv_override``: a decoder over
its encoder's memory, Sk ≠ Sq), along one of three routes the caller
names:

  "kernels"  prefill: the flash-attention forward kernel (no gradient);
  "train"    training: ``ops.attention_train``, the forward-with-lse and
             backward kernels under autograd;
  "plain"    no hand-written kernel: the forward's plain PyTorch version
             (the output guard's re-run of a wave).

On a CPU tensor the kernel routes run the kernels' plain versions.  Decode
attention stays plain PyTorch, as in the reference.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from repro_torch import slices
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops

Params = Mapping[str, torch.Tensor]
ROUTES = ("kernels", "train", "plain")


def check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}; got {route!r}")

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(params: Params, x: torch.Tensor,
               norm_type: str) -> torch.Tensor:
    if norm_type == "rms":
        return rms_norm(x, params["scale"])
    return layer_norm(x, params["scale"], params["bias"])


def init_norm(d: int, norm_type: str, device="cuda") -> dict:
    if norm_type == "rms":
        return {"scale": torch.ones(d, device=device)}
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


# ---------------------------------------------------------------------------
# RoPE (the half-split rotation: the first and second halves of d_head pair)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / SwiGLU
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, din: int, dout: int,
                dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    w = torch.randn(din, dout, generator=gen, device=device)
    return (w / math.sqrt(din)).to(dtype)


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.bfloat16, device="cuda") -> dict:
    return {"w_gate": init_linear(gen, d_model, d_ff, dtype, device),
            "w_up": init_linear(gen, d_model, d_ff, dtype, device),
            "w_down": init_linear(gen, d_ff, d_model, dtype, device)}


# ---------------------------------------------------------------------------
# Attention (GQA, RoPE)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, d_head: int, dtype=torch.bfloat16,
                   device="cuda") -> dict:
    return {
        "wq": init_linear(gen, d_model, n_heads * d_head, dtype, device),
        "wk": init_linear(gen, d_model, n_kv * d_head, dtype, device),
        "wv": init_linear(gen, d_model, n_kv * d_head, dtype, device),
        "wo": init_linear(gen, n_heads * d_head, d_model, dtype, device),
    }


def attention_forward(params: Params, x: torch.Tensor,
                      positions: torch.Tensor, *, n_heads: int, n_kv: int,
                      d_head: int, rope_theta: float, causal: bool = True,
                      window: Optional[int] = None, use_rope: bool = True,
                      kv_override: Optional[tuple] = None,
                      route: str = "kernels") -> torch.Tensor:
    """Full-sequence attention (train / prefill): (B, S, d_model) ->
    (B, S, d_model) along ``route`` (module docstring).  Query head h
    reads KV head h // (n_heads / n_kv), the order of the reference's
    ``jnp.repeat``; every route takes the KV heads unexpanded.  ``window``:
    each query sees its last ``window`` positions, itself included.
    ``kv_override``: (k, v) in (B, Sk, n_kv, d_head), already projected
    (``project_kv``), for cross attention (``causal=False``); RoPE then
    applies to q alone, where ``use_rope``, as in the reference."""
    check_route(route)
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, d_head)
    if "q_norm" in params:  # qwen3-style per-head QK norm
        q = rms_norm(q, params["q_norm"])
    if kv_override is None:
        k = (x @ params["wk"]).reshape(B, S, n_kv, d_head)
        v = (x @ params["wv"]).reshape(B, S, n_kv, d_head)
        if "k_norm" in params:
            k = rms_norm(k, params["k_norm"])
        if use_rope:
            k = apply_rope(k, positions, rope_theta)
    else:
        k, v = kv_override
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
    attend = {"kernels": flash_ops.attention,
              "train": flash_ops.attention_train,
              "plain": flash_kernel.flash_attention_plain}[route]
    o = attend(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
               v.transpose(1, 2).contiguous(), causal=causal, window=window)
    o = o.transpose(1, 2).reshape(B, S, n_heads * d_head)
    return o @ params["wo"]


def project_kv(params: Params, x: torch.Tensor, positions, *, n_kv: int,
               d_head: int, rope_theta: float, use_rope: bool = True):
    """K/V projection only (for building caches and an encoder memory's
    cross-attention K/V).  Applies the optional per-head k_norm before
    RoPE — the order attention_forward and attention_decode use, so cache
    contents match the in-context values."""
    B, S, _ = x.shape
    k = (x @ params["wk"]).reshape(B, S, n_kv, d_head)
    v = (x @ params["wv"]).reshape(B, S, n_kv, d_head)
    if "k_norm" in params:
        k = rms_norm(k, params["k_norm"])
    if use_rope:
        k = apply_rope(k, positions, rope_theta)
    return k, v


def attention_decode(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor, *,
                     n_heads: int, n_kv: int, d_head: int, rope_theta: float,
                     use_rope: bool = True, window: Optional[int] = None,
                     update_cache: bool = True, kv_chunk: int = 2048):
    """Single-token decode against a (B, S_cache, n_kv, d_head) cache.

    Never writes the cache: returns (out, k_new, v_new) with k_new/v_new
    (B, 1, n_kv, d_head); the caller stacks them across layers and writes
    them once (``update_cache_stack``).  The new token's term is folded
    into the online-softmax merge, so the sweep sees only the slots already
    written.  ``update_cache=False`` (a static memory) sweeps the slots
    <= pos inclusively and adds no new-token term."""
    B = x.shape[0]
    S = cache_k.shape[1]
    q = (x @ params["wq"]).reshape(B, 1, n_heads, d_head)
    k_new = (x @ params["wk"]).reshape(B, 1, n_kv, d_head)
    v_new = (x @ params["wv"]).reshape(B, 1, n_kv, d_head)
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k_new = rms_norm(k_new, params["k_norm"])
    if use_rope:
        q = apply_rope(q, pos[:, None], rope_theta)
        k_new = apply_rope(k_new, pos[:, None], rope_theta)

    group = n_heads // n_kv
    qg = q.reshape(B, n_kv, group, d_head).float()
    scale = 1.0 / d_head ** 0.5
    rolling = window is not None and S == window
    m, l, acc = _decode_sweep(qg, cache_k, cache_v, pos, 0, scale=scale,
                              rolling=rolling, s_total=S, kv_chunk=kv_chunk,
                              strict=update_cache)
    if update_cache:
        # fold in the just-computed token (slot pos, not yet in the cache)
        s_new = torch.einsum("bkgd,bkd->bkg", qg,
                             k_new[:, 0].float())[..., None] * scale
        m_f = torch.maximum(m, s_new)
        p_new = torch.exp(s_new - m_f)
        alpha = torch.exp(m - m_f)
        l = alpha * l + p_new
        acc = acc * alpha + p_new * v_new[:, 0, :, None, :].float()
    o = acc / torch.where(l == 0.0, 1.0, l)
    o = o.reshape(B, 1, n_heads * d_head).to(x.dtype)
    return (o @ params["wo"], k_new.to(cache_k.dtype),
            v_new.to(cache_v.dtype))


def update_cache_stack(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor,
                       window: Optional[int] = None) -> torch.Tensor:
    """Write a stacked (L, B, 1, n_kv, d) slab of new K or V vectors into a
    (L, B, S, n_kv, d) stacked cache at slot ``pos`` — one write per decode
    step, outside the layer loop.  Unlike the reference, whose arrays are
    immutable, the write is in place: the cache passed in is returned,
    updated (a full copy of every layer's cache per token would double the
    decode state's memory)."""
    S = cache.shape[2]
    slot = pos[:1] % window if (window is not None and S == window) \
        else pos[:1]
    return cache.index_copy_(2, slot.long(), new.to(cache.dtype))


def _decode_sweep(qg: torch.Tensor, kloc: torch.Tensor, vloc: torch.Tensor,
                  pos: torch.Tensor, start: int, *, scale: float,
                  rolling: bool, s_total: int, kv_chunk: int,
                  strict: bool = True):
    """Online-softmax sweep of a cache slice.

    qg: (B, n_kv, group, d); kloc/vloc: (B, S_loc, n_kv, d); start: global
    index of slot 0.  Chunking bounds the fp32 working set to one kv_chunk
    slab.  ``strict``: mask slot ``pos`` itself (deferred cache write);
    False sweeps <= pos.  The products take q and p in the cache's dtype
    with fp32 accumulation, as the reference's native-dtype dots with
    ``preferred_element_type=float32`` do.  Returns running (m, l, acc)."""
    B, n_kv, group, d_head = qg.shape
    S_loc = kloc.shape[1]
    ck = min(kv_chunk, S_loc)
    while S_loc % ck:
        ck -= 1
    qg_c = qg.to(kloc.dtype).float()
    p0 = pos[0]
    m = torch.full((B, n_kv, group, 1), -1e30, device=qg.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, n_kv, group, d_head, device=qg.device)
    for c0 in range(0, S_loc, ck):
        kblk = kloc[:, c0:c0 + ck].float()         # (B, ck, n_kv, d)
        vblk = vloc[:, c0:c0 + ck].float()
        s = torch.einsum("bkgd,bskd->bkgs", qg_c, kblk) * scale
        idx = start + c0 + torch.arange(ck, device=qg.device)
        if rolling:
            # window wrapped: every slot valid except the stale one being
            # overwritten this step; before wrapping, older slots only
            wrapped = p0 + 1 >= s_total
            stale = idx == (p0 % s_total)
            valid = torch.where(wrapped, ~stale, idx < p0)
        elif strict:  # slot pos not yet written (deferred update)
            valid = idx < p0
        else:         # static memory: everything up to pos inclusive
            valid = idx <= p0
        s = torch.where(valid[None, None, None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bkgs,bskd->bkgd", p.to(vloc.dtype).float(), vblk)
        m = m_new
    return m, l, acc


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.bfloat16, device="cuda") -> dict:
    tok = torch.randn(vocab, d_model, generator=gen, device=device) * 0.02
    return {"tok": tok.to(dtype),
            "out": init_linear(gen, d_model, vocab, dtype, device)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["out"]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def sharded_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                         mesh=None, vocab_axis: Optional[str] = None
                         ) -> torch.Tensor:
    """Per-token cross-entropy (B, S) from logits (B, S, V) and labels
    (B, S), in fp32, the logsumexp over the whole (padded) vocab as in the
    reference's unsharded branch.  A vocab axis (the reference's
    shard_map'd loss) raises, naming the slice that brings the sharding
    tables."""
    if mesh is not None or vocab_axis is not None:
        raise slices.not_ported("the vocab-sharded loss",
                                slices.SHARDING_TABLES)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return lse - ll
