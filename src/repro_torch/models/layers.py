"""Shared LM layers: norms, RoPE, GQA attention, SwiGLU, embeddings and
the token cross-entropy.

Port of the JAX package's ``repro/models/layers.py``.  Layouts are the
reference's — activations (B, S, d), attention heads (B, S, H, d_head),
stacked caches (L, B, S, n_kv, d_head) — so the tests compare like with
like.

**Sharding (explicit SPMD).**  ``AxisRules`` maps logical axis names to
mesh axes, as the reference's does, and ``PARAM_AXES`` names every
parameter's logical axes.  Where the reference writes unsharded code with
``rules.constrain`` hints and GSPMD inserts the communication, each rank
here holds its block of every tensor and the functions issue the
collectives themselves (``runtime.mesh_utils``, whose backward formulas
make them differentiable), so the hand-written kernels always see plain
local tensors.  A leaf dimension is held in blocks over its mesh axis when
the axis size divides it (``dim_axis``), else whole.  A function keeps a
dimension local where its blocks hold whole units of the computation
(heads, experts, channels) and otherwise gathers the leaf over the axis
before use (``leaf``), so its function never changes with the mesh:

  attention  "head" plan (``heads`` on an axis): each rank runs its
             Hq/n query heads through the flash kernels at the local
             shape, the KV heads they read (its own block, or a gathered
             leaf where the block holds no whole heads), and ``wo`` row-
             parallel with a ``psum``; "seq" plan (``seq_attn``, phi3):
             the queries of this rank's slice of the sequence against the
             gathered K/V; otherwise every head on every rank;
  SwiGLU     ``w_gate``/``w_up`` column-parallel over ``ff``, ``w_down``
             row-parallel with a ``psum``;
  embedding  ``tok``'s columns over ``embed_model``, the looked-up rows
             all-gathered; ``out`` vocab-sharded, the loss on the blocks
             (``sharded_softmax_xent``);
  FSDP       a leaf held in blocks over ``data`` (``embed`` in training)
             is all-gathered before use; its gradient comes back reduce-
             scattered (``all_gather``'s backward);
  decode     flash-decoding over a ``cache_seq``-sharded cache.

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

import dataclasses
import math
from typing import Any, Mapping, Optional

import torch

from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.runtime import mesh_utils
from repro_torch.runtime.mesh_utils import P

Params = Mapping[str, torch.Tensor]
ROUTES = ("kernels", "train", "plain")


def check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}; got {route!r}")


# ---------------------------------------------------------------------------
# Logical-axis sharding rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Maps logical axis names to mesh axis names (a name, a tuple of
    names, or None = replicated) on ``mesh`` (a ``DeviceMesh``)."""
    rules: Mapping[str, Any]
    mesh: Any = None
    enabled: bool = True

    def spec(self, *logical: Optional[str]) -> P:
        return P(*(self.rules.get(a) if a is not None else None
                   for a in logical))

    def axis(self, logical: Optional[str]):
        """The mesh axis ``logical`` maps to; None when it maps to none,
        the rules are off or there is no mesh."""
        if not self.enabled or self.mesh is None or logical is None:
            return None
        return self.rules.get(logical)

    def size(self, axis) -> int:
        """The number of ranks along mesh ``axis`` (1 for None)."""
        return 1 if axis is None else mesh_utils.axis_size(self.mesh, axis)

    def index(self, axis) -> int:
        """This rank's coordinate along mesh ``axis`` (0 for None)."""
        return 0 if axis is None else mesh_utils.axis_index(self.mesh, axis)


NO_RULES = AxisRules(rules={}, mesh=None, enabled=False)


def as_rules(rules) -> AxisRules:
    return NO_RULES if rules is None else rules


# name suffix -> logical axes (leading stacked-layer axes are None)
PARAM_AXES = {
    "embed/tok": ("vocab_table", "embed_model"),
    "embed/out": (None, "vocab"),
    "attn/wq": ("embed", "qkv_out"),
    "attn/wk": ("embed", "qkv_out"),
    "attn/wv": ("embed", "qkv_out"),
    "attn/wo": ("qkv_out", "embed"),
    "attn/q_norm": (None,),
    "attn/k_norm": (None,),
    "cross/wq": ("embed", "qkv_out"),
    "cross/wk": ("embed", "qkv_out"),
    "cross/wv": ("embed", "qkv_out"),
    "cross/wo": ("qkv_out", "embed"),
    "mlp/w_gate": ("embed", "ff"),
    "mlp/w_up": ("embed", "ff"),
    "mlp/w_down": ("ff", "embed"),
    "moe/router": (None, None),
    "moe/w_gate": ("experts", "embed", None),
    "moe/w_up": ("experts", "embed", None),
    "moe/w_down": ("experts", None, "embed"),
    "mamba/in_proj": ("embed", "ssm_proj"),
    "mamba/conv_w": (None, "ssm_inner"),
    "mamba/conv_b": ("ssm_inner",),
    "mamba/out_proj": ("ssm_inner", "embed"),
    "mamba/x_proj": ("ssm_inner", None),
    "mamba/dt_proj": (None, "ssm_inner"),
    "mamba/dt_bias": ("ssm_inner",),
    "mamba/A_log": ("ssm_inner", None),
    "mamba/D": ("ssm_inner",),
    "mamba/bc_proj": ("ssm_inner", None),
    # mamba2 per-head vectors (distinct names; tiny -> replicated)
    "mamba/dt_head_proj": ("ssm_inner", None),
    "mamba/dt_head_bias": (None,),
    "mamba/a_log_h": (None,),
    "mamba/d_h": (None,),
    "img_proj": ("embed", None),
}


def dim_axis(rules: AxisRules, logical: Optional[str], extent: int):
    """The mesh axis a leaf dimension of ``extent`` under ``logical`` is
    held in blocks over: the rule's axis where its size divides the
    extent, else None (the dimension is held whole)."""
    ax = rules.axis(logical)
    if ax is None or extent % rules.size(ax):
        return None
    return ax


def leaf(w: torch.Tensor, rules: AxisRules, axes: tuple, full: tuple,
         keep: tuple = ()) -> torch.Tensor:
    """This rank's block ``w`` of a leaf of logical ``axes`` and global
    shape ``full``, all-gathered over the axis of every dimension held in
    blocks, except those whose logical axis is in ``keep``."""
    for d, (la, n) in enumerate(zip(axes, full)):
        ax = dim_axis(rules, la, n)
        if ax is not None and la not in keep:
            w = mesh_utils.all_gather(w, ax, d, mesh=rules.mesh)
    return w


def local_axis(rules: AxisRules, logical: str, extent: int, unit: int = 1):
    """The mesh axis over which a dimension of ``extent`` under
    ``logical`` is computed in local blocks, each of whole units of
    ``unit`` (heads of d_head columns, ...); None when the blocks would
    split a unit (the leaf is then gathered)."""
    ax = dim_axis(rules, logical, extent)
    if ax is None or (extent // unit) % rules.size(ax):
        return None
    return ax

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


def swiglu(params: Params, x: torch.Tensor, rules: AxisRules = NO_RULES,
           d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x@gate) * (x@up) ).  Under ``rules`` (x the
    rank's rows, replicated over the model axis; ``d_ff`` the global
    hidden width) the hidden units are split over ``ff`` and the output is
    ``psum``'d."""
    rules = as_rules(rules)
    d = x.shape[-1]
    F = d_ff if d_ff is not None else params["w_gate"].shape[-1]
    ax = local_axis(rules, "ff", F)
    keep = ("ff",) if ax is not None else ()
    wg = leaf(params["w_gate"], rules, PARAM_AXES["mlp/w_gate"], (d, F), keep)
    wu = leaf(params["w_up"], rules, PARAM_AXES["mlp/w_up"], (d, F), keep)
    wd = leaf(params["w_down"], rules, PARAM_AXES["mlp/w_down"], (F, d),
              keep)
    g = x @ wg
    u = x @ wu
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return mesh_utils.psum(h @ wd, ax, mesh=rules.mesh)


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


def _kv_heads(n_heads: int, n_kv: int, q0: int, hq: int) -> list:
    """The KV heads that query heads q0..q0+hq−1 read, in query order
    (query head h reads KV head h // (n_heads / n_kv)), each once when the
    queries share them in equal runs (GQA at the local shape), else one
    per query head."""
    g = n_heads // n_kv
    idx = [(q0 + i) // g for i in range(hq)]
    uniq = sorted(set(idx))
    if hq % len(uniq) == 0 and idx == [u for u in uniq
                                       for _ in range(hq // len(uniq))]:
        return uniq
    return idx


def attention_plan(rules: AxisRules, n_heads: int, n_kv: int, d_head: int,
                   S: int) -> tuple:
    """How full-sequence attention splits under ``rules``: ("head", axis)
    where ``heads`` maps to the axis ``wq``'s columns are held over and
    it divides the query heads; ("seq", axis) where ``seq_attn`` maps to
    an axis that divides S; ("all", None) otherwise (every head on every
    rank)."""
    ax = rules.axis("heads")
    if ax is not None and local_axis(rules, "qkv_out", n_heads * d_head,
                                     d_head) == ax:
        return "head", ax
    ax = rules.axis("seq_attn")
    if ax is not None and S % rules.size(ax) == 0:
        return "seq", ax
    return "all", None


def _proj_heads(x, w, rules, d_model, n, d_head, local: bool):
    """x @ w as (B, S, heads, d_head): this rank's block of the heads when
    ``local``, else every head (the leaf gathered)."""
    axes = PARAM_AXES["attn/wq"]
    w = leaf(w, rules, axes, (d_model, n * d_head),
             ("qkv_out",) if local else ())
    y = x @ w
    return y.reshape(*x.shape[:2], -1, d_head)


def attention_forward(params: Params, x: torch.Tensor,
                      positions: torch.Tensor, *, n_heads: int, n_kv: int,
                      d_head: int, rope_theta: float, causal: bool = True,
                      window: Optional[int] = None, use_rope: bool = True,
                      kv_override: Optional[tuple] = None,
                      route: str = "kernels",
                      rules: AxisRules = NO_RULES) -> torch.Tensor:
    """Full-sequence attention (train / prefill): (B, S, d_model) ->
    (B, S, d_model) along ``route`` (module docstring).  Query head h
    reads KV head h // (n_heads / n_kv), the order of the reference's
    ``jnp.repeat``; every route takes the KV heads unexpanded.  ``window``:
    each query sees its last ``window`` positions, itself included.
    ``kv_override``: (k, v) in (B, Sk, n_kv, d_head), already projected
    (``project_kv``, every head), for cross attention (``causal=False``);
    RoPE then applies to q alone, where ``use_rope``, as in the reference.
    Under ``rules`` x is the rank's rows, replicated over the model axis,
    and so is the output (``attention_plan``)."""
    check_route(route)
    rules = as_rules(rules)
    B, S, d = x.shape
    plan, ax = attention_plan(rules, n_heads, n_kv, d_head, S)
    n = rules.size(ax)
    r = rules.index(ax)
    hq = n_heads // n if plan == "head" else n_heads
    q0 = r * hq if plan == "head" else 0
    kv_local = plan == "head" and local_axis(
        rules, "qkv_out", n_kv * d_head, d_head) == ax
    kv_sel = None
    if plan == "head" and not kv_local:
        kv_sel = _kv_heads(n_heads, n_kv, q0, hq)
    x_q, pos_q = x, positions
    if plan == "seq":
        s_loc = S // n
        x_q = x[:, r * s_loc:(r + 1) * s_loc]
        pos_q = None if positions is None else \
            positions[:, r * s_loc:(r + 1) * s_loc]
    q = _proj_heads(x_q, params["wq"], rules, d, n_heads, d_head,
                    plan == "head")
    if "q_norm" in params:  # qwen3-style per-head QK norm
        q = rms_norm(q, params["q_norm"])
    if kv_override is None:
        x_kv, pos_kv = (x_q, pos_q) if plan == "seq" else (x, positions)
        k = _proj_heads(x_kv, params["wk"], rules, d, n_kv, d_head, kv_local)
        v = _proj_heads(x_kv, params["wv"], rules, d, n_kv, d_head, kv_local)
        if "k_norm" in params:
            k = rms_norm(k, params["k_norm"])
        if use_rope:
            k = apply_rope(k, pos_kv, rope_theta)
        if plan == "seq":   # every rank's slice of K/V
            k = mesh_utils.all_gather(k, ax, 1, mesh=rules.mesh)
            v = mesh_utils.all_gather(v, ax, 1, mesh=rules.mesh)
    else:
        k, v = kv_override
        if kv_local:
            hk = n_kv // n
            k, v = k[:, :, r * hk:(r + 1) * hk], v[:, :, r * hk:(r + 1) * hk]
    if kv_sel is not None:
        k, v = k[:, :, kv_sel], v[:, :, kv_sel]
    if use_rope:
        q = apply_rope(q, pos_q, rope_theta)
    attend = {"kernels": flash_ops.attention,
              "train": flash_ops.attention_train,
              "plain": flash_kernel.flash_attention_plain}[route]
    Sq = q.shape[1]
    if plan == "seq" and causal:
        # queries at positions r·s_loc.. against keys 0..(r+1)·s_loc − 1:
        # the causal kernel over that prefix, the earlier query rows zero
        # (their outputs are dropped, and a zero output row sends no
        # gradient back to the keys)
        end = (r + 1) * Sq
        k, v = k[:, :end], v[:, :end]
        q = torch.cat([q.new_zeros(B, end - Sq, *q.shape[2:]), q], dim=1)
    o = attend(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
               v.transpose(1, 2).contiguous(), causal=causal, window=window)
    o = o.transpose(1, 2)[:, -Sq:].reshape(B, Sq, hq * d_head)
    wo = leaf(params["wo"], rules, PARAM_AXES["attn/wo"],
              (n_heads * d_head, d), ("qkv_out",) if plan == "head" else ())
    out = o @ wo
    if plan == "head":
        return mesh_utils.psum(out, ax, mesh=rules.mesh)
    if plan == "seq":
        return mesh_utils.all_gather(out, ax, 1, mesh=rules.mesh)
    return out


def project_kv(params: Params, x: torch.Tensor, positions, *, n_kv: int,
               d_head: int, rope_theta: float, use_rope: bool = True,
               rules: AxisRules = NO_RULES):
    """K/V projection only (for building caches and an encoder memory's
    cross-attention K/V), every KV head.  Applies the optional per-head
    k_norm before RoPE — the order attention_forward and attention_decode
    use, so cache contents match the in-context values."""
    rules = as_rules(rules)
    k = _linear_full(x, params["wk"], rules, n_kv * d_head)
    v = _linear_full(x, params["wv"], rules, n_kv * d_head)
    B, S, _ = x.shape
    k = k.reshape(B, S, n_kv, d_head)
    v = v.reshape(B, S, n_kv, d_head)
    if "k_norm" in params:
        k = rms_norm(k, params["k_norm"])
    if use_rope:
        k = apply_rope(k, positions, rope_theta)
    return k, v


def _linear_full(x: torch.Tensor, w: torch.Tensor, rules: AxisRules,
                 n_out: int) -> torch.Tensor:
    """x @ w for an (embed, qkv_out) leaf, every output column on every
    rank: the rank's columns, all-gathered (the activations are smaller
    than the leaf at decode)."""
    axes = PARAM_AXES["attn/wq"]
    ax = dim_axis(rules, "qkv_out", n_out)
    y = x @ leaf(w, rules, axes, (x.shape[-1], n_out), ("qkv_out",))
    return mesh_utils.all_gather(y, ax, -1, mesh=rules.mesh)


def _linear_rows(x: torch.Tensor, w: torch.Tensor, rules: AxisRules,
                 d_out: int) -> torch.Tensor:
    """x @ w for a (qkv_out, embed) leaf with x whole on every rank: the
    rank's block of x's columns against its rows, ``psum``'d."""
    n_in = x.shape[-1]
    ax = dim_axis(rules, "qkv_out", n_in)
    w = leaf(w, rules, PARAM_AXES["attn/wo"], (n_in, d_out), ("qkv_out",))
    if ax is not None:
        c = n_in // rules.size(ax)
        x = x.narrow(-1, rules.index(ax) * c, c)
    return mesh_utils.psum(x @ w, ax, mesh=rules.mesh)


def attention_decode(params: Params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor, *,
                     n_heads: int, n_kv: int, d_head: int, rope_theta: float,
                     use_rope: bool = True, window: Optional[int] = None,
                     update_cache: bool = True, kv_chunk: int = 2048,
                     rules: AxisRules = NO_RULES,
                     s_total: Optional[int] = None):
    """Single-token decode against a (B, S_cache, n_kv, d_head) cache.

    Never writes the cache: returns (out, k_new, v_new) with k_new/v_new
    (B, 1, n_kv, d_head); the caller stacks them across layers and writes
    them once (``update_cache_stack``).  The new token's term is folded
    into the online-softmax merge, so the sweep sees only the slots already
    written.  ``update_cache=False`` (a static memory) sweeps the slots
    <= pos inclusively and adds no new-token term.

    Flash-decoding: where ``s_total`` (the cache's global length) exceeds
    the cache given, the cache is this rank's block of the sequence over
    ``rules``' ``cache_seq`` axis, slots ``rank·S_loc..``; each rank
    sweeps its block and the partial (m, l, acc) merge by ``pmax``, a
    rescale and ``psum`` (the reference's shard_map branch).  The
    projections run on the ranks' columns, all-gathered, and ``wo``
    row-parallel."""
    rules = as_rules(rules)
    B = x.shape[0]
    S_loc = cache_k.shape[1]
    S = s_total or S_loc
    q = _linear_full(x, params["wq"], rules, n_heads * d_head) \
        .reshape(B, 1, n_heads, d_head)
    k_new = _linear_full(x, params["wk"], rules, n_kv * d_head) \
        .reshape(B, 1, n_kv, d_head)
    v_new = _linear_full(x, params["wv"], rules, n_kv * d_head) \
        .reshape(B, 1, n_kv, d_head)
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
    ax = rules.axis("cache_seq") if S != S_loc else None
    m, l, acc = _decode_sweep(qg, cache_k, cache_v, pos,
                              rules.index(ax) * S_loc, scale=scale,
                              rolling=rolling, s_total=S, kv_chunk=kv_chunk,
                              strict=update_cache)
    if ax is not None:
        m_g = mesh_utils.pmax(m, ax, mesh=rules.mesh)
        corr = torch.exp(m - m_g)
        m = m_g
        l = mesh_utils.psum(l * corr, ax, mesh=rules.mesh)
        acc = mesh_utils.psum(acc * corr, ax, mesh=rules.mesh)
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
    return (_linear_rows(o, params["wo"], rules, x.shape[-1]),
            k_new.to(cache_k.dtype), v_new.to(cache_v.dtype))


def update_cache_stack(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor,
                       window: Optional[int] = None,
                       s_total: Optional[int] = None,
                       rules: AxisRules = NO_RULES) -> torch.Tensor:
    """Write a stacked (L, B, 1, n_kv, d) slab of new K or V vectors into a
    (L, B, S, n_kv, d) stacked cache at slot ``pos`` — one write per decode
    step, outside the layer loop.  Unlike the reference, whose arrays are
    immutable, the write is in place: the cache passed in is returned,
    updated (a full copy of every layer's cache per token would double the
    decode state's memory).  A cache that is this rank's block of a
    sequence of ``s_total`` slots (``attention_decode``) is written by the
    rank whose block holds the slot."""
    rules = as_rules(rules)
    S_loc = cache.shape[2]
    S = s_total or S_loc
    slot = pos[:1] % window if (window is not None and S == window) \
        else pos[:1]
    if S != S_loc:
        slot = slot - rules.index(rules.axis("cache_seq")) * S_loc
        if not 0 <= int(slot[0]) < S_loc:
            return cache
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


def embed(params: Params, tokens: torch.Tensor,
          rules: AxisRules = NO_RULES,
          shape: Optional[tuple] = None) -> torch.Tensor:
    """Token embedding lookup.  Under ``rules`` (``shape``: the table's
    global (vocab, d_model)) the table's columns are held over
    ``embed_model``, so the lookup needs no collective; the rows looked
    up are then all-gathered into whole activations."""
    rules = as_rules(rules)
    tok = params["tok"]
    if not rules.enabled:
        return tok[tokens]
    tok = leaf(tok, rules, PARAM_AXES["embed/tok"], shape, ("embed_model",))
    return mesh_utils.all_gather(tok[tokens],
                                 dim_axis(rules, "embed_model", shape[1]),
                                 -1, mesh=rules.mesh)


def vocab_axis(rules: AxisRules, vocab_padded: int):
    """The mesh axis the logits' vocab dimension is split over under
    ``rules`` (``embed/out`` held in blocks over ``vocab``), or None."""
    return dim_axis(as_rules(rules), "vocab", vocab_padded)


def unembed(params: Params, x: torch.Tensor, rules: AxisRules = NO_RULES,
            vocab: Optional[int] = None, gather: bool = True
            ) -> torch.Tensor:
    """Logits x @ out.  Under ``rules`` (``vocab``: the padded vocab) with
    the vocab split (``vocab_axis``), the rank's vocab block, all-gathered
    into the whole vocab when ``gather`` (the loss takes the blocks)."""
    rules = as_rules(rules)
    if not rules.enabled:
        return x @ params["out"]
    logits = x @ leaf(params["out"], rules, PARAM_AXES["embed/out"],
                      (x.shape[-1], vocab), ("vocab",))
    if gather:
        logits = mesh_utils.all_gather(logits, vocab_axis(rules, vocab), -1,
                                       mesh=rules.mesh)
    return logits


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def sharded_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                         mesh=None, vocab_axis: Optional[str] = None,
                         batch_spec: Optional[P] = None) -> torch.Tensor:
    """Per-token cross-entropy (B, S) from logits (B, S, V) and labels
    (B, S), in fp32, the logsumexp over the whole (padded) vocab.

    With ``mesh`` and ``vocab_axis`` (the reference's shard_map'd loss)
    ``logits`` is this rank's vocab block (b, S, V/n) and ``labels`` its
    rows' global ids (its batch rows as ``batch_spec`` splits them, which
    the caller has already done): a logsumexp on each block, the max taken
    over the blocks without gradient, the label's logit gathered on the
    block that holds it, two ``psum``s — no one-hot and no logits gathered
    across blocks.  Returns this rank's rows' per-token loss, the same on
    every rank of the vocab axis."""
    lf = logits.float()
    if mesh is None or vocab_axis is None:
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        return lse - ll
    v_local = lf.shape[-1]
    shard = mesh_utils.axis_index(mesh, vocab_axis)
    # the stability max: its gradient contributions cancel exactly
    m = mesh_utils.pmax(lf.amax(dim=-1), vocab_axis, mesh=mesh)
    se = mesh_utils.psum(torch.exp(lf - m[..., None]).sum(dim=-1),
                         vocab_axis, mesh=mesh)
    lse = torch.log(se) + m
    local_idx = labels.long() - shard * v_local
    in_range = (local_idx >= 0) & (local_idx < v_local)
    safe = local_idx.clamp(0, v_local - 1)
    ll_local = torch.gather(lf, -1, safe[..., None])[..., 0]
    ll = mesh_utils.psum(torch.where(in_range, ll_local, 0.0), vocab_axis,
                         mesh=mesh)
    return lse - ll
