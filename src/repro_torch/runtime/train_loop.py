"""Training steps: autograd + clip + AdamW, for the LMs and, over the
Router API, for CapsNet.

Port of the JAX package's ``repro/runtime/train_loop.py``.  The reference's
steps are pure functions of a parameter tree; here they update the
parameters and the optimizer state in place (under ``torch.no_grad()``) and
return them, which keeps one copy of each on the card:

* ``make_train_step`` (the LM step) takes the nested parameter dict of
  ``models.lm`` and an ``AdamWState`` whose moments are keyed by the
  parameters' "/"-joined paths (``init_train_state``).  Gradient
  accumulation over microbatches, clipping, the 1-based schedule step and
  the optional int8 compression with error feedback are the reference's;
  clipping and AdamW run over slices of at most ``UPDATE_ELEMENTS``
  elements of each leaf (element-wise, so the result is the whole leaf's),
  which bounds their fp32 temporaries.
* ``make_capsnet_train_step`` takes a ``CapsNet`` and its named
  parameters.

Under sharding ``rules`` (``runtime.sharding.make_rules``) the LM step is
one rank's part of an SPMD step: ``params`` and the moments are its
blocks (``lm.shard_params``), the batch its rows of the global batch, the
gradients are finished by ``sharding.sync_grads``, the clipping norm sums
every block once (``sharding.global_norm``), compression takes each
leaf's scale over its whole leaf, and AdamW updates the blocks in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten_like
from repro_torch.core import router as router_lib
from repro_torch.models import capsnet, lm
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update, clip_by_global_norm,
                               global_norm, linear_warmup_cosine)
from repro_torch.models.layers import NO_RULES, AxisRules, as_rules
from repro_torch.runtime import compression, sharding, spans

# the largest slice of a leaf that clipping and AdamW update at once: four
# fp32 temporaries of 256 MB, where a whole stacked leaf (falcon-mamba's
# in_proj, 32 × 4096 × 16384) would make 8.6 GB ones
UPDATE_ELEMENTS = 2 ** 26


def apply_adamw_(params: dict, grads: dict, opt_state: AdamWState,
                 opt_cfg: AdamWConfig, lr_scale) -> AdamWState:
    """One AdamW step on named parameters (``dict(net.named_parameters())``),
    written into them in place.  Returns the new optimizer state."""
    with torch.no_grad():
        new, opt_state = adamw_update(
            grads, opt_state, {k: p.detach() for k, p in params.items()},
            opt_cfg, lr_scale)
        for k, p in params.items():
            p.copy_(new[k])
    return opt_state


def _update_slices(t: torch.Tensor) -> tuple:
    """``t`` split along its first axis into views of at most
    ``UPDATE_ELEMENTS`` elements (or fewer rows); each keeps ``t``'s number
    of dimensions, so AdamW's matrices-only weight decay sees the leaf's."""
    if t.dim() == 0:
        return (t,)
    row = max(1, t[0].numel())
    return t.split(max(1, UPDATE_ELEMENTS // row), dim=0)


def clip_and_adamw_(params: Dict[str, torch.Tensor],
                    grads: Dict[str, torch.Tensor], opt_state: AdamWState,
                    opt_cfg: AdamWConfig, max_grad_norm: float,
                    lr_scale, norm: Optional[torch.Tensor] = None) -> tuple:
    """``clip_by_global_norm`` then ``adamw_update`` over flat parameters,
    slice by slice, written into ``params`` and ``opt_state``'s moments in
    place.  Returns (the new state, the norm before clipping); ``norm``:
    the global norm when the caller computed it (a sharded tree's)."""
    pieces = [(p, g, m, v)
              for k in params
              for p, g, m, v in zip(*map(_update_slices, (
                  params[k], grads[k], opt_state.mu[k], opt_state.nu[k])))]
    with torch.no_grad():
        if norm is None:
            norm = global_norm({i: g for i, (_, g, _, _)
                                in enumerate(pieces)})
        scale = torch.clamp(max_grad_norm / torch.clamp(norm, min=1e-9),
                            max=1.0)
        for p, g, m, v in pieces:
            g = (g.float() * scale).to(g.dtype)
            new_p, st = adamw_update({0: g}, AdamWState(
                step=opt_state.step, mu={0: m}, nu={0: v}), {0: p}, opt_cfg,
                lr_scale)
            p.copy_(new_p[0])
            m.copy_(st.mu[0])
            v.copy_(st.nu[0])
    return opt_state._replace(step=opt_state.step + 1), norm


def make_train_step(cfg: lm.ArchConfig, rules: AxisRules = NO_RULES,
                    opt_cfg: Optional[AdamWConfig] = None,
                    num_microbatches: int = 1, max_grad_norm: float = 1.0,
                    total_steps: int = 10_000, warmup: int = 100,
                    compress_grads: bool = False) -> Callable:
    """Build the LM train step.  Batch layout:
       num_microbatches == 1: {tokens (B,S), labels (B,S)};
       num_microbatches  > 1: {tokens (n,mb,S), labels (n,mb,S)}, the
       microbatches run in order and their gradients accumulate in fp32,
       divided by n.

    step(params, opt_state, batch, error_fb=None) -> (params, opt_state,
    metrics), and with ``compress_grads`` (params, opt_state, metrics,
    error_fb): the gradients are int8-compressed with error feedback when
    an ``error_fb`` (``compression.init_error_feedback``) is passed, as in
    the reference.  ``params`` and ``opt_state`` are updated in place and
    returned.  opt_cfg: None -> a fresh ``AdamWConfig()`` per call (never a
    shared default instance); the built step exposes ``step.opt_cfg``.
    Under ``rules`` each rank passes its blocks and its batch rows (module
    docstring); ``step.held`` maps each leaf to the mesh axes it is held
    in blocks over."""
    rules = as_rules(rules)
    if opt_cfg is None:
        opt_cfg = AdamWConfig()
    sharded = rules.enabled and rules.mesh is not None
    held = sharding.param_held(cfg, rules) if sharded else None

    def grads_for(params, microbatch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in flatten(params).items()}
        loss, metrics = lm.loss_fn(unflatten_like(params, leaves), cfg,
                                   microbatch, rules)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(leaves, grads)))

    def train_step(params, opt_state, batch, error_fb=None):
        if num_microbatches == 1:
            loss, metrics, grads = grads_for(params, batch)
        else:
            grads, losses, mets = None, [], []
            for i in range(num_microbatches):
                l, m, g = grads_for(params, {k: v[i]
                                             for k, v in batch.items()})
                if grads is None:       # 0 + g: the reference's first add
                    grads = {k: gi.float() for k, gi in g.items()}
                else:
                    for k, gi in g.items():
                        grads[k].add_(gi.float())
                del g
                losses.append(l)
                mets.append(m)
            for acc in grads.values():
                acc.div_(num_microbatches)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        norm = None
        if sharded:
            grads = sharding.sync_grads(grads, held, rules)
        if compress_grads and error_fb is not None:
            grads, error_fb = compression.compress_grads_with_feedback(
                grads, error_fb, held, rules.mesh)
        if sharded:
            norm = sharding.global_norm(grads, held, rules)
        # schedule indexed by the step being taken (1-based)
        lr_scale = linear_warmup_cosine(opt_state.step + 1, warmup,
                                        total_steps)
        opt_state, gnorm = clip_and_adamw_(flatten(params), grads, opt_state,
                                           opt_cfg, max_grad_norm, lr_scale,
                                           norm)
        out = {"loss": loss, "grad_norm": gnorm, "lr_scale": lr_scale,
               **metrics}
        if compress_grads:
            return params, opt_state, out, error_fb
        return params, opt_state, out

    train_step.opt_cfg = opt_cfg     # which config this step was built with
    train_step.held = held
    return train_step


def init_train_state(cfg: lm.ArchConfig, seed: int = 0, device="cuda"):
    """(params, opt_state): random weights from ``seed`` on ``device`` and
    zero fp32 moments keyed by the parameters' "/"-joined paths."""
    params = lm.init_params(cfg, seed=seed, device=device)
    return params, adamw_init(flatten(params))


def make_capsnet_train_step(caps_cfg, spec=None, plan=None,
                            opt_cfg: Optional[AdamWConfig] = None,
                            max_grad_norm: float = 1.0,
                            total_steps: int = 10_000, warmup: int = 100, *,
                            device="cuda") -> Callable:
    """Build a CapsNet train step over the unified Router API.

    spec/plan go to ``core.router.build_router`` with ``differentiable=True``
    stamped on the spec — gradients are about to flow through the router,
    so the cuda backend must resolve to the form that HAS a backward (the
    procedure kernel's recompute-b autograd Function), never to a
    forward-only kernel:

      spec=None, plan=None      exact torch routing (the autograd reference)
      spec=None, plan="auto"    cuda procedure kernel + backward kernel
                                (auto resolves shard-local when
                                differentiable)
      RouterSpec(...)           as given, ``_replace(differentiable=True)``;
                                a sharded plan on the torch backend trains
                                by autograd through the collectives
      prebuilt Router           used as-is (plan must be None); the caller
                                owns its differentiability

    opt_cfg: None -> a fresh ``AdamWConfig()`` per call (never a shared
    default instance).  ``device`` is where the router runs: the card by
    default (raises without one).  Returned signature:
        step(net, opt_state, images, labels) -> (net, opt_state, metrics)
    The step updates ``net``'s parameters in place and returns it.  The
    built step exposes ``step.router`` and ``step.opt_cfg``.  Its gradient
    runs in the ``train.backward`` span and its clipping, schedule and
    AdamW in ``train.optimizer`` (``runtime.spans``).
    """
    if opt_cfg is None:
        opt_cfg = AdamWConfig()
    if spec is None:
        # plan=None keeps the torch default; any plan asks for the cuda
        # backend and therefore the differentiable kernel resolution
        spec = router_lib.RouterSpec(
            backend="torch" if plan is None else "cuda",
            iterations=caps_cfg.routing_iters, differentiable=True)
    elif isinstance(spec, router_lib.RouterSpec):
        spec = spec._replace(differentiable=True)
    router = router_lib.as_router(spec, plan, device=device,
                                  default_iterations=caps_cfg.routing_iters)

    def train_step(net, opt_state, images, labels):
        params = dict(net.named_parameters())
        loss, metrics = capsnet.loss_fn(net, images, labels, router=router)
        with spans.span("train.backward"):
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
        with spans.span("train.optimizer"):
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            lr_scale = linear_warmup_cosine(opt_state.step + 1, warmup,
                                            total_steps)
            opt_state = apply_adamw_(params, grads, opt_state, opt_cfg,
                                     lr_scale)
        return net, opt_state, {
            "loss": loss.detach(), "grad_norm": gnorm, "lr_scale": lr_scale,
            **{k: v.detach() for k, v in metrics.items()}}

    train_step.router = router        # resolved execution is inspectable
    train_step.opt_cfg = opt_cfg      # (and testable: no shared default)
    return train_step
