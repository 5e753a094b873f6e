"""CapsNet training step: autograd + clip + AdamW, over the Router API.

Port of the CapsNet half of the JAX package's ``repro/runtime/train_loop.py``
(``make_capsnet_train_step``).  The reference's step is a pure function of a
parameter tree; here the step takes a ``CapsNet`` and updates its
parameters in place (under ``torch.no_grad()``), keeping the optimizer
state beside it as plain tensors keyed by parameter name.  The LM step
(``make_train_step``) comes with LM training (slice 10).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import slices
from repro_torch.core import router as router_lib
from repro_torch.models import capsnet
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_update,
                               clip_by_global_norm, linear_warmup_cosine)


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


def make_train_step(*args, **kwargs):
    """The reference's LM train step (microbatch accumulation, gradient
    compression) — ported with LM training."""
    raise slices.not_ported("the LM train step (make_train_step)",
                            slices.LM_TRAINING)


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
                                a sharded plan on the torch backend raises
                                (sharded training is a later slice)
      prebuilt Router           used as-is (plan must be None); the caller
                                owns its differentiability

    opt_cfg: None -> a fresh ``AdamWConfig()`` per call (never a shared
    default instance).  ``device`` is where the router runs: the card by
    default (raises without one).  Returned signature:
        step(net, opt_state, images, labels) -> (net, opt_state, metrics)
    The step updates ``net``'s parameters in place and returns it.  The
    built step exposes ``step.router`` and ``step.opt_cfg``.
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
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr_scale = linear_warmup_cosine(opt_state.step + 1, warmup,
                                        total_steps)
        opt_state = apply_adamw_(params, grads, opt_state, opt_cfg, lr_scale)
        return net, opt_state, {
            "loss": loss.detach(), "grad_norm": gnorm, "lr_scale": lr_scale,
            **{k: v.detach() for k, v in metrics.items()}}

    train_step.router = router        # resolved execution is inspectable
    train_step.opt_cfg = opt_cfg      # (and testable: no shared default)
    return train_step
