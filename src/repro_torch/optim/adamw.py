"""AdamW on tensors keyed by parameter name, fp32 moments, decoupled weight
decay.

Port of the JAX package's ``repro/optim/adamw.py``.  The reference works on
pytrees; here a "tree" is a mapping from parameter name (``net.named_
parameters()``) to tensor, so every function can be held element by element
against the reference on the same numbers.  The functions are pure: they
return new tensors and leave their arguments alone (the train step copies
the result into the module's parameters).  This is not ``torch.optim``.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch

Tree = Mapping[str, torch.Tensor]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: steps taken
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adamw_init(params: Tree) -> AdamWState:
    """Zero fp32 moments beside each parameter, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(iter(params.values())).device if params else "cpu"
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu={k: zeros(p) for k, p in params.items()},
                      nu={k: zeros(p) for k, p in params.items()})


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / global norm).  Returns
    (clipped gradients, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def adamw_update(grads: Tree, state: AdamWState, params: Tree,
                 cfg: AdamWConfig,
                 lr_scale: Union[torch.Tensor, float] = 1.0):
    """One AdamW step.  Returns (new_params, new_state); weight decay acts
    on matrices only (``ndim >= 2``), as in the reference."""
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    lr = cfg.lr * lr_scale
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float()
        m = b1 * state.mu[k] + (1 - b1) * g
        v = b2 * state.nu[k] + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:  # decay matrices only (standard practice)
            delta = delta + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v)
