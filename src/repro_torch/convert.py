"""Weights carried across from the JAX package.

``capsnet_from_jax`` takes the reference's CapsNet parameter tree as numpy
arrays (nested dicts, or a flat dict keyed by "/"-joined tree paths such as
``primary/conv1/w``) and copies it leaf by leaf by name into a ``CapsNet``.
Conv weights go from the reference's HWIO to PyTorch's OIHW; nothing else
changes.  ``load_jax_checkpoint`` reads a step directory written by the
reference's ``save_checkpoint`` (``manifest.json`` plus one ``.npy`` per
leaf) with numpy and json only.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.caps_benchmarks import CapsConfig
from repro_torch.core.capsule_layers import Conv2d
from repro_torch.models.capsnet import CapsNet


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def capsnet_from_jax(params_np, cfg: CapsConfig,
                     device="cuda") -> CapsNet:
    """A ``CapsNet`` holding the reference's weights ``params_np``.

    Every parameter of the port must find its leaf, with the shape the
    layout change gives it, and every leaf must be used; anything else
    raises ``KeyError``/``ValueError``."""
    flat = _flatten(params_np)
    net = CapsNet(cfg, device=device)
    conv_params = {f"{name}.w" for name, m in net.named_modules()
                   if isinstance(m, Conv2d)}
    used = set()
    with torch.no_grad():
        for name, p in net.named_parameters():
            key = name.replace(".", "/")
            if key not in flat:
                raise KeyError(f"JAX parameters have no leaf {key!r}")
            arr = flat[key]
            if name in conv_params:
                arr = arr.transpose(3, 2, 0, 1)             # HWIO -> OIHW
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{key}: JAX leaf gives {arr.shape}, the "
                                 f"port expects {tuple(p.shape)}")
            p.copy_(torch.tensor(arr, dtype=torch.float32))
            used.add(key)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"JAX leaves with no counterpart in the port: {extra}")
    return net


def load_jax_checkpoint(path: str, cfg: CapsConfig,
                        device="cuda") -> CapsNet:
    """Load a checkpoint step directory written by the reference's
    ``repro.checkpoint.save_checkpoint`` (the path it returns)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    flat = {key: np.load(os.path.join(path, entry["file"]))
            for key, entry in manifest.items()}
    return capsnet_from_jax(flat, cfg, device=device)
