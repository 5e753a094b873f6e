"""Weights carried across from the JAX package.

``capsnet_from_jax`` takes the reference's CapsNet parameter tree as numpy
arrays (nested dicts, or a flat dict keyed by "/"-joined tree paths such as
``primary/conv1/w``) and copies it leaf by leaf by name into a ``CapsNet``.
Conv weights go from the reference's HWIO to PyTorch's OIHW; nothing else
changes.  ``load_jax_checkpoint`` reads a step directory written by the
reference's ``save_checkpoint`` (``manifest.json`` plus one ``.npy`` per
leaf) with numpy and json only.  ``capsnet_to_jax`` is the inverse of
``capsnet_from_jax``: the reference's nested parameter tree as numpy arrays,
conv weights back in HWIO — what the port's checkpoints store.

``lm_params_from_jax`` does the same for the LM parameter tree
(``repro.models.lm.init_params``): the port keeps the reference's key paths,
stacked layer axes (a hybrid's ``blocks`` stacked twice, (n_super,
attn_every, ...), beside ``shared_attn`` and ``tail``) and layouts, so
every leaf carries across unchanged, in
the port's dtype for it (bf16 leaves arrive as ``ml_dtypes`` arrays and
pass through fp32 exactly).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten_like
from repro_torch.configs.caps_benchmarks import CapsConfig
from repro_torch.core.capsule_layers import Conv2d
from repro_torch.kernels import resolve_device
from repro_torch.models import lm
from repro_torch.models.capsnet import CapsNet


def capsnet_from_jax(params_np, cfg: CapsConfig,
                     device="cuda") -> CapsNet:
    """A ``CapsNet`` holding the reference's weights ``params_np``.

    Every parameter of the port must find its leaf, with the shape the
    layout change gives it, and every leaf must be used; anything else
    raises ``KeyError``/``ValueError``."""
    flat = {k: np.asarray(v) for k, v in flatten(params_np).items()}
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


def capsnet_to_jax(net: CapsNet) -> dict:
    """The reference's CapsNet parameter tree (nested dicts of numpy fp32
    arrays, keyed like ``init_capsnet``'s) holding ``net``'s weights."""
    conv_params = {f"{name}.w" for name, m in net.named_modules()
                   if isinstance(m, Conv2d)}
    tree: dict = {}
    for name, p in net.named_parameters():
        arr = p.detach().cpu().numpy().copy()
        if name in conv_params:
            arr = arr.transpose(2, 3, 1, 0)                 # OIHW -> HWIO
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def load_jax_checkpoint(path: str, cfg: CapsConfig,
                        device="cuda") -> CapsNet:
    """Load a checkpoint step directory written by the reference's
    ``repro.checkpoint.save_checkpoint`` (the path it returns)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    flat = {key: np.load(os.path.join(path, entry["file"]))
            for key, entry in manifest.items()}
    return capsnet_from_jax(flat, cfg, device=device)


def lm_params_from_jax(params_np, cfg: lm.ArchConfig, device="cuda") -> dict:
    """The port's LM parameter tree holding the reference's weights
    ``params_np`` (numpy arrays, nested or "/"-joined).

    Every leaf of ``lm.init_params(cfg)`` must find its leaf with the same
    shape, and every leaf must be used; anything else raises
    ``KeyError``/``ValueError``."""
    flat = {k: np.asarray(v) for k, v in flatten(params_np).items()}
    shapes = lm.init_params(cfg, device="meta")
    want = flatten(shapes)
    dev = resolve_device(device)
    out = {}
    for key, meta in want.items():
        if key not in flat:
            raise KeyError(f"JAX parameters have no leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(meta.shape):
            raise ValueError(f"{key}: JAX leaf gives {arr.shape}, the port "
                             f"expects {tuple(meta.shape)}")
        if arr.dtype.kind != "f" or arr.dtype.itemsize != 4:
            arr = arr.astype(np.float32)      # bf16 (ml_dtypes) -> exact
        out[key] = torch.tensor(arr).to(device=dev, dtype=meta.dtype)
    extra = sorted(set(flat) - set(want))
    if extra:
        raise KeyError(f"JAX leaves with no counterpart in the port: {extra}")
    return unflatten_like(shapes, out)
