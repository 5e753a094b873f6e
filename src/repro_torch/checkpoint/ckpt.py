"""Checkpoints in the JAX package's format, with numpy and json only.

Port of ``repro/checkpoint/ckpt.py``.  One directory per step:

    step_<8 digits>/manifest.json   {"step": ..., "leaves": {key: {file,
                                     shape, dtype}}}
    step_<8 digits>/leaf_<i>.npy    one file per leaf, in sorted key order

Keys are the "/"-joined paths of a nested dict (a JAX parameter tree's
paths, e.g. ``primary/conv1/w``), so a checkpoint written here loads in
``repro.checkpoint.load_checkpoint`` and the other way round.  For a
``CapsNet``, save ``convert.capsnet_to_jax(net)`` (conv weights HWIO, as
the reference stores them) and read it back with
``convert.load_jax_checkpoint``.  Writes go to ``<dir>.tmp`` and are
renamed into place, so a crash mid-write never corrupts the latest
complete checkpoint; ``AsyncCheckpointer`` copies to host memory at once
and writes on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array; bf16, which numpy lacks, is written as its
    exact fp32 value (a load casts it back to the target's dtype)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested dict as a flat dict keyed by "/"-joined paths (the
    reference's tree keys, e.g. ``primary/conv1/w``)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


def unflatten_like(tree, flat: Mapping[str, Any], prefix: str = ""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out[k] = (unflatten_like(v, flat, key) if isinstance(v, Mapping)
                  else flat[key])
    return out


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Synchronous save of a nested dict of tensors or arrays.  Returns the
    checkpoint path."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in flatten(tree).items()}
    manifest = {}
    for i, (key, arr) in enumerate(sorted(flat.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, target_tree):
    """Restore into the structure of ``target_tree`` (a nested dict).  Each
    leaf comes back as a numpy array of the target leaf's dtype, or as a
    tensor of the target's dtype on its device where the target leaf is a
    tensor."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    out = {}
    for key, tgt in flatten(target_tree).items():
        if key not in manifest:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(path, manifest[key]["file"]))
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs target {tuple(tgt.shape)}")
        if isinstance(tgt, torch.Tensor):
            out[key] = torch.from_numpy(arr).to(device=tgt.device,
                                                dtype=tgt.dtype)
        else:
            out[key] = arr.astype(tgt.dtype)
    return unflatten_like(target_tree, out)


class AsyncCheckpointer:
    """Snapshot-now, write-later checkpointing (one write in flight)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    def save(self, step: int, tree) -> None:
        self.wait()  # one in flight at a time
        snapshot = {k: _to_numpy(v) for k, v in flatten(tree).items()}

        def _write():
            save_checkpoint(self.directory, step, snapshot)
            self._gc()

        self._pending = self._pool.submit(_write)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self) -> None:
        with self._lock:
            if not os.path.isdir(self.directory):
                return
            steps = sorted(int(d.split("_")[1])
                           for d in os.listdir(self.directory)
                           if d.startswith("step_")
                           and not d.endswith(".tmp"))
            for s in steps[:-self.keep]:
                shutil.rmtree(os.path.join(
                    self.directory, f"step_{s:08d}"), ignore_errors=True)
