"""Deterministic synthetic CapsNet data (no external data offline).

A copy of ``SyntheticCapsDataset`` from the JAX package's
``repro/data/synthetic.py`` (numpy only; the port imports nothing of
``repro``).  ``batch(i)`` is a pure function of (seed, i), so both packages
see the same images for the same index: class-conditional blob images, one
blob position and shape per class.  ``caps_batch_iterator`` is the
reference's step-indexed iterator.  The LM stream is ported with LM
training (slice 10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticCapsDataset:
    image_hw: int
    channels: int
    n_classes: int
    seed: int = 0

    def batch(self, index: int, batch_size: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index))
        labels = rng.integers(0, self.n_classes, size=batch_size)
        hw = self.image_hw
        yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
        # per-class blob center / radii / orientation (deterministic)
        crng = np.random.default_rng(self.seed + 1234)
        centers = 0.2 + 0.6 * crng.random((self.n_classes, 2))
        radii = 0.08 + 0.12 * crng.random((self.n_classes, 2))
        angles = np.pi * crng.random(self.n_classes)
        imgs = np.zeros((batch_size, hw, hw, self.channels), np.float32)
        for i, c in enumerate(labels):
            cy, cx = centers[c]
            ry, rx = radii[c]
            th = angles[c]
            dy, dx = yy - cy, xx - cx
            u = np.cos(th) * dy + np.sin(th) * dx
            v = -np.sin(th) * dy + np.cos(th) * dx
            blob = np.exp(-((u / ry) ** 2 + (v / rx) ** 2))
            jitter = 0.05 * rng.standard_normal((hw, hw))
            for ch in range(self.channels):
                imgs[i, :, :, ch] = np.clip(blob + jitter, 0, 1)
        return {"images": imgs, "labels": labels.astype(np.int32)}


def caps_batch_iterator(ds: SyntheticCapsDataset, batch_size: int,
                        start_step: int = 0
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of ``ds.batch(i, batch_size)`` from ``start_step``
    on, so a resumed run sees the batches it would have seen."""
    i = start_step
    while True:
        yield ds.batch(i, batch_size)
        i += 1
