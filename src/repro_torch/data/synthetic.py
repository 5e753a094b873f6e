"""Deterministic synthetic datasets (no external data offline).

A copy of the JAX package's ``repro/data/synthetic.py`` (numpy only; the
port imports nothing of ``repro``).  ``batch(i)`` is a pure function of
(seed, i), so both packages see the same data for the same index and a
resumed run sees the batches it would have seen:

SyntheticLMDataset: a token stream with a planted bigram structure, so the
cross-entropy measurably falls during a run; ``modality_stubs`` adds the
VLM's image embeddings and the encoder-decoder's frames.
SyntheticCapsDataset: class-conditional blob images, one blob position and
shape per class.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    seed: int = 0

    def batch(self, index: int, batch_size: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, index))
        # planted structure: token t+1 = (a*t + noise) % vocab for learnable
        # bigram stats; mixture with uniform noise.
        a = 31
        first = rng.integers(0, self.vocab, size=(batch_size, 1))
        toks = [first]
        for _ in range(self.seq_len):
            nxt = (a * toks[-1] + 7) % self.vocab
            noise = rng.integers(0, self.vocab, size=nxt.shape)
            use_noise = rng.random(nxt.shape) < 0.2
            toks.append(np.where(use_noise, noise, nxt))
        seq = np.concatenate(toks, axis=1)                     # (B, S+1)
        return {"tokens": seq[:, :-1].astype(np.int32),
                "labels": seq[:, 1:].astype(np.int32)}


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


def modality_stubs(cfg, batch_size: int, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """The stub frontends' inputs a batch of ``batch_size`` requests of the
    LM config ``cfg`` takes beside its tokens, as the reference's serve CLI
    builds them: a VLM's ``image_embeds`` (zeros, (B, n_img_tokens,
    d_model)) and an enc-dec's ``frames`` (standard normal from ``seed``,
    (B, source_len, d_model)), float32; nothing for the other families."""
    out = {}
    if cfg.family == "vlm":
        out["image_embeds"] = np.zeros(
            (batch_size, cfg.n_img_tokens, cfg.d_model), np.float32)
    if cfg.enc_dec:
        out["frames"] = np.random.default_rng(seed).standard_normal(
            (batch_size, cfg.source_len, cfg.d_model), dtype=np.float32)
    return out


def lm_batch_iterator(ds: SyntheticLMDataset, batch_size: int,
                      start_step: int = 0,
                      shard: Tuple[int, int] = (0, 1)
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator; ``shard=(k, n)`` yields the k-th of n host
    slices."""
    k, n = shard
    per = batch_size // n
    i = start_step
    while True:
        b = ds.batch(i, batch_size)
        yield {key: v[k * per:(k + 1) * per] for key, v in b.items()}
        i += 1


def caps_batch_iterator(ds: SyntheticCapsDataset, batch_size: int,
                        start_step: int = 0
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of ``ds.batch(i, batch_size)`` from ``start_step``
    on, so a resumed run sees the batches it would have seen."""
    i = start_step
    while True:
        yield ds.batch(i, batch_size)
        i += 1
