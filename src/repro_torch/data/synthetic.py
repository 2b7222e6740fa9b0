"""Deterministic synthetic datasets — PyTorch port of
``repro/data/synthetic.py``.

The generators are numpy inside, the same code as the reference, so
``batch_at(step)`` gives byte-identical batches; they come back as torch
tensors on the stream's ``device`` (default ``'cuda'``).

* ``LMStream``   — token sequences from a fixed random bigram chain.
* ``AEStream``   — MNIST-like [0,1] images: smooth random low-rank blobs.
* ``ClassStream``— gaussian-blob classification.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

# LMStream builds its vocab x vocab chain this many table entries at a time
_BLOCK_ENTRIES = 1 << 22


@dataclasses.dataclass
class LMStream:
    """Token sequences from a fixed random bigram chain: int32 ``tokens``
    and next-token ``labels``, (batch, seq_len) each.

    The chain is the reference's, built in blocks of rows: the same Gumbel
    draws in the same order, and each row normalized and summed as the
    reference does, so the CDF table ``_cum`` holds the reference's bytes.
    Only ``_cum`` stays (vocab² float64: 8.6 GB at vocab 32768, where the
    reference holds a second table of the same size); the chain's entropy
    is taken block by block as it is built."""
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    concentration: float = 0.3   # lower = peakier bigrams = more learnable
    device: str = 'cuda'

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab
        self._cum = np.empty((v, v), np.float64)
        entropy = np.empty(v, np.float64)
        rows = max(1, _BLOCK_ENTRIES // v)
        for r0 in range(0, v, rows):
            r1 = min(r0 + rows, v)
            # the reference's expressions, each elementwise step in place
            probs = rng.gumbel(size=(r1 - r0, v))
            probs /= self.concentration
            probs -= probs.max(-1, keepdims=True)
            np.exp(probs, out=probs)
            probs /= probs.sum(-1, keepdims=True)
            np.cumsum(probs, axis=-1, out=self._cum[r0:r1])
            logp = np.maximum(probs, 1e-12)
            np.log(logp, out=logp)
            logp *= probs
            entropy[r0:r1] = -logp.sum(-1)
        self._bigram_ce = float(entropy.mean())

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        u = rng.random((self.batch, self.seq_len))
        # bigram sampling: invert the per-row CDF.  A row is a cumsum of
        # non-negative terms, so it never decreases, and the reference's
        # count of its entries below the draw is a binary search
        cum = self._cum
        for t in range(self.seq_len):
            for i in range(self.batch):
                toks[i, t + 1] = np.searchsorted(cum[toks[i, t]], u[i, t])
        dev = resolve_device(self.device)
        return {'tokens': torch.from_numpy(
                    np.ascontiguousarray(toks[:, :-1])).to(dev),
                'labels': torch.from_numpy(
                    np.ascontiguousarray(toks[:, 1:])).to(dev)}

    @property
    def uniform_ce(self) -> float:
        return float(np.log(self.vocab))

    @property
    def bigram_ce(self) -> float:
        """Entropy of the generating chain — the achievable CE floor."""
        return self._bigram_ce


@dataclasses.dataclass
class AEStream:
    """Smooth blob images in [0,1], shape (batch, d) with d = side*side."""
    batch: int
    side: int = 28
    rank: int = 6
    seed: int = 0
    device: str = 'cuda'

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        g = np.linspace(-1, 1, self.side)
        basis = np.stack([np.exp(-((g[:, None] - rng.uniform(-1, 1)) ** 2 +
                                   (g[None, :] - rng.uniform(-1, 1)) ** 2)
                                 / rng.uniform(0.05, 0.4))
                          for _ in range(self.rank)])
        w = rng.random((self.batch, self.rank)).astype(np.float32)
        img = np.einsum('br,rhw->bhw', w, basis)
        img = img / np.maximum(img.max(axis=(1, 2), keepdims=True), 1e-6)
        x = img.reshape(self.batch, -1).astype(np.float32)
        return {'x': torch.from_numpy(x).to(resolve_device(self.device))}


@dataclasses.dataclass
class ClassStream:
    """Gaussian blobs: (batch, dim) f32 -> int32 labels in [0, classes)."""
    batch: int
    dim: int = 64
    classes: int = 10
    seed: int = 0
    spread: float = 3.0
    device: str = 'cuda'

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._centers = rng.normal(size=(self.classes, self.dim)) * self.spread

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        y = rng.integers(0, self.classes, self.batch)
        x = self._centers[y] + rng.normal(size=(self.batch, self.dim))
        dev = resolve_device(self.device)
        return {'x': torch.from_numpy(x.astype(np.float32)).to(dev),
                'y': torch.from_numpy(y.astype(np.int32)).to(dev)}
