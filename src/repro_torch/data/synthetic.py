"""Deterministic synthetic datasets — PyTorch port of
``repro/data/synthetic.py``.

The generators are numpy inside, the same code as the reference, so
``batch_at(step)`` gives byte-identical batches; they come back as torch
tensors on the stream's ``device`` (default ``'cuda'``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


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
