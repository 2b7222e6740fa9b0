"""Memory-mapped token-file dataset — PyTorch port of
``repro/data/memmap_loader.py``.

Format: ``<path>.bin`` is a flat little-endian token array; ``<path>.json``
holds {"dtype": "uint16"|"int32", "n_tokens": N}.  ``write_tokens`` writes
both.  ``MemmapLM`` yields fixed-length (tokens, labels) windows:

  * deterministic: window index = f(epoch permutation(seed), step, rank),
    the permutation drawn from ``np.random.default_rng((seed, epoch))`` as
    in the reference, so the windows are the reference's;
  * disjoint across data-parallel ranks (rank r of W takes every W-th window
    of the epoch's permutation);
  * seekable: ``batch_at(step)``, so a resumed run sees the same batches.

Batches are int32 torch tensors on ``device`` (default ``'cuda'``).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


def write_tokens(path, tokens: np.ndarray) -> None:
    path = Path(path)
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f'tokens must be 1-D, got shape {tokens.shape}')
    dtype = 'uint16' if tokens.max() < 2 ** 16 else 'int32'
    tokens.astype(dtype).tofile(path.with_suffix('.bin'))
    path.with_suffix('.json').write_text(json.dumps(
        {'dtype': dtype, 'n_tokens': int(tokens.size)}))


@dataclasses.dataclass
class MemmapLM:
    path: str
    seq_len: int
    batch: int                      # per-rank batch
    rank: int = 0
    world: int = 1
    seed: int = 0
    device: str = 'cuda'

    def __post_init__(self):
        meta = json.loads(Path(self.path).with_suffix('.json').read_text())
        self._data = np.memmap(Path(self.path).with_suffix('.bin'),
                               dtype=meta['dtype'], mode='r')
        self.n_tokens = meta['n_tokens']
        self.n_windows = (self.n_tokens - 1) // self.seq_len
        if self.n_windows < self.batch * self.world:
            raise ValueError('corpus too small for batch × world')
        self._windows_per_epoch = self.n_windows - self.n_windows % (
            self.batch * self.world)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n_windows)[:self._windows_per_epoch]

    def windows_at(self, step: int) -> np.ndarray:
        """(batch, seq_len + 1) int32 windows of ``step`` on the host."""
        steps_per_epoch = self._windows_per_epoch // (self.batch * self.world)
        epoch, within = divmod(step, steps_per_epoch)
        perm = self._epoch_perm(epoch)
        base = within * self.batch * self.world + self.rank
        idx = perm[base: base + self.batch * self.world: self.world]
        return np.stack([
            self._data[i * self.seq_len: i * self.seq_len + self.seq_len + 1]
            for i in idx]).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        dev = resolve_device(self.device)
        toks = torch.from_numpy(self.windows_at(step))
        return {'tokens': toks[:, :-1].contiguous().to(dev),
                'labels': toks[:, 1:].contiguous().to(dev)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
