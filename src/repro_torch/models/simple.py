"""The paper's 8-layer autoencoder (§5.1, Fig. 4) and an MLP classifier —
PyTorch port of ``repro/models/simple.py``.  These are the models with full
taps (K-FAC's ``b='outer'`` capture), through ``MLP.make_taps``."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import kv as kvlib
from repro_torch.device import resolve_device
from repro_torch.models.layers import linear, linear_spec


class MLP:
    """dims = [in, h1, ..., out]; relu hidden activations."""

    def __init__(self, dims: Sequence[int],
                 final_activation: Optional[str] = None):
        self.dims = tuple(dims)
        self.final_activation = final_activation

    def param_specs(self) -> dict:
        return {f'fc{i}': linear_spec(self.dims[i], self.dims[i + 1],
                                      bias=True)
                for i in range(len(self.dims) - 1)}

    def precon_paths(self) -> set[str]:
        return {f'fc{i}/w' for i in range(len(self.dims) - 1)}

    def make_taps(self, batch_size: int, capture: kvlib.CaptureConfig,
                  device='cuda') -> Optional[dict]:
        """Zero vector taps (d_out,) or full taps (batch, d_out) per layer,
        on ``device``."""
        if not capture.needs_taps:
            return None
        device = resolve_device(device)
        taps = {}
        for i in range(len(self.dims) - 1):
            d_out = self.dims[i + 1]
            shape = (d_out,) if capture.b == 'mean' else (batch_size, d_out)
            taps[f'fc{i}/w'] = torch.zeros(shape, dtype=torch.float32,
                                           device=device)
        return taps

    def apply(self, params, x, taps=None, capture=None):
        col: dict = {}
        n = len(self.dims) - 1
        for i in range(n):
            x = linear(params, x, path=f'fc{i}', col=col, taps=taps,
                       capture=capture)
            if i < n - 1:
                x = torch.relu(x)
        if self.final_activation == 'sigmoid':
            x = torch.sigmoid(x)
        return x, col


def autoencoder(hidden: Sequence[int] = (1000, 500, 250, 30, 250, 500, 1000),
                d_in: int = 784) -> MLP:
    """The paper's 8-layer autoencoder (§5.1)."""
    return MLP([d_in, *hidden, d_in], final_activation='sigmoid')


def ae_loss_fn(model: MLP):
    def loss_fn(params, taps, batch, capture):
        recon, col = model.apply(params, batch['x'], taps=taps,
                                 capture=capture)
        x = batch['x']
        # binary cross-entropy (x in [0,1]) as in deep-AE benchmarks
        eps = 1e-6
        r = torch.clamp(recon.to(torch.float32), eps, 1 - eps)
        loss = -torch.mean(x * torch.log(r) + (1 - x) * torch.log(1 - r))
        return loss, {'stats': col, 'n_tokens': x.shape[0]}
    return loss_fn


def classifier_loss_fn(model: MLP):
    def loss_fn(params, taps, batch, capture):
        logits, col = model.apply(params, batch['x'], taps=taps,
                                  capture=capture)
        logits = logits.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, batch['y'].long()[:, None])[:, 0]
        return torch.mean(lse - gold), {'stats': col,
                                        'n_tokens': logits.shape[0]}
    return loss_fn
