"""SGD with the bias-corrected EMA momentum of the second-order chains:
m ← μ·m + (1−μ)·G;  w ← w − α · m / (1 − μ^t)."""
from __future__ import annotations

import torch

F32 = torch.float32
CAPTURE = False


def init(params: dict, precon: list) -> dict:
    return {'t': 0, 'm': {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                          for k, v in params.items()}}


def step(state: dict, params: dict, grads: dict, a, b, opts: dict) -> None:
    """One update of the float32 ``params`` in place."""
    mu, lr = opts['momentum'], opts['lr']
    if opts.get('weight_decay', 0.0) or opts.get('nesterov'):
        raise ValueError('the sgd reference has plain momentum only')
    state['t'] += 1
    corr = 1.0 - mu ** state['t']
    for p, g in grads.items():
        m = state['m'][p]
        m.mul_(mu).add_(g, alpha=1.0 - mu)
        params[p].add_(m, alpha=-lr / corr)
