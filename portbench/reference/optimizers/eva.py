"""Eva with its momentum inside the KL trust region (paper Eq. 13-16), as
one step of the fused update:

* ā, b̄ of each preconditioned weight: an EMA with weight ``kv_decay`` on
  the old value, divided by 1 − kv_decay^t (bias correction);
* each weight item (a layer, or an expert of a layer):
  P = (G − (āᵀGb̄) / (γ + ‖ā‖²‖b̄‖²) · āb̄ᵀ) / γ; every other leaf: P = G;
* u = μ·m + P; ν = min(1, √(κ / (α² Σ⟨u, G⟩))); m ← ν·u;
* w ← w − α·ν·u.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
CAPTURE = True


def init(params: dict, precon: list) -> dict:
    return {'t': 0, 'a': {p: None for p in precon},
            'b': {p: None for p in precon},
            'm': {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                  for k, v in params.items()}}


def _precondition(g, a, b, gamma):
    """Eq. 13 over the leading (item) dims, one leading row at a time."""
    if g.dim() > 3:
        return torch.stack([_precondition(g[i], a[i], b[i], gamma)
                            for i in range(g.shape[0])])
    dot = torch.einsum('...i,...io,...o->...', a, g, b)
    denom = gamma + (a * a).sum(-1) * (b * b).sum(-1)
    coeff = (dot / denom)[..., None, None]
    return (g - coeff * (a[..., :, None] * b[..., None, :])) / gamma


def step(state: dict, params: dict, grads: dict, a: dict, b: dict,
         opts: dict) -> None:
    """One update of the float32 ``params`` in place; the new momentum is
    left in ``state['m']``."""
    decay, gamma, mu = opts['kv_decay'], opts['gamma'], opts['momentum']
    lr, kappa = opts['lr'], opts['kl_kappa']
    if opts.get('weight_decay', 0.0):
        raise ValueError('the eva reference has no weight decay')
    state['t'] += 1
    corr = 1.0 - torch.tensor(decay, dtype=F32) ** state['t']
    used = {}
    for side, fresh in (('a', a), ('b', b)):
        for p, x in fresh.items():
            old = state[side][p]
            ema = (1.0 - decay) * x if old is None else \
                decay * old + (1.0 - decay) * x
            state[side][p] = ema
            used[(side, p)] = ema / corr.to(ema.device)
    kl = 0.0
    for p in sorted(grads):
        g, m = grads[p], state['m'][p]
        pre = _precondition(g, used[('a', p)], used[('b', p)], gamma) \
            if p in a else g
        m.mul_(mu).add_(pre)
        kl = kl + (m * g).sum()
        del pre
    ratio = kappa / max(lr * lr * max(float(kl), 0.0), 1e-20)
    nu = min(1.0, math.sqrt(ratio))
    for p, m in state['m'].items():
        m.mul_(nu)
        params[p].add_(m, alpha=-lr)
