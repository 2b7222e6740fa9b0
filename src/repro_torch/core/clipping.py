"""KL trust region (Eq. 16) with momentum inside it — PyTorch port.

Counterpart of ``kl_clip_trace``, ``finish_kl_clip`` and ``_lr_at`` in
``repro/core/clipping.py``: accumulate m ← μ·m + p, clip the
momentum-included update by ν = min(1, √(κ / (α² uᵀg))), store the clipped
buffer.  All scalars stay 0-d device tensors.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.core.transform import (Extras, GradientTransformation,
                                        TraceState, scalar, tree_map,
                                        tree_vdot)

Schedule = Union[float, Callable]
F32 = torch.float32


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` as a 0-d f32 tensor on step's device."""
    if callable(lr):
        return torch.as_tensor(lr(step), dtype=F32, device=step.device)
    return scalar(lr, step.device)


def _nu(kl: torch.Tensor, step, kappa: float, lr: Schedule) -> torch.Tensor:
    alpha = _lr_at(lr, step)
    kl = torch.clamp(kl, min=0.0)
    # a true division: ``float / tensor`` would multiply by a reciprocal
    ratio = torch.full_like(kl, kappa) / torch.clamp(alpha * alpha * kl,
                                                     min=1e-20)
    return torch.clamp(torch.sqrt(ratio), max=1.0)


def kl_clip_trace(kappa: float = 1e-3, lr: Schedule = 0.1,
                  momentum: float = 0.9,
                  nesterov: bool = False) -> GradientTransformation:
    """m ← μ·m + p;  u = p + μ·m if nesterov else m;
    ν = min(1, √(κ / (α² uᵀg)));  output = ν·u;  store = ν·m."""

    def init(params, extras=None):
        return TraceState(trace=tree_map(
            lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
            params))

    def update(updates, state, params=None, extras: Optional[Extras] = None):
        del params
        m = tree_map(lambda mm, g: momentum * mm + g.to(F32), state.trace,
                     updates)
        u = tree_map(lambda g, mm: g.to(F32) + momentum * mm, updates, m) \
            if nesterov else m
        nu = _nu(tree_vdot(u, extras.raw_grads), extras.step, kappa, lr)
        out = tree_map(lambda x: x * nu, u)
        stored = tree_map(lambda x: x * nu, m) if nesterov else out
        return out, TraceState(trace=stored)

    return GradientTransformation(init, update)


def finish_kl_clip(u, kl, step, kappa: float, lr: Schedule, m=None):
    """The Eq. 16 scale given a precomputed uᵀg: ``(ν·u, ν·(m or u))``."""
    nu = _nu(kl, step, kappa, lr)
    out = tree_map(lambda x: x * nu, u)
    stored = out if m is None else tree_map(lambda x: x * nu, m)
    return out, stored
