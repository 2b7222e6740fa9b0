"""KL clipping (Eq. 16), KL normalization (§4.1) and grafting (§4.2) —
PyTorch port.

Counterpart of ``kl_clip_trace``, ``kl_normalize``,
``graft_to_grad_magnitude``, the fused tails (``finish_kl_clip``,
``ema_finish``, ``finish_normalized_ema``, ``finish_graft_ema``) and the
declarative tail of the solve-based optimizers (``Epilogue``,
``fused_tail``) in ``repro/core/clipping.py``.  The trust region
accumulates m ← μ·m + p, clips the momentum-included update by
ν = min(1, √(κ / (α² uᵀg))) and stores the clipped buffer; Eva-f rescales
by 1/√(pᵀg); Eva-s and Shampoo graft each leaf to the gradient's norm.
All scalars stay 0-d device tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.core.transform import (Extras, GradientTransformation,
                                        TraceState, _unit_init, ema_trace,
                                        scalar, tree_map, tree_vdot)

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


def kl_normalize(eps: float = 1e-12) -> GradientTransformation:
    """p / √(Σ_l p_lᵀ g_l) — the hyper-parameter-free Eva-f stabilizer."""

    def update(updates, state, params=None, extras: Optional[Extras] = None):
        del params
        s = torch.rsqrt(torch.clamp(tree_vdot(updates, extras.raw_grads),
                                    min=eps))
        return tree_map(lambda u: u * s, updates), state

    return GradientTransformation(_unit_init, update)


def graft_to_grad_magnitude(eps: float = 1e-12) -> GradientTransformation:
    """Per-leaf scale √(gᵀg / pᵀp): the preconditioned direction with the
    SGD magnitude (the Eva-s stabilizer)."""

    def leaf(u, g):
        u32, g32 = u.to(F32), g.to(F32)
        s = torch.sqrt((g32 * g32).sum() /
                       torch.clamp((u32 * u32).sum(), min=eps))
        return (u32 * s).to(u.dtype)

    def update(updates, state, params=None, extras: Optional[Extras] = None):
        del params
        return tree_map(leaf, updates, extras.raw_grads), state

    return GradientTransformation(_unit_init, update)


def ema_finish(x, trace, momentum: float, step):
    """``ema_trace`` on an already-built tree with an f32 ``trace``:
    m ← μ·m + (1−μ)·x; out = m / (1 − μ^(t+1)).  Returns ``(out, m)``."""
    out, state = ema_trace(momentum).update(x, TraceState(trace=trace),
                                            extras=Extras(step=step))
    return out, state.trace


def finish_normalized_ema(p, pg, trace, momentum: float, step,
                          eps: float = 1e-12, inplace: bool = False):
    """The ``kl_normalize`` + ``ema_trace`` tail given a precomputed
    ⟨p, g⟩.  ``inplace`` scales the caller's f32 ``p`` in place (the same
    values, one tree less in memory) when nothing else reads it."""
    s = torch.rsqrt(torch.clamp(pg, min=eps))
    scale = (lambda u: u.mul_(s)) if inplace else (lambda u: u * s)
    return ema_finish(tree_map(scale, p), trace, momentum, step)


def finish_graft_ema(p, pp, gg, trace, momentum: float, step,
                     eps: float = 1e-12):
    """The ``graft_to_grad_magnitude`` + ``ema_trace`` tail given per-leaf
    trees of ⟨p,p⟩ and ⟨g,g⟩ scalars."""
    scaled = tree_map(
        lambda u, a, b: u * torch.sqrt(b / torch.clamp(a, min=eps)),
        p, pp, gg)
    return ema_finish(scaled, trace, momentum, step)


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """An optimizer's update tail.  kind: 'kl_clip' (trust region +
    heavy-ball, the K-FAC tail) | 'kl_normalize' (global rescale + EMA
    momentum) | 'graft' (per-leaf SGD-magnitude graft + EMA momentum, the
    Shampoo tail)."""
    kind: str
    kappa: float = 1e-3
    lr: Schedule = 0.1
    momentum: float = 0.9
    nesterov: bool = False
    eps: float = 1e-12


def fused_tail(epi: Epilogue) -> GradientTransformation:
    """One transform in place of the composed [kl_clip_trace] /
    [kl_normalize + ema_trace] / [graft + ema_trace] tails: the same math
    through the ``finish_*`` helpers, one f32 ``TraceState``."""
    if epi.kind not in ('kl_clip', 'kl_normalize', 'graft'):
        raise ValueError(f'unknown epilogue kind {epi.kind!r}')

    def init(params, extras=None):
        return TraceState(trace=tree_map(
            lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
            params))

    def update(updates, state, params=None, extras: Optional[Extras] = None):
        del params
        p32 = tree_map(lambda u: u.to(F32), updates)
        if epi.kind == 'kl_clip':
            m = tree_map(lambda mm, g: epi.momentum * mm + g, state.trace,
                         p32)
            u = tree_map(lambda g, mm: g + epi.momentum * mm, p32, m) \
                if epi.nesterov else m
            out, stored = finish_kl_clip(
                u, tree_vdot(u, extras.raw_grads), extras.step, epi.kappa,
                epi.lr, m=m if epi.nesterov else None)
        elif epi.kind == 'kl_normalize':
            out, stored = finish_normalized_ema(
                p32, tree_vdot(p32, extras.raw_grads), state.trace,
                epi.momentum, extras.step, epi.eps)
        else:
            pp = tree_map(lambda u: (u * u).sum(), p32)
            gg = tree_map(lambda g: (g.to(F32) * g.to(F32)).sum(),
                          extras.raw_grads)
            out, stored = finish_graft_ema(p32, pp, gg, state.trace,
                                           epi.momentum, extras.step, epi.eps)
        return out, TraceState(trace=stored)

    return GradientTransformation(init, update)
