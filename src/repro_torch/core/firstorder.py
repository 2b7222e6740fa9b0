"""First-order baselines: SGD with bias-corrected EMA momentum, Adagrad and
AdamW — PyTorch port of ``repro/core/firstorder.py``."""
from __future__ import annotations

from typing import Optional

from repro_torch.core import kv as kvlib
from repro_torch.core.transform import (GradientTransformation,
                                        add_decayed_weights, chain,
                                        clip_by_global_norm, ema_trace,
                                        scale_by_adagrad, scale_by_adam,
                                        scale_by_schedule)


def _sched(lr):
    return lr if callable(lr) else (lambda _: lr)


def sgd(lr=0.1, momentum: float = 0.9, weight_decay: float = 0.0,
        nesterov: bool = False,
        grad_clip: Optional[float] = None) -> GradientTransformation:
    parts = []
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    if grad_clip:
        parts.append(clip_by_global_norm(grad_clip))
    if momentum:
        # the same unit-gain EMA momentum as the second-order chains
        parts.append(ema_trace(momentum, nesterov=nesterov))
    parts.append(scale_by_schedule(_sched(lr)))
    return chain(*parts)


def adagrad(lr=0.01, weight_decay: float = 0.0) -> GradientTransformation:
    parts = []
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(scale_by_adagrad())
    parts.append(scale_by_schedule(_sched(lr)))
    return chain(*parts)


def adamw(lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01,
          grad_clip: Optional[float] = None) -> GradientTransformation:
    parts = []
    if grad_clip:
        parts.append(clip_by_global_norm(grad_clip))
    parts.append(scale_by_adam(b1, b2, eps))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))  # decoupled
    parts.append(scale_by_schedule(_sched(lr)))
    return chain(*parts)


CAPTURE = kvlib.NO_CAPTURE
