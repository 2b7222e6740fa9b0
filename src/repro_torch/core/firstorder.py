"""First-order baseline: SGD with bias-corrected EMA momentum — PyTorch
port of ``repro/core/firstorder.py::sgd``."""
from __future__ import annotations

from typing import Optional

from repro_torch.core import kv as kvlib
from repro_torch.core.transform import (GradientTransformation,
                                        add_decayed_weights, chain,
                                        clip_by_global_norm, ema_trace,
                                        scale_by_schedule)


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
    parts.append(scale_by_schedule(lr if callable(lr) else (lambda _: lr)))
    return chain(*parts)


CAPTURE = kvlib.NO_CAPTURE
