"""Kronecker-vector capture: forward statistics and zero taps — PyTorch port.

Counterpart of ``repro/core/kv.py``, for the vector statistics of Eva (ā and
b̄) and Eva-f (ā only, no taps).

* **forward stats**: every preconditioned linear records the mean of its
  input, ā = (1/n) Σ a_t, as an auxiliary output of the model's apply.
* **taps**: the layer computes ``z = x @ W + b + t`` with ``t`` a zero
  ``(d_out,)`` tensor that requires grad.  ``∂loss/∂t = Σ_t ∂loss/∂z_t``, the
  batch-summed pre-activation gradient: with the mean-loss convention this is
  the paper's b̄ = Σ_t z̃_t (z̃ = cotangent of the mean loss).  The tap rides
  in autograd's own backward; no backward hooks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.transform import scalar, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    """What statistics the optimizer wants per preconditioned layer.

    a: None | 'mean' — input-activation side (forward).
    b: None | 'mean' — pre-activation-gradient side, vector taps (d_out,).
    The reference's 'outer' (K-FAC) capture is not ported yet.
    """

    a: Optional[str] = None
    b: Optional[str] = None

    def __post_init__(self):
        for side in (self.a, self.b):
            if side not in (None, 'mean'):
                raise ValueError(f"capture {side!r} is not ported; "
                                 "have None and 'mean'")

    @property
    def needs_taps(self) -> bool:
        return self.b is not None

    @property
    def active(self) -> bool:
        return self.a is not None or self.b is not None


NO_CAPTURE = CaptureConfig(None, None)
EVA_CAPTURE = CaptureConfig('mean', 'mean')
EVA_F_CAPTURE = CaptureConfig('mean', None)


class LayerStats(NamedTuple):
    """Per-layer captured statistics; any field may be None.  ``count`` is
    the number of tokens that contributed.  The reference's ``a_outer`` /
    ``b_outer`` (K-FAC factors) are not ported."""

    a_mean: Any = None   # (..., d_in)
    b_mean: Any = None   # (..., d_out)
    count: Any = None


# ---------------------------------------------------------------------------
# Forward side


def fwd_stats(x: torch.Tensor, capture: Optional[CaptureConfig]) -> LayerStats:
    """Input mean of a linear layer's input ``x (..., d_in)``, in f32."""
    if capture is None or capture.a is None:
        return LayerStats()
    xt = x.detach().reshape(-1, x.shape[-1])
    n = xt.shape[0]
    a_mean = xt.to(F32).sum(0) / n
    return LayerStats(a_mean=a_mean, count=scalar(float(n), x.device))


# ---------------------------------------------------------------------------
# Taps


def vector_tap_shape(w_shape) -> tuple[int, ...]:
    """Weights are (..., d_in, d_out); the tap is (..., d_out)."""
    return tuple(w_shape[:-2]) + (w_shape[-1],)


def make_vector_taps(params: dict, precon_paths) -> dict[str, torch.Tensor]:
    """Zero vector taps for every preconditioned weight path, on the
    weights' device."""
    flat = flatten_params(params)
    return {path: torch.zeros(vector_tap_shape(flat[path].shape), dtype=F32,
                              device=flat[path].device)
            for path in sorted(precon_paths)}


def flatten_params(params: Any, prefix: str = '') -> dict[str, Any]:
    """Nested dict -> {'a/b/c': leaf}; a flat dict maps to itself."""
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            key = f'{prefix}/{k}' if prefix else str(k)
            out.update(flatten_params(v, key))
    else:
        out[prefix] = params
    return out


def unflatten_params(flat: dict[str, Any]) -> dict:
    out: dict[str, Any] = {}
    for path, leaf in flat.items():
        keys = path.split('/')
        d = out
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = leaf
    return out


# ---------------------------------------------------------------------------
# Finalization


def finalize_stats(forward: dict[str, LayerStats],
                   tap_grads: Optional[dict[str, torch.Tensor]],
                   capture: CaptureConfig) -> dict[str, LayerStats]:
    """Merge forward stats with the tap gradients: for vector taps the
    gradient *is* b̄."""
    out = {}
    for path, st in forward.items():
        b_mean = None
        if tap_grads is not None and path in tap_grads and capture.b == 'mean':
            b_mean = tap_grads[path].to(F32)
        out[path] = st._replace(b_mean=b_mean)
    return out


# ---------------------------------------------------------------------------
# Running averages (paper Eq. 14-15, bias-corrected).  The tree under
# ``stats`` is keyed per bucket ({'float32_16x32': LayerStats(stacked)}), so
# each EMA op covers a whole bucket field.


class RunningStats(NamedTuple):
    stats: dict[str, LayerStats]
    count: torch.Tensor  # int32 step counter for bias correction


def init_running(stats_shapes: dict[str, LayerStats]) -> RunningStats:
    zeros = tree_map(lambda x: torch.zeros(x.shape, dtype=F32,
                                           device=x.device), stats_shapes)
    device = next(t for st in zeros.values() for t in st
                  if t is not None).device
    return RunningStats(stats=zeros, count=scalar(0, device, torch.int32))


def update_running(run: RunningStats, new: dict[str, LayerStats],
                   decay: float) -> tuple[dict[str, LayerStats], RunningStats]:
    """EMA with weight ``decay`` on the old value (paper's ξ = 1-decay).

    Returns (bias-corrected stats to use this step, new running state).  The
    correction ``1 − decay**count`` is computed in f32, as the reference.
    """
    count = run.count + 1
    ema = tree_map(lambda o, s: decay * o + (1.0 - decay) * s.to(F32),
                   run.stats, new)
    corr = 1.0 - scalar(decay, count.device) ** count.to(F32)
    corrected = tree_map(lambda x: x / corr, ema)
    return corrected, RunningStats(stats=ema, count=count)
