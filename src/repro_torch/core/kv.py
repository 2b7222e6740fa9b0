"""Kronecker-vector and Kronecker-factor capture: forward statistics and
zero taps — PyTorch port.

Counterpart of ``repro/core/kv.py``: the vector statistics of Eva (ā and
b̄) and Eva-f (ā only, no taps), and K-FAC's factors.

* **forward stats**: every preconditioned linear records the mean of its
  input, ā = (1/n) Σ a_t, and for K-FAC the factor A = (1/n) Σ a_t a_tᵀ, as
  auxiliary outputs of the model's apply; an MoE expert weight records them
  per expert over its valid slots (``fwd_stats_masked``).
* **taps**: the layer computes ``z = x @ W + b + t`` with ``t`` a zero tensor
  that requires grad.  For a vector tap ``(d_out,)``, ``∂loss/∂t =
  Σ_t ∂loss/∂z_t``, the batch-summed pre-activation gradient: with the
  mean-loss convention this is the paper's b̄ = Σ_t z̃_t (z̃ = cotangent of
  the mean loss).  For K-FAC a full tap ``(tokens, d_out)`` keeps the
  per-token cotangent z̃_t, and B = n Σ_t z̃_t z̃_tᵀ.  The tap rides in
  autograd's own backward; no backward hooks.
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

    a: None | 'mean' | 'outer' — input-activation side (forward).
    b: None | 'mean' | 'outer' — pre-activation-gradient side:
        'mean' -> vector taps (d_out,); 'outer' -> full taps (tokens, d_out).
    """

    a: Optional[str] = None
    b: Optional[str] = None

    def __post_init__(self):
        for side in (self.a, self.b):
            if side not in (None, 'mean', 'outer'):
                raise ValueError(f"capture {side!r} is not known; have "
                                 "None, 'mean' and 'outer'")

    @property
    def needs_taps(self) -> bool:
        return self.b is not None

    @property
    def active(self) -> bool:
        return self.a is not None or self.b is not None


NO_CAPTURE = CaptureConfig(None, None)
EVA_CAPTURE = CaptureConfig('mean', 'mean')
EVA_F_CAPTURE = CaptureConfig('mean', None)
FOOF_CAPTURE = CaptureConfig('outer', None)
KFAC_CAPTURE = CaptureConfig('outer', 'outer')


class LayerStats(NamedTuple):
    """Per-layer captured statistics; any field may be None.  ``count`` is
    the number of tokens that contributed."""

    a_mean: Any = None   # (..., d_in)
    b_mean: Any = None   # (..., d_out)
    a_outer: Any = None  # (..., d_in, d_in)
    b_outer: Any = None  # (..., d_out, d_out)
    count: Any = None


# ---------------------------------------------------------------------------
# Forward side


def fwd_stats(x: torch.Tensor, capture: Optional[CaptureConfig]) -> LayerStats:
    """Input statistics of a linear layer's input ``x (..., d_in)``, in f32:
    the mean ā and, for ``a='outer'``, the factor A = (1/n) Σ a_t a_tᵀ."""
    if capture is None or capture.a is None:
        return LayerStats()
    xt = x.detach().reshape(-1, x.shape[-1]).to(F32)
    n = xt.shape[0]
    a_mean = xt.sum(0) / n
    count = scalar(float(n), x.device)
    if capture.a == 'outer':
        return LayerStats(a_mean=a_mean, a_outer=xt.T @ xt / n, count=count)
    return LayerStats(a_mean=a_mean, count=count)


def fwd_stats_masked(x: torch.Tensor, mask: torch.Tensor,
                     capture: Optional[CaptureConfig]) -> LayerStats:
    """Per-expert input statistics of an MoE expert layer, in f32.

    x: (E, C, d_in) dispatched tokens; mask: (E, C) slot validity in {0, 1}.
    ā_e is the mean over expert e's valid slots, ``count`` (E,) their number
    (a mean over max(count, 1), so an idle expert has ā = 0)."""
    if capture is None or capture.a is None:
        return LayerStats()
    x32, m32 = x.detach().to(F32), mask.detach().to(F32)
    cnt = m32.sum(-1)                                     # (E,)
    denom = torch.clamp(cnt, min=1.0)[:, None]
    a_mean = torch.bmm(m32[:, None, :], x32)[:, 0] / denom
    if capture.a == 'outer':
        xm = x32 * m32[..., None]
        a_outer = xm.transpose(1, 2) @ xm / denom[..., None]
        return LayerStats(a_mean=a_mean, a_outer=a_outer, count=cnt)
    return LayerStats(a_mean=a_mean, count=cnt)


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


def full_tap_shape(w_shape, token_shape) -> tuple[int, ...]:
    """Full (z-shaped) tap for a weight (lead..., d_in, d_out):
    (lead..., *token_shape, d_out)."""
    return tuple(w_shape[:-2]) + tuple(token_shape) + (w_shape[-1],)


def make_full_taps(params: dict, precon_paths,
                   token_shape: tuple[int, ...]) -> dict[str, torch.Tensor]:
    """Zero full taps (K-FAC's ``b='outer'`` capture) for every
    preconditioned weight path; ``token_shape`` is the token layout of the
    layer outputs, e.g. ``(batch,)`` for the MLPs.  A full tap keeps the
    per-token cotangent so that B can be formed: that memory is K-FAC's own
    cost."""
    flat = flatten_params(params)
    return {path: torch.zeros(full_tap_shape(flat[path].shape, token_shape),
                              dtype=F32, device=flat[path].device)
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
                   capture: CaptureConfig,
                   n_tokens=None) -> dict[str, LayerStats]:
    """Merge forward stats with the tap gradients.  For vector taps the
    gradient *is* b̄; where ``count`` has lead dims (a layer stack, or
    per-expert counts) b̄ is rescaled per lead item by ``n_tokens /
    max(count, 1)``, as in the reference (exactly 1 for a layer stack that
    saw every token).  For full taps the gradient is the per-token
    cotangent z̃ (lead..., tokens..., d_out): B = n Σ_t z̃_t z̃_tᵀ over the
    token axes only (n = ``n_tokens``, else the token count) and
    b̄ = Σ_t z̃_t."""
    out = {}
    for path, st in forward.items():
        b_mean = b_outer = None
        if tap_grads is not None and path in tap_grads:
            tg = tap_grads[path]
            if capture.b == 'mean':
                b_mean = tg.to(F32)
                if (st.count is not None and st.count.dim() >= 1
                        and n_tokens is not None):
                    scale = n_tokens / torch.clamp(st.count, min=1.0)
                    b_mean = b_mean * scale[..., None]
            elif capture.b == 'outer':
                # the leading stack dims survive; their count comes from the
                # forward stats of the same layer, as in the reference
                nlead = 0
                if st.a_outer is not None:
                    nlead = st.a_outer.dim() - 2
                elif st.a_mean is not None:
                    nlead = st.a_mean.dim() - 1
                zt = tg.reshape(tuple(tg.shape[:nlead]) + (-1, tg.shape[-1]))
                zt = zt.to(F32)
                n = n_tokens if n_tokens is not None else zt.shape[-2]
                b_outer = n * (zt.transpose(-1, -2) @ zt)
                b_mean = zt.sum(-2)
        out[path] = st._replace(b_mean=b_mean, b_outer=b_outer)
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
