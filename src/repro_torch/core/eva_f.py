"""Eva-f (paper §4.1): vectorized FOOF — input-side rank-one preconditioning
with the hyper-parameter-free KL normalization — PyTorch port.

Counterpart of ``repro/core/eva_f.py``.  Bucketed like ``eva``: one
``precondition_tree`` call per (shape, dtype) bucket, bucket-level KV EMA,
snapshot refresh through ``schedule``.  Only ā is captured: no taps.

``eva_f(fused=True)`` runs the preconditioner as one ``eva_f_fused`` call per
bucket, whose aux partials give the ⟨p, g⟩ that the normalizer needs.  The
normalize + EMA tail stays outside the kernel: its scale depends on every
bucket.  The kernel impl defaults to the process default (``'auto'``: the
Hopper kernels for CUDA tensors); ``Extras.kernel`` overrides it per step.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

from repro_torch.core import kv as kvlib
from repro_torch.core import precondition as pre
from repro_torch.core.clipping import finish_normalized_ema, kl_normalize
from repro_torch.core.eva import _kv_init, _kv_step, _zeros_like_spec
from repro_torch.core.transform import (Extras, GradientTransformation,
                                        add_decayed_weights, chain, ema_trace,
                                        scale_by_schedule, tree_vdot)
from repro_torch.kernels import dispatch
from repro_torch.schedule import policy as schedpol


class EvaFState(NamedTuple):
    running: kvlib.RunningStats
    cached: Any
    sched: schedpol.SchedState
    pipe: Any = None              # 'onestep': {'stats': PipelineState}
    trace: Any = None             # fused path: the f32 EMA momentum buffer


_FIELDS = ('a_mean',)


def eva_f_preconditioner(gamma: float = 0.03, kv_decay: float = 0.95,
                         interval: int = 1,
                         policy: Optional[schedpol.RefreshPolicy] = None,
                         impl: Optional[str] = None) -> GradientTransformation:
    """Bucketed P = (G − ā (āᵀG)/(γ + ‖ā‖²))/γ with EMA'd ā."""

    def init(params, extras: Optional[Extras] = None):
        return EvaFState(**_kv_init(params, extras, _FIELDS, policy,
                                    interval))

    def update(updates, state: EvaFState, params=None,
               extras: Optional[Extras] = None):
        del params
        flat, plan, used, parts = _kv_step(
            state, updates, extras, fields=_FIELDS, site='stats/eva_f',
            policy=policy, interval=interval, kv_decay=kv_decay)
        k_impl = dispatch.impl_from_extras(extras, impl)
        out = pre.precondition_tree(flat, used, 'eva_f', gamma, plan=plan,
                                    impl=k_impl)
        return out, EvaFState(**parts)

    return GradientTransformation(init, update)


def eva_f_fused_update(gamma: float = 0.03, kv_decay: float = 0.95,
                       momentum: float = 0.9, fold_kl: bool = True,
                       impl: Optional[str] = None, interval: int = 1,
                       policy: Optional[schedpol.RefreshPolicy] = None
                       ) -> GradientTransformation:
    """Preconditioner + KL normalize + EMA momentum as one transform.

    The kernel emits P and the per-bucket ⟨p, g⟩ partials; the tail is
    ``finish_normalized_ema``.  The momentum cannot fold into the kernel
    (the normalization comes first and its scale is global), so
    ``fold_momentum`` stays off.  ``fold_kl=False`` (weight decay upstream)
    recomputes ⟨p, raw_grads⟩ instead of trusting the kernel partials.
    """

    def init(params, extras: Optional[Extras] = None):
        return EvaFState(**_kv_init(params, extras, _FIELDS, policy,
                                    interval),
                         trace=_zeros_like_spec(params))

    def update(updates, state: EvaFState, params=None,
               extras: Optional[Extras] = None):
        del params
        flat, plan, used, parts = _kv_step(
            state, updates, extras, fields=_FIELDS, site='stats/eva_f',
            policy=policy, interval=interval, kv_decay=kv_decay)
        k_impl = dispatch.impl_from_extras(extras, impl)
        p, partials = pre.precondition_tree_fused(
            flat, used, 'eva_f', gamma, plan=plan, fold_momentum=False,
            impl=k_impl)
        if fold_kl:
            pg = sum(partials[k][0] for k in sorted(partials))
        else:
            pg = tree_vdot(p, extras.raw_grads)
        # p is this call's own f32 kernel output: scaled in place
        out, stored = finish_normalized_ema(p, pg, state.trace, momentum,
                                            extras.step, inplace=True)
        return out, EvaFState(**parts, trace=stored)

    return GradientTransformation(init, update)


def eva_f(lr=0.1, gamma: float = 0.03, kv_decay: float = 0.95,
          momentum: float = 0.9, weight_decay: float = 0.0,
          interval: int = 1,
          policy: Optional[schedpol.RefreshPolicy] = None,
          fused: bool = False,
          kernel_impl: Optional[str] = None) -> GradientTransformation:
    """Eva-f as evaluated in the paper: precondition → KL normalize → EMA
    momentum → −lr.  ``kernel_impl``: 'auto' | 'cuda' | 'torch', or None for
    the process default."""
    parts = []
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    if fused:
        parts.append(eva_f_fused_update(
            gamma, kv_decay, momentum, fold_kl=(weight_decay == 0.0),
            impl=kernel_impl, interval=interval, policy=policy))
    else:
        parts.append(eva_f_preconditioner(gamma, kv_decay, interval=interval,
                                          policy=policy, impl=kernel_impl))
        parts.append(kl_normalize())
        parts.append(ema_trace(momentum))
    parts.append(scale_by_schedule(lr if callable(lr) else (lambda _: lr)))
    return chain(*parts)


CAPTURE = kvlib.EVA_F_CAPTURE
