"""Eva-s (paper §4.2): vectorized Shampoo — per-mode gradient-mean KVs and
grafting to the SGD magnitude — PyTorch port.

Counterpart of ``repro/core/eva_s.py``.  Needs no capture: the KVs are the
gradient's own row and column means (``precondition.grad_kvs``), EMA'd over
steps as Eq. 14-15 do for Eva.  They live bucket-stacked in the
``a_mean``/``b_mean`` slots of ``kv.LayerStats``, and the EMA and the
rank-one update run once per (shape, dtype) bucket.  Eva-s adds no kernel:
it runs Eva's ``bilinear`` + ``rank1_update`` (or ``eva_fused``) kernels on
its own KVs.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import bucketing
from repro_torch.core import kv as kvlib
from repro_torch.core import precondition as pre
from repro_torch.core.clipping import finish_graft_ema, graft_to_grad_magnitude
from repro_torch.core.eva import (_eva_cached_init, _refresh_snapshot,
                                  _zeros_like_spec)
from repro_torch.core.transform import (Extras, GradientTransformation,
                                        add_decayed_weights, chain, ema_trace,
                                        scale_by_schedule, tree_device)
from repro_torch.kernels import dispatch
from repro_torch.schedule import policy as schedpol
from repro_torch.schedule import runtime as schedrt

F32 = torch.float32


def default_precon_predicate(path: str, leaf) -> bool:
    """Precondition every >=2-D weight; skip biases, norms and scalars."""
    return hasattr(leaf, 'ndim') and leaf.ndim >= 2


class EvaSState(NamedTuple):
    running: kvlib.RunningStats
    cached: Any
    sched: schedpol.SchedState
    trace: Any = None             # fused path: the f32 EMA momentum buffer


def _kv_init_s(params, extras, policy, interval):
    plan = bucketing.build_plan(kvlib.flatten_params(params),
                                default_precon_predicate)
    dev = tree_device(params)
    zeros = {
        b.key: kvlib.LayerStats(
            a_mean=torch.zeros((len(b.paths),) + b.shape[:-1], dtype=F32,
                               device=dev),
            b_mean=torch.zeros((len(b.paths),) + b.shape[:-2]
                               + b.shape[-1:], dtype=F32, device=dev))
        for b in plan.buckets}
    pol = schedrt.from_extras(extras).resolve(policy, interval)
    return dict(running=kvlib.init_running(zeros),
                cached=_eva_cached_init(pol, zeros),
                sched=schedpol.init_state(pol, zeros, dev))


def _kv_step_s(state, updates, extras, *, policy, interval, kv_decay):
    """Fresh (v_in, v_out) from the gradients' own means, bucket-level EMA,
    snapshot refresh.  Returns ``(flat updates, plan, applied stats,
    new-state field dict)``."""
    pol = schedrt.from_extras(extras).resolve(policy, interval)
    flat = kvlib.flatten_params(updates)
    plan = bucketing.build_plan(flat, default_precon_predicate)
    g_b = bucketing.gather(plan, {p: flat[p] for p in plan.paths})
    fresh = {}
    for b in plan.buckets:
        vi, vo = pre.grad_kvs(g_b[b.key])
        fresh[b.key] = kvlib.LayerStats(a_mean=vi, b_mean=vo)
    stats, running = kvlib.update_running(state.running, fresh, kv_decay)
    used, sched, cached = _refresh_snapshot(pol, state.sched, stats,
                                            state.cached)
    return flat, plan, used, dict(running=running, cached=cached, sched=sched)


def eva_s_preconditioner(gamma: float = 0.03, kv_decay: float = 0.95,
                         interval: int = 1,
                         policy: Optional[schedpol.RefreshPolicy] = None,
                         impl: Optional[str] = None) -> GradientTransformation:
    """Bucketed Eq. 23 (k=2): Eva's rank-one form with the EMA'd gradient
    means (v_in, v_out) in place of (ā, b̄)."""

    def init(params, extras: Optional[Extras] = None):
        return EvaSState(**_kv_init_s(params, extras, policy, interval))

    def update(updates, state: EvaSState, params=None,
               extras: Optional[Extras] = None):
        del params
        flat, plan, used, parts = _kv_step_s(
            state, updates, extras, policy=policy, interval=interval,
            kv_decay=kv_decay)
        k_impl = dispatch.impl_from_extras(extras, impl)
        out = pre.precondition_tree(flat, used, 'eva_s', gamma, plan=plan,
                                    impl=k_impl)
        return out, EvaSState(**parts)

    return GradientTransformation(init, update)


def eva_s_fused_update(gamma: float = 0.03, kv_decay: float = 0.95,
                       momentum: float = 0.9, fold_graft: bool = True,
                       impl: Optional[str] = None, interval: int = 1,
                       policy: Optional[schedpol.RefreshPolicy] = None
                       ) -> GradientTransformation:
    """Preconditioner + SGD-magnitude graft + EMA momentum as one transform.

    The ``eva_fused`` kernel emits P and the per-leaf [⟨p,g⟩, ⟨p,p⟩, ⟨g,g⟩]
    partials in one call per bucket; the graft scale √(⟨g,g⟩/⟨p,p⟩) comes
    from those.  ``fold_graft=False`` (weight decay upstream, so the kernel's
    g is not the raw gradient) takes ⟨g,g⟩ from ``extras.raw_grads``.
    """

    def init(params, extras: Optional[Extras] = None):
        return EvaSState(**_kv_init_s(params, extras, policy, interval),
                         trace=_zeros_like_spec(params))

    def update(updates, state: EvaSState, params=None,
               extras: Optional[Extras] = None):
        del params
        flat, plan, used, parts = _kv_step_s(
            state, updates, extras, policy=policy, interval=interval,
            kv_decay=kv_decay)
        k_impl = dispatch.impl_from_extras(extras, impl)
        p, partials = pre.precondition_tree_fused(
            flat, used, 'eva_s', gamma, plan=plan, fold_momentum=False,
            impl=k_impl)
        pp = {k: partials[k][1] for k in partials}
        if fold_graft:
            gg = {k: partials[k][2] for k in partials}
        else:
            raw = kvlib.flatten_params(extras.raw_grads)
            gg = {k: (raw[k].to(F32) * raw[k].to(F32)).sum()
                  for k in partials}
        out, stored = finish_graft_ema(p, pp, gg,
                                       kvlib.flatten_params(state.trace),
                                       momentum, extras.step)
        return out, EvaSState(**parts, trace=stored)

    return GradientTransformation(init, update)


def eva_s(lr=0.1, gamma: float = 0.03, kv_decay: float = 0.95,
          momentum: float = 0.9, weight_decay: float = 0.0,
          interval: int = 1,
          policy: Optional[schedpol.RefreshPolicy] = None,
          fused: bool = False,
          kernel_impl: Optional[str] = None) -> GradientTransformation:
    """Eva-s as evaluated in the paper: precondition → graft to the SGD
    magnitude → EMA momentum → −lr.  ``kernel_impl``: 'auto' | 'cuda' |
    'torch', or None for the process default."""
    parts = []
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    if fused:
        parts.append(eva_s_fused_update(
            gamma, kv_decay, momentum, fold_graft=(weight_decay == 0.0),
            impl=kernel_impl, interval=interval, policy=policy))
    else:
        parts.append(eva_s_preconditioner(gamma, kv_decay, interval=interval,
                                          policy=policy, impl=kernel_impl))
        parts.append(graft_to_grad_magnitude())
        parts.append(ema_trace(momentum))
    parts.append(scale_by_schedule(lr if callable(lr) else (lambda _: lr)))
    return chain(*parts)


CAPTURE = kvlib.NO_CAPTURE
