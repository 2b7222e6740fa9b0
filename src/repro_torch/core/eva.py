"""Eva (paper §3): rank-one Kronecker-vector preconditioning — PyTorch port.

Counterpart of ``repro/core/eva.py``.  ``eva_preconditioner`` is the
transform (EMA'd KVs + Sherman–Morrison update, Eq. 13-15);
``eva_fused_update`` fuses it with the KL trust region and heavy-ball
momentum; ``eva`` is the paper's optimizer.  Preconditioning is bucketed
(``core/bucketing``) and the KV running stats live bucket-stacked in state.
The kernel impl defaults to the process default (``kernels/dispatch.py``,
``'auto'``: the Hopper kernels for CUDA tensors); a ``KernelConfig`` in
``Extras.kernel`` wins over it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import bucketing
from repro_torch.core import kv as kvlib
from repro_torch.core import precondition as pre
from repro_torch.core.clipping import finish_kl_clip, kl_clip_trace
from repro_torch.core.transform import (Extras, GradientTransformation,
                                        add_decayed_weights, chain, ema_trace,
                                        scale_by_schedule, tree_device,
                                        tree_map, tree_vdot)
from repro_torch.kernels import dispatch
from repro_torch.schedule import pipeline as pipemod
from repro_torch.schedule import policy as schedpol
from repro_torch.schedule import runtime as schedrt


class EvaState(NamedTuple):
    running: kvlib.RunningStats
    cached: Any                   # KV snapshot applied at the last refresh
    sched: schedpol.SchedState
    pipe: Any = None              # 'onestep': {'stats': PipelineState}
    trace: Any = None             # fused path: the f32 heavy-ball buffer


def _zeros_like_spec(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def _extract(stats: dict, fields: tuple[str, ...]) -> dict:
    """Keep only the requested LayerStats fields (None elsewhere)."""
    return {path: kvlib.LayerStats(**{f: getattr(st, f) for f in fields})
            for path, st in stats.items()}


def _stats_plan(flat_updates: dict, stats: dict,
                extras: Optional[Extras]) -> bucketing.BucketPlan:
    if extras is not None and extras.plan is not None:
        return extras.plan
    return bucketing.build_plan({p: flat_updates[p] for p in stats
                                 if p in flat_updates})


def _eva_cached_init(pol, zeros):
    """The eva family's applied-snapshot slot: None when the policy keeps
    a snapshot itself (``adaptive``), whose ``SchedState.snapshot`` follows
    the same ``where(refresh, fresh, old)`` from the same zeros; the tree is
    stored once, as in the reference."""
    return None if pol.wants_snapshot else zeros


def _refresh_snapshot(pol, sched, stats, cached):
    """The eva family's refresh: the applied KV snapshot is the
    bias-corrected EMA at the last refresh (a ``torch.where`` on a device
    bool, so nothing waits on the card).  Returns ``(applied stats, new
    SchedState, new cached slot)``; a snapshot policy reads and keeps the
    applied tree in ``SchedState.snapshot`` and its cached slot is None."""
    refresh, staleness = pol.decide(sched, stats)
    base = sched.snapshot if pol.wants_snapshot else cached
    used = tree_map(lambda f, c: torch.where(refresh, f, c), stats, base)
    new_sched = schedpol.commit(pol, sched, stats, refresh, staleness)
    return used, new_sched, (None if pol.wants_snapshot else used)


def _kv_init(params, extras, fields, policy, interval):
    """Bucket plan + zeroed running stats + refresh bookkeeping."""
    if extras is None or extras.stats is None:
        raise ValueError('eva-family preconditioner init needs example stats '
                         '(pass Extras(stats=...) — see train.init_opt_state)')
    flat = kvlib.flatten_params(params)
    plan = _stats_plan(flat, extras.stats, extras)
    zeros = bucketing.gather_tree(
        plan, _zeros_like_spec(_extract(extras.stats, fields)))
    rt = schedrt.from_extras(extras)
    pol = rt.resolve(policy, interval)
    dev = tree_device(params)
    return dict(running=kvlib.init_running(zeros),
                cached=_eva_cached_init(pol, zeros),
                sched=schedpol.init_state(pol, zeros, dev),
                pipe=schedrt.init_pipe(rt, dev, zeros, refresh=False))


def _kv_step(state, updates, extras, *, fields, site, policy, interval,
             kv_decay):
    """EMA the fresh KVs, reduced over the data group in scope (staged in
    'onestep' mode), and pick the applied snapshot.

    Returns ``(flat updates, plan, applied stats, new-state field dict)``.
    """
    rt = schedrt.from_extras(extras)
    pol = rt.resolve(policy, interval)
    pipe = schedrt.resolve_pipe(rt, state.pipe)
    flat = kvlib.flatten_params(updates)
    fresh_flat = _extract(extras.stats, fields)
    plan = _stats_plan(flat, fresh_flat, extras)
    fresh, pipe_stats = pipemod.staged_pmean(
        bucketing.gather_tree(plan, fresh_flat),
        None if pipe is None else pipe['stats'], site=site)
    stats, running = kvlib.update_running(state.running, fresh, kv_decay)
    used, sched, cached = _refresh_snapshot(pol, state.sched, stats,
                                            state.cached)
    return flat, plan, used, dict(
        running=running, cached=cached, sched=sched,
        pipe=None if pipe is None else {'stats': pipe_stats})


def eva_preconditioner(gamma: float = 0.03, kv_decay: float = 0.95,
                       interval: int = 1,
                       policy: Optional[schedpol.RefreshPolicy] = None,
                       impl: Optional[str] = None) -> GradientTransformation:
    """Bucketed P = (G − (b̄ᵀGā)/(γ+‖ā‖²‖b̄‖²)·āb̄ᵀ)/γ with EMA'd KVs."""
    fields = ('a_mean', 'b_mean')

    def init(params, extras: Optional[Extras] = None):
        return EvaState(**_kv_init(params, extras, fields, policy, interval))

    def update(updates, state: EvaState, params=None,
               extras: Optional[Extras] = None):
        del params
        flat, plan, used, parts = _kv_step(
            state, updates, extras, fields=fields, site='stats/eva',
            policy=policy, interval=interval, kv_decay=kv_decay)
        k_impl = dispatch.impl_from_extras(extras, impl)
        out = pre.precondition_tree(flat, used, 'eva', gamma, plan=plan,
                                    impl=k_impl)
        return out, EvaState(**parts)

    return GradientTransformation(init, update)


def eva_fused_update(lr=0.1, gamma: float = 0.03, kv_decay: float = 0.95,
                     kl_kappa: float = 1e-3, momentum: float = 0.9,
                     fold_kl: bool = True, impl: Optional[str] = None,
                     interval: int = 1,
                     policy: Optional[schedpol.RefreshPolicy] = None
                     ) -> GradientTransformation:
    """Preconditioner + KL trust region + heavy-ball as one transform: one
    ``eva_fused`` call per bucket, whose aux partials give the Eq. 16 uᵀg.
    ``fold_kl=False`` (weight decay before the preconditioner) recomputes
    uᵀg against ``extras.raw_grads``.  The momentum buffer lives in
    ``EvaState.trace``."""
    fields = ('a_mean', 'b_mean')

    def init(params, extras: Optional[Extras] = None):
        return EvaState(**_kv_init(params, extras, fields, policy, interval),
                        trace=_zeros_like_spec(params))

    def update(updates, state: EvaState, params=None,
               extras: Optional[Extras] = None):
        del params
        flat, plan, used, parts = _kv_step(
            state, updates, extras, fields=fields, site='stats/eva',
            policy=policy, interval=interval, kv_decay=kv_decay)
        k_impl = dispatch.impl_from_extras(extras, impl)
        u, partials = pre.precondition_tree_fused(
            flat, used, 'eva', gamma, plan=plan,
            trace=kvlib.flatten_params(state.trace), momentum=momentum,
            fold_momentum=True, impl=k_impl)
        if fold_kl:
            kl = sum(partials[p][0] for p in sorted(partials))
        else:
            kl = tree_vdot(u, extras.raw_grads)
        out, stored = finish_kl_clip(u, kl, extras.step, kl_kappa, lr)
        return out, EvaState(**parts, trace=stored)

    return GradientTransformation(init, update)


def eva(lr=0.1, gamma: float = 0.03, kv_decay: float = 0.95,
        kl_kappa: Optional[float] = 1e-3, momentum: float = 0.9,
        weight_decay: float = 0.0, nesterov: bool = False, interval: int = 1,
        policy: Optional[schedpol.RefreshPolicy] = None, fused: bool = False,
        kernel_impl: Optional[str] = None) -> GradientTransformation:
    """The full Eva optimizer as evaluated in the paper (§5).

    ``fused=True`` runs preconditioner + KL clip + momentum as one kernel
    call per bucket (``eva_fused_update``); nesterov or ``kl_kappa=None``
    keep the composed chain.  ``kernel_impl``: 'auto' | 'cuda' | 'torch', or
    None for the process default; ``Extras.kernel`` overrides it per step.
    """
    parts = []
    if weight_decay:
        # L2 enters the gradient before preconditioning, as the reference
        parts.append(add_decayed_weights(weight_decay))
    schedule = lr if callable(lr) else (lambda _: lr)
    if fused and kl_kappa is not None and not nesterov:
        parts.append(eva_fused_update(
            lr, gamma, kv_decay, kl_kappa, momentum,
            fold_kl=(weight_decay == 0.0), impl=kernel_impl,
            interval=interval, policy=policy))
        parts.append(scale_by_schedule(schedule))
        return chain(*parts)
    parts.append(eva_preconditioner(gamma, kv_decay, interval=interval,
                                    policy=policy, impl=kernel_impl))
    if kl_kappa is not None:
        # momentum lives inside the trust region (clipping.kl_clip_trace)
        parts.append(kl_clip_trace(kl_kappa, lr, momentum, nesterov=nesterov))
    else:
        parts.append(ema_trace(momentum, nesterov=nesterov))
    parts.append(scale_by_schedule(schedule))
    return chain(*parts)


CAPTURE = kvlib.EVA_CAPTURE
