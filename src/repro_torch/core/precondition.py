"""Sherman–Morrison rank-one preconditioning (Eq. 13, 21, 23) — PyTorch port.

Counterpart of the rank-one branches (``eva``, ``eva_f``, ``eva_s``) of
``repro/core/precondition.py``: weights are (..., d_in, d_out) and every
formula broadcasts over leading stack dims.
``impl`` ('auto' | 'cuda' | 'torch', see ``kernels/dispatch.py``) picks the
Hopper kernels or their plain versions; the reference's ``impl=None``
inline path is the port's ``'torch'`` impl.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bucketing
from repro_torch.core.transform import tree_map
from repro_torch.kernels import ops as kops

F32 = torch.float32
PORTED_METHODS = ('eva', 'eva_f', 'eva_s')


def eva_precondition(g, a, b, gamma: float, impl: str = 'auto'):
    """P = (G − (āᵀGb̄)/(γ + ‖ā‖²‖b̄‖²) · ā b̄ᵀ)/γ.
    g: (..., d_in, d_out); a: (..., d_in); b: (..., d_out)."""
    return kops.eva_precondition(g, a, b, gamma, impl=impl)


def grad_kvs(g):
    """Eva-s KVs (Eq. 23, k=2): v_in = mean of G over d_out, v_out = mean of
    G over d_in, in f32."""
    g32 = g.to(F32)
    return g32.mean(-1), g32.mean(-2)


def _precondition(method, g, st, gamma, impl):
    """One bucket stack or leaf.  Eva-f is Eq. 21, P = (G − ā (āᵀG)/(γ +
    ‖ā‖²))/γ; Eva-s has Eva's rank-one form, with the gradient's own
    (v_in, v_out) in the a_mean / b_mean slots."""
    if method == 'eva_f':
        return kops.eva_f_precondition(g, st.a_mean, gamma, impl=impl)
    return eva_precondition(g, st.a_mean, st.b_mean, gamma, impl=impl)


def _check_method(method: str) -> None:
    if method not in PORTED_METHODS:
        raise ValueError(f'method {method!r} is not ported; have '
                         f'{PORTED_METHODS}')


def _plan_for(updates, aux, plan, who):
    if plan is not None:
        return plan
    sel = {p: updates[p] for p in aux if p in updates}
    if aux and not sel:
        raise ValueError(f'{who}: no aux key matches an update path — '
                         'bucket-keyed aux requires an explicit plan=')
    return bucketing.build_plan(sel)


def _item(aux, bucket, i, aux_is_bucketed, path):
    if aux_is_bucketed:
        return tree_map(lambda x: x[i], aux[bucket.key])
    return aux[path]


def precondition_tree(updates: dict, aux: dict, method: str, gamma: float, *,
                      plan: Optional[bucketing.BucketPlan] = None,
                      impl: str = 'auto') -> dict:
    """Precondition a flat ``{path: grad}`` tree with one vectorized call per
    stacked bucket and one call per path of the smaller buckets.

    ``aux`` is per-path ``{path: kv.LayerStats}`` or the bucketed form
    ``{bucket_key: LayerStats(stacked)}`` kept in optimizer state.  Paths
    outside the plan pass through untouched.
    """
    _check_method(method)
    plan = _plan_for(updates, aux, plan, 'precondition_tree')
    aux_is_bucketed = bucketing.is_bucketed(plan, aux)
    out = dict(updates)
    big = [b for b in plan.buckets if b.stacked]
    if big:
        sub = bucketing.BucketPlan(buckets=tuple(big))
        aux_b = {b.key: aux[b.key] for b in big} if aux_is_bucketed \
            else bucketing.gather_tree(sub, aux)
        g_b = bucketing.gather(sub, {p: updates[p] for p in sub.paths})
        out_b = {b.key: _precondition(method, g_b[b.key], aux_b[b.key],
                                      gamma, impl)
                 for b in big}
        out.update(bucketing.scatter(sub, out_b))
    for b in plan.buckets:
        if b.stacked:
            continue
        for i, p in enumerate(b.paths):
            st = _item(aux, b, i, aux_is_bucketed, p)
            out[p] = _precondition(method, updates[p], st, gamma, impl)
    return out


def precondition_tree_fused(updates: dict, aux: dict, method: str,
                            gamma: float, *,
                            plan: Optional[bucketing.BucketPlan] = None,
                            trace: Optional[dict] = None,
                            momentum: float = 0.0,
                            fold_momentum: bool = False,
                            impl: str = 'auto'):
    """Fused precondition → update epilogue over a flat gradient tree: one
    ``eva_fused`` (``eva_f_fused`` for Eva-f) call per stacked bucket or per
    path of a small bucket.

    trace: flat ``{path: f32 momentum buffer}`` (missing paths get zeros),
    read only when ``fold_momentum``: without the fold no buffer is made.
    Returns ``(out, partials)``: out flat ``{path: f32}`` = μ·trace + P (or
    P); partials flat ``{path: (3,) f32}``
    = [⟨out,g⟩, ⟨out,out⟩, ⟨g,g⟩], g the incoming updates.  Paths outside
    the plan get the same epilogue in plain PyTorch.
    """
    _check_method(method)
    plan = _plan_for(updates, aux, plan, 'precondition_tree_fused')
    aux_is_bucketed = bucketing.is_bucketed(plan, aux)
    trace = trace or {}
    mu = momentum if fold_momentum else 0.0

    def m_for(p):
        if not fold_momentum:
            return None
        m = trace.get(p)
        return torch.zeros(updates[p].shape, dtype=F32,
                           device=updates[p].device) if m is None \
            else m.to(F32)

    def run(g, st, m):
        if method == 'eva_f':
            return kops.eva_f_fused(g, st.a_mean, gamma, m, mu,
                                    fold_momentum=fold_momentum, impl=impl)
        return kops.eva_fused(g, st.a_mean, st.b_mean, gamma, m, mu,
                              fold_momentum=fold_momentum, impl=impl)

    out, partials = {}, {}
    big = [b for b in plan.buckets if b.stacked]
    if big:
        sub = bucketing.BucketPlan(buckets=tuple(big))
        aux_b = {b.key: aux[b.key] for b in big} if aux_is_bucketed \
            else bucketing.gather_tree(sub, aux)
        g_b = bucketing.gather(sub, {p: updates[p] for p in sub.paths})
        m_b = bucketing.gather(sub, {p: m_for(p) for p in sub.paths}) \
            if fold_momentum else {b.key: None for b in big}
        for b in big:
            o, ax = run(g_b[b.key], aux_b[b.key], m_b[b.key])
            for i, p in enumerate(b.paths):
                out[p] = o[i]
                partials[p] = ax[i].reshape(-1, 3).sum(0)
    for b in plan.buckets:
        if b.stacked:
            continue
        for i, p in enumerate(b.paths):
            st = _item(aux, b, i, aux_is_bucketed, p)
            o, ax = run(updates[p], st, m_for(p))
            out[p] = o
            partials[p] = ax.reshape(-1, 3).sum(0)
    pre_paths = set(plan.paths)
    for p, g in updates.items():
        if p in pre_paths:
            continue
        g32 = g.to(F32)
        o = mu * m_for(p) + g32 if fold_momentum else g32
        out[p] = o
        partials[p] = torch.stack([(o * g32).sum(), (o * o).sum(),
                                   (g32 * g32).sum()])
    return out, partials
