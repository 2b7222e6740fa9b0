"""Sherman–Morrison rank-one preconditioning (Eq. 13, 21, 23) and the
explicit-inverse baselines (K-FAC Eq. 5, FOOF Eq. 6, Shampoo Eq. 8) —
PyTorch port.

Counterpart of ``repro/core/precondition.py`` for every method: ``eva``,
``eva_f``, ``eva_s``, ``foof``, ``kfac``, ``shampoo`` and the cached forms
``foof_cached``, ``kfac_cached`` and ``shampoo_cached``: weights are (...,
d_in, d_out) and every formula broadcasts over leading stack dims.
``impl`` ('auto' | 'cuda' | 'torch', or None for the process default, see
``kernels/dispatch.py``) picks the Hopper kernels or their plain versions
for the rank-one methods; the reference's ``impl=None`` inline path is the
port's ``'torch'`` impl.  The
explicit-inverse methods are plain PyTorch (``torch.linalg``) in f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bucketing
from repro_torch.core.transform import tree_map
from repro_torch.kernels import ops as kops

F32 = torch.float32
RANK_ONE = ('eva', 'eva_f', 'eva_s')
PORTED_METHODS = RANK_ONE + ('foof', 'kfac', 'shampoo', 'foof_cached',
                             'kfac_cached', 'shampoo_cached')


def _f32(x):
    """Promote low-precision values to f32 for the math (f64 stays f64)."""
    return x.to(torch.promote_types(x.dtype, F32))


def eva_precondition(g, a, b, gamma: float, impl: Optional[str] = None):
    """P = (G − (āᵀGb̄)/(γ + ‖ā‖²‖b̄‖²) · ā b̄ᵀ)/γ.
    g: (..., d_in, d_out); a: (..., d_in); b: (..., d_out)."""
    return kops.eva_precondition(g, a, b, gamma, impl=impl)


def eva_f_precondition(g, a, gamma: float, impl: Optional[str] = None):
    """Eq. 21, P = (G − ā (āᵀG)/(γ + ‖ā‖²))/γ.  g: (..., d_in, d_out); a:
    (..., d_in)."""
    return kops.eva_f_precondition(g, a, gamma, impl=impl)


def eva_s_precondition(g, v_in, v_out, gamma: float,
                       impl: Optional[str] = None):
    """Eva's rank-one form with the gradient's own (v_in, v_out) in place
    of (ā, b̄)."""
    return kops.eva_precondition(g, v_in, v_out, gamma, impl=impl)


def grad_kvs(g):
    """Eva-s KVs (Eq. 23, k=2): v_in = mean of G over d_out, v_out = mean of
    G over d_in, in f32."""
    g32 = g.to(F32)
    return g32.mean(-1), g32.mean(-2)


# ---------------------------------------------------------------------------
# Explicit-inverse baselines (K-FAC Eq. 5, FOOF Eq. 6, Shampoo Eq. 8)


def _damped_solve(m, rhs, gamma):
    """(M + γI)^{-1} rhs for PSD M (..., d, d); batched over leading dims."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    gam = torch.as_tensor(gamma, dtype=m.dtype, device=m.device)[..., None,
                                                                  None]
    return torch.linalg.solve(m + gam * eye, rhs)


def _damped_inv(m, gamma):
    """(M + γI)^{-1} in f32 through ``torch.linalg.inv``; ``gamma``
    broadcasts over the leading dims."""
    eye = torch.eye(m.shape[-1], dtype=F32, device=m.device)
    gam = torch.as_tensor(gamma, dtype=F32, device=m.device)[..., None, None]
    return torch.linalg.inv(m.to(F32) + gam * eye)


def kfac_pi_damping(a_outer, b_outer, gamma: float):
    """Martens–Grosse π-scaled split damping: (γ_R, γ_Q) = (π√γ, √γ/π)."""
    tr_a = torch.diagonal(a_outer, dim1=-2, dim2=-1).sum(-1) \
        / a_outer.shape[-1]
    tr_b = torch.diagonal(b_outer, dim1=-2, dim2=-1).sum(-1) \
        / b_outer.shape[-1]
    pi = torch.sqrt(torch.clamp(tr_a, min=1e-12) /
                    torch.clamp(tr_b, min=1e-12))
    root = torch.sqrt(torch.as_tensor(gamma, dtype=F32,
                                      device=a_outer.device))
    return pi * root, root / pi


def kfac_precondition(g, a_outer, b_outer, gamma: float):
    """(R + γ_R I)^{-1} G (Q + γ_Q I)^{-1} in the (d_in, d_out) layout."""
    g32 = _f32(g)
    gamma_r, gamma_q = kfac_pi_damping(a_outer, b_outer, gamma)
    left = _damped_solve(_f32(a_outer), g32, gamma_r)
    # X (Q + γI)^{-1} = solve((Q + γI)ᵀ, Xᵀ)ᵀ with Q symmetric
    right = _damped_solve(_f32(b_outer), left.transpose(-1, -2), gamma_q)
    return right.transpose(-1, -2).to(g.dtype)


def foof_precondition(g, a_outer, gamma: float):
    """(R + γI)^{-1} G: FOOF preconditions the input side only."""
    return _damped_solve(_f32(a_outer), _f32(g), gamma).to(g.dtype)


def _inv_proot_psd(m, gamma, power: float):
    """(M + γI)^{-power} for PSD M through ``torch.linalg.eigh``, batched;
    the eigenvalues are clamped at 0 before the damping is added."""
    w, v = torch.linalg.eigh(_f32(m))
    w = torch.clamp(w, min=0.0) + gamma
    return (v * w.pow(-power)[..., None, :]) @ v.transpose(-1, -2)


def shampoo_precondition(g, m_in, m_out, gamma: float):
    """G ×_in (M_in + γI)^{-1/4} ×_out (M_out + γI)^{-1/4} (k=2 modes)."""
    p_in = _inv_proot_psd(m_in, gamma, 0.25)
    p_out = _inv_proot_psd(m_out, gamma, 0.25)
    return apply_two_sided(g, p_in, p_out)


def apply_left(g, op_in):
    """op_in @ G — a cached input-side operator, batched."""
    return (op_in @ _f32(g)).to(g.dtype)


def apply_two_sided(g, op_in, op_out):
    """op_in @ G @ op_out — the cached two-sided operators, batched."""
    return ((op_in @ _f32(g)) @ op_out).to(g.dtype)


def map_bucket(fn, *args):
    """``fn`` on each row of a stack, in order, stacked again: the
    reference's ``lax.map`` over a bucket, where a batched LAPACK call
    could change an item's rounding."""
    return torch.stack([fn(*(x[i] for x in args))
                        for i in range(args[0].shape[0])])


def _precondition(method, g, st, gamma, impl, stacked=False):
    """One bucket stack or leaf.  Eva-f is Eq. 21, P = (G − ā (āᵀG)/(γ +
    ‖ā‖²))/γ; Eva-s has Eva's rank-one form, with the gradient's own
    (v_in, v_out) in the a_mean / b_mean slots.  K-FAC and Shampoo read
    their factors (or, ``*_cached``, the cached operators) from a_outer /
    b_outer, FOOF its input factor (or cached inverse) from a_outer."""
    if method == 'eva_f':
        return eva_f_precondition(g, st.a_mean, gamma, impl=impl)
    if method in ('eva', 'eva_s'):
        return eva_precondition(g, st.a_mean, st.b_mean, gamma, impl=impl)
    if method == 'foof_cached':
        return apply_left(g, st.a_outer)
    if method in ('kfac_cached', 'shampoo_cached'):
        return apply_two_sided(g, st.a_outer, st.b_outer)
    if method == 'foof':
        if stacked:
            return map_bucket(lambda *t: foof_precondition(*t, gamma), g,
                             st.a_outer)
        return foof_precondition(g, st.a_outer, gamma)
    fn = kfac_precondition if method == 'kfac' else shampoo_precondition
    if stacked:
        return map_bucket(lambda *t: fn(*t, gamma), g, st.a_outer,
                         st.b_outer)
    return fn(g, st.a_outer, st.b_outer, gamma)


def _check_method(method: str, ported=PORTED_METHODS) -> None:
    if method not in ported:
        raise ValueError(f'method {method!r} is not ported here; have '
                         f'{ported}')


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
                      impl: Optional[str] = None) -> dict:
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
                                      gamma, impl, stacked=True)
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
                            impl: Optional[str] = None):
    """Fused precondition → update epilogue over a flat gradient tree: one
    ``eva_fused`` (``eva_f_fused`` for Eva-f) call per stacked bucket or per
    path of a small bucket; rank-one methods only.

    trace: flat ``{path: f32 momentum buffer}`` (missing paths get zeros),
    read only when ``fold_momentum``: without the fold no buffer is made.
    Returns ``(out, partials)``: out flat ``{path: f32}`` = μ·trace + P (or
    P), fresh tensors the caller may write; partials flat ``{path: (3,) f32}``
    = [⟨out,g⟩, ⟨out,out⟩, ⟨g,g⟩], g the incoming updates.  Paths outside
    the plan get the same epilogue in plain PyTorch.
    """
    _check_method(method, RANK_ONE)
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
        # out is the caller's own (never the incoming tensor itself)
        o = mu * m_for(p) + g32 if fold_momentum else \
            g.to(F32, copy=True)
        out[p] = o
        partials[p] = torch.stack([(o * g32).sum(), (o * o).sum(),
                                   (g32 * g32).sum()])
    return out, partials


# ---------------------------------------------------------------------------
# Reference dense form (tests only): build the full (C + γI)^{-1} g


def eva_explicit(g, a, b, gamma: float):
    """Literal (C+γI)^{-1} vec(G) with C = (b̄b̄ᵀ)⊗(āāᵀ) — O(d⁴), tests only.

    vec() follows the paper: row-major flatten of the (d_out, d_in) weight;
    with the (d_in, d_out) layout that is ``g.T.reshape(-1)`` and
    ``C = kron(b̄b̄ᵀ, āāᵀ)``.  f32 at least (f64 stays f64).
    """
    d_in, d_out = g.shape[-2], g.shape[-1]
    g32, a32, b32 = _f32(g), _f32(a), _f32(b)
    vec = g32.transpose(-1, -2).reshape(d_out * d_in)
    c = torch.kron(torch.outer(b32, b32), torch.outer(a32, a32))
    eye = torch.eye(d_out * d_in, dtype=c.dtype, device=c.device)
    p = torch.linalg.solve(c + gamma * eye, vec)
    return p.reshape(d_out, d_in).transpose(-1, -2).to(g.dtype)
