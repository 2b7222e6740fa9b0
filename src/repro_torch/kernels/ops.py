"""Composed Eva and Eva-f ops on top of the kernel dispatch layer.

Counterpart of ``repro/kernels/ops.py``.  Leading stack dims (bucket stacks,
see ``core/bucketing``) fold into one leading axis that the stacked kernels
take in a single launch; a plain 2-D leaf takes the unstacked form.
``denom``, ``coeff = dot/denom`` and ``scale`` stay device tensors computed
outside the kernels, as in the reference: no value comes back to the host,
so a step queues its launches without waiting on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dispatch

F32 = torch.float32


def _fold(x, n_lead):
    """Collapse the leading ``n_lead`` dims into one stack axis."""
    return x.reshape((-1,) + tuple(x.shape[n_lead:]))


def _fold_m(m, n_lead):
    """The momentum operand folded as g is; None (no fold) stays None."""
    return None if m is None else _fold(m.to(F32), n_lead)


def eva_precondition(g, a, b, gamma: float, impl: Optional[str] = None):
    """Eq. 13 via dispatched bilinear + rank1_update.

    g: (..., d_in, d_out); a: (..., d_in); b: (..., d_out).  The bilinear
    launch also returns ‖a‖² and ‖b‖² for denom = γ + ‖a‖²‖b‖².
    """
    g = g.contiguous()
    a32, b32 = a.to(F32), b.to(F32)
    if g.dim() == 2:
        dot, sq = dispatch.bilinear_and_norms(g, a32, b32, impl=impl)
        denom = gamma + sq[0] * sq[1]
        return dispatch.rank1_update(g, a32, b32, dot / denom,
                                     torch.full_like(denom, 1.0 / gamma),
                                     impl=impl)
    lead = g.shape[:-2]
    gs, as_, bs = _fold(g, g.dim() - 2), _fold(a32, a.dim() - 1), \
        _fold(b32, b.dim() - 1)
    dot, sq = dispatch.bilinear_and_norms_stacked(gs, as_, bs, impl=impl)
    denom = gamma + sq[:, 0] * sq[:, 1]                               # (L,)
    out = dispatch.rank1_update_stacked(gs, as_, bs, dot / denom,
                                        torch.full_like(denom, 1.0 / gamma),
                                        impl=impl)
    return out.reshape(lead + out.shape[1:])


def eva_f_precondition(g, a, gamma: float, impl: Optional[str] = None):
    """Eq. 21 via dispatched matvec + rank1_update, coeff = 1/(γ + ‖a‖²).

    g: (..., d_in, d_out); a: (..., d_in).  The matvec launch also returns
    ‖a‖² for the denominator.
    """
    g = g.contiguous()
    a32 = a.to(F32)
    if g.dim() == 2:
        u, asq = dispatch.matvec_and_norm(g, a32, impl=impl)
        denom = gamma + asq
        return dispatch.rank1_update(g, a32, u, 1.0 / denom,
                                     torch.full_like(denom, 1.0 / gamma),
                                     impl=impl)
    lead = g.shape[:-2]
    gs, as_ = _fold(g, g.dim() - 2), _fold(a32, a.dim() - 1)
    u, asq = dispatch.matvec_and_norm_stacked(gs, as_, impl=impl)
    denom = gamma + asq                                               # (L,)
    out = dispatch.rank1_update_stacked(gs, as_, u, 1.0 / denom,
                                        torch.full_like(denom, 1.0 / gamma),
                                        impl=impl)
    return out.reshape(lead + out.shape[1:])


def eva_fused(g, a, b, gamma: float, m, mu: float,
              fold_momentum: bool = True, impl: Optional[str] = None):
    """Eq. 13 + momentum/epilogue in one dispatched call.

    Returns ``(out, aux)``: out f32 shaped like g; aux (..., 3) per-item
    partials [⟨out,g⟩, ⟨out,out⟩, ⟨g,g⟩].  A 2-D leaf runs as a stack of one.
    m may be None when ``fold_momentum`` is off.
    """
    g = g.contiguous()
    lead = g.shape[:-2]
    n = g.dim() - 2
    gs, as_, bs, ms = (_fold(g, n), _fold(a.to(F32), a.dim() - 1),
                       _fold(b.to(F32), b.dim() - 1), _fold_m(m, n))
    out, aux = dispatch.eva_fused_stacked(gs, as_, bs, gamma, ms, mu,
                                          fold_momentum=fold_momentum,
                                          impl=impl)
    return out.reshape(lead + out.shape[1:]), aux.reshape(lead + (3,))


def eva_f_fused(g, a, gamma: float, m, mu: float,
                fold_momentum: bool = True, impl: Optional[str] = None):
    """Eq. 21 + momentum/epilogue in one dispatched call; the contract of
    :func:`eva_fused`."""
    g = g.contiguous()
    lead = g.shape[:-2]
    n = g.dim() - 2
    gs, as_, ms = (_fold(g, n), _fold(a.to(F32), a.dim() - 1),
                   _fold_m(m, n))
    out, aux = dispatch.eva_f_fused_stacked(gs, as_, gamma, ms, mu,
                                            fold_momentum=fold_momentum,
                                            impl=impl)
    return out.reshape(lead + out.shape[1:]), aux.reshape(lead + (3,))
