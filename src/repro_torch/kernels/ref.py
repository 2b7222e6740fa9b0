"""Plain PyTorch versions of the port's kernels — the CPU path and the oracle.

Counterpart of ``repro/kernels/ref.py``.  Layouts: g (..., d_in, d_out),
a (..., d_in), b (..., d_out) (``matvec_cols_ref``: a row band g (..., m, n)
and a (..., R, m)); any leading stack dims broadcast.  Every reduction is
in f32 whatever the input dtype, as in the kernels.
``dispatch.py`` routes here the ``'torch'`` impl and, under ``'auto'``,
every tensor that lies on the CPU.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def _as_f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=like.device)


def _mat(x: torch.Tensor) -> torch.Tensor:
    """(...) -> (..., 1, 1).  Views are taken by method, not by indexing,
    so the plain versions also run on fake CUDA tensors (the cost trace)
    where PyTorch has no CUDA support."""
    return x.unsqueeze(-1).unsqueeze(-1)


def matvec_ref(g, a):
    """u = aᵀ G — contraction over d_in.  (..., d_in, d_out), (..., d_in)
    -> (..., d_out) f32."""
    return torch.einsum('...io,...i->...o', g.to(F32), a.to(F32))


def matvec_cols_ref(g, a):
    """Band partial U = A G of the factor-sharded solve: g (..., m, n) row
    band, a (..., R, m) owned columns -> (..., R, n) f32."""
    return torch.einsum('...mn,...rm->...rn', g.to(F32), a.to(F32))


def matvec_and_norm_ref(g, a):
    """(aᵀ G, ‖a‖²) -> ((..., d_out) f32, (...) f32)."""
    a32 = a.to(F32)
    return matvec_ref(g, a), (a32 * a32).sum(-1)


def bilinear_ref(g, a, b):
    """aᵀ G b — one scalar per leading index.  -> (...) f32."""
    return torch.einsum('...io,...i,...o->...', g.to(F32), a.to(F32),
                        b.to(F32))


def bilinear_and_norms_ref(g, a, b):
    """(aᵀ G b, [‖a‖², ‖b‖²]) -> ((...) f32, (..., 2) f32)."""
    a32, b32 = a.to(F32), b.to(F32)
    sq = torch.stack([(a32 * a32).sum(-1), (b32 * b32).sum(-1)], dim=-1)
    return bilinear_ref(g, a, b), sq


def rank1_update_ref(g, a, b, coeff, scale):
    """P = scale · (G − coeff · a bᵀ); coeff/scale scalar or (...,).

    Computed in f32; returns G's dtype."""
    coeff = _mat(_as_f32(coeff, g))
    scale = _mat(_as_f32(scale, g))
    outer = a.to(F32).unsqueeze(-1) * b.to(F32).unsqueeze(-2)
    return (scale * (g.to(F32) - coeff * outer)).to(g.dtype)


def eva_precondition_ref(g, a, b, gamma: float):
    """Eq. 13 as the composition bilinear → rank1_update."""
    dot = bilinear_ref(g, a, b)
    a32, b32 = a.to(F32), b.to(F32)
    denom = gamma + (a32 * a32).sum(-1) * (b32 * b32).sum(-1)
    return rank1_update_ref(g, a, b, dot / denom,
                            torch.full_like(denom, 1.0 / gamma))


def eva_f_precondition_ref(g, a, gamma: float):
    """Eva-f (Eq. 21): P = (G − a (aᵀG) / (γ + ‖a‖²)) / γ."""
    u = matvec_ref(g, a)
    a32 = a.to(F32)
    denom = gamma + (a32 * a32).sum(-1)
    outer = a32.unsqueeze(-1) * u.unsqueeze(-2)
    return ((g.to(F32) - outer / _mat(denom)) / gamma).to(g.dtype)


def _fused_epilogue(g32, p, m, mu, fold_momentum):
    # m is read only with the fold; without it m may be None
    out = mu * m.to(F32) + p if fold_momentum else p
    aux = torch.stack([(out * g32).sum((-2, -1)),
                       (out * out).sum((-2, -1)),
                       (g32 * g32).sum((-2, -1))], dim=-1)
    return out, aux


def eva_fused_ref(g, a, b, gamma: float, m, mu: float,
                  fold_momentum: bool = True):
    """Plain twin of the fused kernel (``kernels/fused.py``).

    Returns ``(out, aux)``: out (..., d_in, d_out) f32 = μ·m + P (or P when
    ``fold_momentum`` is off); aux (..., 3) f32 = [⟨out,g⟩, ⟨out,out⟩,
    ⟨g,g⟩] per leading index.
    """
    g32 = g.to(F32)
    a32, b32 = a.to(F32), b.to(F32)
    dot = bilinear_ref(g, a, b)
    denom = gamma + (a32 * a32).sum(-1) * (b32 * b32).sum(-1)
    coeff = _mat(dot / denom)
    # multiply by the reciprocal, as the kernel's scale operand does
    outer = a32.unsqueeze(-1) * b32.unsqueeze(-2)
    p = (1.0 / gamma) * (g32 - coeff * outer)
    return _fused_epilogue(g32, p, m, mu, fold_momentum)


def eva_f_fused_ref(g, a, gamma: float, m, mu: float,
                    fold_momentum: bool = True):
    """Plain twin of the fused Eva-f kernel; the contract of
    :func:`eva_fused_ref` with u = aᵀG."""
    g32 = g.to(F32)
    a32 = a.to(F32)
    u = matvec_ref(g, a)
    coeff = _mat(1.0 / (gamma + (a32 * a32).sum(-1)))
    outer = a32.unsqueeze(-1) * u.unsqueeze(-2)
    p = (1.0 / gamma) * (g32 - coeff * outer)
    return _fused_epilogue(g32, p, m, mu, fold_momentum)
