"""Kernel dispatch: pick the CUDA kernel or the plain PyTorch version.

Counterpart of ``repro/kernels/dispatch.py``, with three impls:

  * ``'cuda'``  — the hand-written Hopper kernels (``csrc/*.cu``), for CUDA
                  tensors only: given a tensor on any other device,
                  :func:`resolve` raises.
  * ``'torch'`` — the plain versions in ``ref.py``, on any device.  On a CUDA
                  tensor this path is taken only when the caller names it;
                  a failed build or launch raises, it never falls back here.
  * ``'auto'``  — ``'cuda'`` for a CUDA tensor, ``'torch'`` for a CPU one.

Autotuning and the tile cache of the reference wait for a later change: the
CUDA kernels have one fixed partition each (``csrc/*.cu``), except
``matvec_cols``, whose tile ``matvec.cols_plan`` picks from the shape.
Launch counts live in ``launches.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bilinear as _bil
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import matvec as _mv
from repro_torch.kernels import rank1_update as _r1
from repro_torch.kernels import ref

IMPLS = ('auto', 'cuda', 'torch')


def resolve(impl: str, g: torch.Tensor) -> str:
    """The concrete impl ('cuda' | 'torch') for an operand ``g``."""
    if impl not in IMPLS:
        raise ValueError(f'unknown kernel impl {impl!r}; have {IMPLS}')
    if impl == 'auto':
        return 'cuda' if g.is_cuda else 'torch'
    if impl == 'cuda' and not g.is_cuda:
        raise ValueError(f"kernel impl 'cuda' needs CUDA tensors, got one on "
                         f"{g.device}; use 'auto' or 'torch'")
    return impl


def matvec_and_norm(g, a, impl: str = 'auto'):
    """(aᵀ G, ‖a‖²) for g (d_in, d_out): (d_out,) and () f32."""
    if resolve(impl, g) == 'torch':
        return ref.matvec_and_norm_ref(g, a)
    return _mv.matvec_and_norm(g, a)


def matvec_and_norm_stacked(g, a, impl: str = 'auto'):
    """The same for a stack g (L, d_in, d_out): (L, d_out) and (L,) f32."""
    if resolve(impl, g) == 'torch':
        return ref.matvec_and_norm_ref(g, a)
    return _mv.matvec_and_norm_stacked(g, a)


def matvec_cols(g, a, impl: str = 'auto'):
    """Band partial A G for a row band g (m, n) and a (R, m): (R, n) f32."""
    if resolve(impl, g) == 'torch':
        return ref.matvec_cols_ref(g, a)
    return _mv.matvec_cols(g, a)


def matvec_cols_stacked(g, a, impl: str = 'auto'):
    """The same for L bands g (L, m, n) and a (L, R, m): (L, R, n) f32."""
    if resolve(impl, g) == 'torch':
        return ref.matvec_cols_ref(g, a)
    return _mv.matvec_cols_stacked(g, a)


def bilinear_and_norms(g, a, b, impl: str = 'auto'):
    """(aᵀ G b, [‖a‖², ‖b‖²]) for g (d_in, d_out): () and (2,) f32."""
    if resolve(impl, g) == 'torch':
        return ref.bilinear_and_norms_ref(g, a, b)
    return _bil.bilinear_and_norms(g, a, b)


def bilinear_and_norms_stacked(g, a, b, impl: str = 'auto'):
    """The same for a stack g (L, d_in, d_out): (L,) and (L, 2) f32."""
    if resolve(impl, g) == 'torch':
        return ref.bilinear_and_norms_ref(g, a, b)
    return _bil.bilinear_and_norms_stacked(g, a, b)


def _pair(coeff, scale):
    """(coeff, scale) from the two tensors, or from the (..., 2) pairs."""
    return (coeff[..., 0], coeff[..., 1]) if scale is None else (coeff, scale)


def rank1_update(g, a, b, coeff, scale=None, impl: str = 'auto'):
    """coeff/scale: 0-d f32 tensors on g's device, handed to the kernel as
    they are; or coeff the (2,) [coeff, scale] pair and scale None."""
    if resolve(impl, g) == 'torch':
        return ref.rank1_update_ref(g, a, b, *_pair(coeff, scale))
    return _r1.rank1_update(g, a, b, coeff, scale)


def rank1_update_stacked(g, a, b, coeff, scale=None, impl: str = 'auto'):
    """coeff/scale: (L,) f32 tensors on g's device; or coeff the (L, 2)
    pairs and scale None."""
    if resolve(impl, g) == 'torch':
        return ref.rank1_update_ref(g, a, b, *_pair(coeff, scale))
    return _r1.rank1_update_stacked(g, a, b, coeff, scale)


def eva_fused_stacked(g, a, b, gamma: float, m, mu: float,
                      fold_momentum: bool = True, impl: str = 'auto'):
    """Fused Eva precondition + epilogue; ``(out, aux)`` as in ``fused.py``."""
    if resolve(impl, g) == 'torch':
        return ref.eva_fused_ref(g, a, b, gamma, m, mu, fold_momentum)
    return _fused.eva_fused_stacked(g, a, b, gamma, m, mu, fold_momentum)


def eva_f_fused_stacked(g, a, gamma: float, m, mu: float,
                        fold_momentum: bool = True, impl: str = 'auto'):
    """Fused Eva-f precondition + epilogue; ``(out, aux)`` as in
    ``fused.py``."""
    if resolve(impl, g) == 'torch':
        return ref.eva_f_fused_ref(g, a, gamma, m, mu, fold_momentum)
    return _fused.eva_f_fused_stacked(g, a, gamma, m, mu, fold_momentum)
