"""Rank-one update P = s·(G − c·a bᵀ): wrapper of ``csrc/rank1_update.cu``.

Counterpart of ``repro/kernels/rank1_update.py``.  ``rank1_update_stacked``
takes g (L, d_in, d_out), a (L, d_in), b (L, d_out) and the per-item
coefficients as two f32 device tensors ``coeff`` and ``scale`` of shape
(L,), any stride, or, with ``scale`` None, as the TPU kernel's ``cs``
operand: one (L, 2) tensor of [coeff, scale] pairs, read in place with its
strides.  ``rank1_update`` is the same for one matrix: g (d_in, d_out) and
0-d coefficients, or a (2,) ``cs``.  Compute is f32 and P has G's dtype.
CUDA tensors only: ``dispatch.py`` routes CPU tensors to the plain version.
Both go through the lean launch path of ``launch.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, launch, launches, ref

_SIGNATURES = {
    'repro_rank1_update': [build.P, build.I32, build.P, build.P, build.P,
                           build.I64, build.P, build.I64, build.P, build.I64,
                           build.I64, build.I64, build.P],
}
_F32_BYTES = 4
# The partition of csrc/rank1_update.cu: blocks of R1_THREADS threads, each
# thread a 16-byte vector of the flattened item a pass; one configuration
R1_THREADS = 256


def _launch(g, a, b, coeff, scale, L: int, d_in: int, d_out: int, lead,
            index: int):
    check = launch.check_f32
    check(a, lead + (d_in,), index)
    check(b, lead + (d_out,), index)
    if scale is None:              # the (…, 2) [coeff, scale] pairs
        check(coeff, lead + (2,), index, contiguous=False)
        c_ptr = coeff.data_ptr()
        c_stride = s_stride = coeff.stride(0) if lead else 0
        s_ptr = c_ptr + _F32_BYTES * coeff.stride(-1)
    else:
        check(coeff, lead, index, contiguous=False)
        check(scale, lead, index, contiguous=False)
        c_ptr, s_ptr = coeff.data_ptr(), scale.data_ptr()
        c_stride, s_stride = ((coeff.stride(0), scale.stride(0)) if lead
                              else (0, 0))
    if d_in * d_out >= 2 ** 31:
        raise ValueError(f'{d_in}x{d_out} item exceeds 32-bit indexing')
    out = torch.empty_like(g)
    launch.call(launch.entry('rank1_update', 'repro_rank1_update',
                             _SIGNATURES), index, launch.stream(index),
                'rank1_update launch', g.data_ptr(),
                g.dtype is torch.bfloat16, a.data_ptr(), b.data_ptr(), c_ptr,
                c_stride, s_ptr, s_stride, out.data_ptr(), L, d_in, d_out)
    launches.COUNTS['rank1_update'] += 1
    return out


def _plain(g, a, b, coeff, scale):
    """The plain version, with the (…, 2) pairs split."""
    if scale is None:
        coeff, scale = coeff.select(-1, 0), coeff.select(-1, 1)
    return ref.rank1_update_ref(g, a, b, coeff, scale)


def rank1_update_stacked(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         coeff: torch.Tensor,
                         scale: torch.Tensor | None = None) -> torch.Tensor:
    """P_l = scale_l · (G_l − coeff_l · a_l b_lᵀ), one launch.  coeff, scale:
    (L,) f32; or coeff the (L, 2) pairs and scale None."""
    if launch.is_fake_cuda(g):
        return launch.fake_call('rank1_update', _plain, g, a, b, coeff, scale)
    index = launch.check_g(g, 3)
    L, d_in, d_out = g.shape
    if L < 1 or L > 65535:
        raise ValueError(f'stack size L={L} outside [1, 65535]')
    return _launch(g, a, b, coeff, scale, L, d_in, d_out, (L,), index)


def rank1_update(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 coeff: torch.Tensor,
                 scale: torch.Tensor | None = None) -> torch.Tensor:
    """P = scale·(G − coeff·a bᵀ).  g: (d_in, d_out); coeff, scale: 0-d f32;
    or coeff the (2,) pair and scale None."""
    if launch.is_fake_cuda(g):
        return launch.fake_call('rank1_update', _plain, g, a, b, coeff, scale)
    index = launch.check_g(g, 2)
    d_in, d_out = g.shape
    return _launch(g, a, b, coeff, scale, 1, d_in, d_out, (), index)
