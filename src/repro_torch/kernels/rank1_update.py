"""Rank-one update P = s·(G − c·a bᵀ): wrapper of ``csrc/rank1_update.cu``.

Counterpart of ``repro/kernels/rank1_update.py``.  ``rank1_update_stacked``
takes g (L, d_in, d_out), a (L, d_in), b (L, d_out) and the per-item
[coeff, scale] pairs as one (L, 2) f32 device tensor, as the TPU kernel's
``cs`` operand; ``rank1_update`` runs one matrix as a stack of one.  Compute
is f32 and P has G's dtype.  CUDA tensors only: ``dispatch.py`` routes CPU
tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.bilinear import check_operands

_SIGNATURES = {
    'repro_rank1_update': [build.P, build.I32, build.P, build.P, build.P,
                           build.P, build.I64, build.I64, build.I64, build.P],
}


def rank1_update_stacked(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         cs: torch.Tensor) -> torch.Tensor:
    """P_l = cs[l, 1] · (G_l − cs[l, 0] · a_l b_lᵀ), one launch."""
    L, d_in, d_out = g.shape
    check_operands(g, a, b, cs, widths=(d_in, d_out, 2))
    lib = build.library('rank1_update', _SIGNATURES)
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        build.check(lib, lib.repro_rank1_update(
            g.data_ptr(), int(g.dtype == torch.bfloat16), a.data_ptr(),
            b.data_ptr(), cs.data_ptr(), out.data_ptr(), L, d_in, d_out,
            torch.cuda.current_stream(g.device).cuda_stream),
            'rank1_update launch')
    launches.COUNTS['rank1_update'] += 1
    return out


def rank1_update(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 cs: torch.Tensor) -> torch.Tensor:
    """P = cs[1]·(G − cs[0]·a bᵀ).  g: (d_in, d_out); cs: (2,) f32."""
    return rank1_update_stacked(g[None], a[None], b[None], cs[None])[0]
