"""Vector-matrix products: wrappers of ``csrc/matvec.cu`` and
``csrc/matvec_cols.cu``.

Counterpart of ``repro/kernels/matvec.py``.  ``matvec_and_norm_stacked``
(``::matvec``, ``::matvec_stacked``) takes g (L, d_in, d_out) f32|bf16 and
a (L, d_in) f32 and returns u (L, d_out) f32 and ‖a‖² (L,) f32, both summed
on the card in a fixed order.  ``matvec_cols_stacked`` (``::matvec_cols``,
``::matvec_cols_stacked``) takes a row band g (L, m, n) f32|bf16 of L
symmetric factors and a (L, R, m) f32 and returns the band partials
A·G (L, R, n) f32 of the factor-sharded solve.  The unstacked forms run one
matrix as a stack of one.  The wrappers take CUDA tensors only and raise on
any other (``dispatch.py`` routes CPU tensors to the plain versions in
``ref.py``).  Outputs and scratch come from ``torch.empty`` on the input's
device; nothing synchronises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.bilinear import check_operands

_SIGNATURES = {
    'repro_matvec_rows': [],
    'repro_matvec_partials': [build.P, build.I32, build.P, build.P, build.I64,
                              build.I64, build.I64, build.P],
    'repro_matvec_finish': [build.P, build.P, build.P, build.P, build.I64,
                            build.I64, build.I64, build.I64, build.P],
}


_COLS_SIGNATURES = {
    'repro_matvec_cols': [build.P, build.I32, build.P, build.P, build.I64,
                          build.I64, build.I64, build.I64, build.P],
}


def _lib():
    return build.library('matvec', _SIGNATURES)


def launch_matvec(g: torch.Tensor, a: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the partials kernel and the finishing launch on checked
    operands: u (L, d_out) f32 and asq (L,) f32 = ‖a‖².

    Shared by the matvec wrappers and the fused Eva-f kernel's first two
    launches; it counts nothing itself."""
    L, d_in, d_out = g.shape
    lib = _lib()
    chunks = -(-d_in // lib.repro_matvec_rows())
    partials = torch.empty((L, chunks, d_out), dtype=torch.float32,
                           device=g.device)
    u = torch.empty((L, d_out), dtype=torch.float32, device=g.device)
    asq = torch.empty((L,), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    build.check(lib, lib.repro_matvec_partials(
        g.data_ptr(), int(g.dtype == torch.bfloat16), a.data_ptr(),
        partials.data_ptr(), L, d_in, d_out, stream), 'matvec partials launch')
    build.check(lib, lib.repro_matvec_finish(
        partials.data_ptr(), a.data_ptr(), u.data_ptr(), asq.data_ptr(), L,
        chunks, d_in, d_out, stream), 'matvec finish launch')
    return u, asq


def matvec_and_norm_stacked(g: torch.Tensor, a: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked u_l = a_lᵀ G_l -> (L, d_out) f32, and ‖a_l‖² -> (L,) f32,
    from one launch pair.  The norm feeds Eq. 21's denominator; summed in a
    fixed order, it is the same for an item alone or in a stack, as u is."""
    check_operands(g, a, widths=(g.shape[1],))
    with torch.cuda.device(g.device):
        out = launch_matvec(g, a)
    launches.COUNTS['matvec'] += 1
    return out


def matvec_and_norm(g, a):
    """Unstacked form: g (d_in, d_out) -> u (d_out,) f32, asq () f32."""
    u, asq = matvec_and_norm_stacked(g[None], a[None])
    return u[0], asq[0]


def matvec_cols_stacked(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Stacked band partials U_l = A_l G_l: g (L, m, n) f32|bf16, a (L, R, m)
    f32 -> (L, R, n) f32, from one launch.  Each output is one f32
    multiply-add chain over the band rows in order, so an item gives the
    same bits alone or in a stack."""
    check_operands(g, a, widths=((a.shape[1], g.shape[1]),))
    L, m, n = g.shape
    R = a.shape[1]
    if R < 1:
        raise ValueError('a must hold at least one vector')
    lib = build.library('matvec_cols', _COLS_SIGNATURES)
    u = torch.empty((L, R, n), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        build.check(lib, lib.repro_matvec_cols(
            g.data_ptr(), int(g.dtype == torch.bfloat16), a.data_ptr(),
            u.data_ptr(), L, R, m, n, stream), 'matvec_cols launch')
    launches.COUNTS['matvec_cols'] += 1
    return u


def matvec_cols(g, a):
    """Unstacked form: g (m, n), a (R, m) -> (R, n) f32."""
    return matvec_cols_stacked(g[None], a[None])[0]
