"""Fused precondition → update epilogue: wrappers of ``csrc/eva_fused.cu``
(Eva, Eq. 13) and ``csrc/eva_f_fused.cu`` (Eva-f, Eq. 21).

Counterpart of ``repro/kernels/fused.py::eva_fused_stacked`` and
``::eva_f_fused_stacked``.  One call runs four launches on the current stream
(see the ``.cu`` files): the reduction's partials and finishing launch give
dot (L,) and ‖a‖², ‖b‖² for Eva, or u (L, d_out) and ‖a‖² for Eva-f; the emit
kernel forms coeff in-kernel (dot/denom, or 1/denom), writes out = μ·m + P
(or P) in f32 and one aux partial per block; a last fixed-order sum gives aux
(L, 3) = [⟨out,G⟩, ⟨out,out⟩, ⟨G,G⟩].  denom (γ + ‖a‖²‖b‖², or γ + ‖a‖²)
and 1/γ are formed here, on the device, as the reference wrapper does; the
norms come from the finishing launch, summed in a fixed order, so an item
alone and in a stack gets the same bits.  The emit kernels read m only when
the momentum folds in: without the fold m may be None, and a null pointer
takes its place.  CUDA tensors only: ``dispatch.py`` routes CPU tensors to
the plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bilinear as _bil
from repro_torch.kernels import build, launches
from repro_torch.kernels import matvec as _mv

_SIGNATURES = {
    'repro_eva_fused_emit': [build.P, build.I32, build.P, build.P, build.P,
                             build.P, build.P, build.P, build.P, build.I64,
                             build.I64, build.I64, build.I32, build.P],
}
_F_SIGNATURES = {
    'repro_eva_f_chunk_elems': [],
    'repro_eva_f_fused_emit': [build.P, build.I32, build.P, build.P, build.P,
                               build.P, build.P, build.P, build.I64,
                               build.I64, build.I64, build.I32, build.P],
}


def _scalars(denom: torch.Tensor, gamma: float, mu: float) -> torch.Tensor:
    """(L, 3) f32 [denom, 1/γ, μ] per item, the emit kernels' ``sc``."""
    return torch.stack([denom, torch.full_like(denom, 1.0 / gamma),
                        torch.full_like(denom, mu)], dim=-1)


def _momentum(m, fold_momentum: bool):
    """(m, pointer) for the emit kernels: m when it folds in, else a null
    pointer and nothing to check."""
    if not fold_momentum:
        return (), 0
    if m is None:
        raise ValueError('fold_momentum=True needs the momentum buffer m')
    return (m,), m.data_ptr()


def eva_fused_stacked(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      gamma: float, m: torch.Tensor | None, mu: float,
                      fold_momentum: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Eva (Eq. 13) + epilogue.  g: (L, d_in, d_out) f32|bf16;
    a: (L, d_in), b: (L, d_out), m: (L, d_in, d_out) or None without the
    fold, all f32.

    Returns ``(out, aux)``: out (L, d_in, d_out) f32, aux (L, 3) f32.
    """
    L, d_in, d_out = g.shape
    ms, m_ptr = _momentum(m, fold_momentum)
    _bil.check_operands(g, a, b, *ms, widths=(d_in, d_out, (d_in, d_out)))
    lib = build.library('eva_fused', _SIGNATURES)
    out = torch.empty((L, d_in, d_out), dtype=torch.float32, device=g.device)
    chunks = _bil.n_chunks(d_in, d_out)
    aux_partials = torch.empty((L, chunks, 3), dtype=torch.float32,
                               device=g.device)
    with torch.cuda.device(g.device):
        dot, sq = _bil.launch_dot(g, a, b)
        sc = _scalars(gamma + sq[:, 0] * sq[:, 1], gamma, mu)
        build.check(lib, lib.repro_eva_fused_emit(
            g.data_ptr(), int(g.dtype == torch.bfloat16), a.data_ptr(),
            b.data_ptr(), sc.data_ptr(), dot.data_ptr(), m_ptr,
            out.data_ptr(), aux_partials.data_ptr(), L, d_in, d_out,
            int(fold_momentum),
            torch.cuda.current_stream(g.device).cuda_stream),
            'eva_fused emit launch')
        aux = _bil.sum_partials(aux_partials)
    launches.COUNTS['eva_fused'] += 1
    return out, aux


def eva_f_fused_stacked(g: torch.Tensor, a: torch.Tensor, gamma: float,
                        m: torch.Tensor | None, mu: float,
                        fold_momentum: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Eva-f (Eq. 21) + epilogue; the contract of
    :func:`eva_fused_stacked` without b, u = aᵀG taking its place."""
    L, d_in, d_out = g.shape
    ms, m_ptr = _momentum(m, fold_momentum)
    _bil.check_operands(g, a, *ms, widths=(d_in, (d_in, d_out)))
    lib = build.library('eva_f_fused', _F_SIGNATURES)
    out = torch.empty((L, d_in, d_out), dtype=torch.float32, device=g.device)
    chunks = -(-(d_in * d_out) // lib.repro_eva_f_chunk_elems())
    aux_partials = torch.empty((L, chunks, 3), dtype=torch.float32,
                               device=g.device)
    with torch.cuda.device(g.device):
        u, asq = _mv.launch_matvec(g, a)
        sc = _scalars(gamma + asq, gamma, mu)
        build.check(lib, lib.repro_eva_f_fused_emit(
            g.data_ptr(), int(g.dtype == torch.bfloat16), a.data_ptr(),
            u.data_ptr(), sc.data_ptr(), m_ptr, out.data_ptr(),
            aux_partials.data_ptr(), L, d_in, d_out, int(fold_momentum),
            torch.cuda.current_stream(g.device).cuda_stream),
            'eva_f_fused emit launch')
        aux = _bil.sum_partials(aux_partials)
    launches.COUNTS['eva_f_fused'] += 1
    return out, aux
