"""Fused Eva precondition → update epilogue: wrapper of ``csrc/eva_fused.cu``.

Counterpart of ``repro/kernels/fused.py::eva_fused_stacked``.  One call runs
four launches on the current stream (see the ``.cu`` file): the bilinear
partials and finishing launch give dot (L,) and ‖a‖², ‖b‖²; the emit kernel
divides coeff = dot/denom in-kernel, writes out = μ·m + P (or P) in f32 and
one aux partial per block; a last fixed-order sum gives aux (L, 3) =
[⟨out,G⟩, ⟨out,out⟩, ⟨G,G⟩].  denom = γ + ‖a‖²‖b‖² and 1/γ are formed
here, on the device, as the reference wrapper does; the norms come from the
finishing launch, summed in a fixed order, so an item alone and in a stack
gets the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bilinear as _bil
from repro_torch.kernels import build, launches, ref

_SIGNATURES = {
    'repro_eva_fused_emit': [build.P, build.I32, build.P, build.P, build.P,
                             build.P, build.P, build.P, build.P, build.I64,
                             build.I64, build.I64, build.I32, build.P],
}


def eva_fused_stacked(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      gamma: float, m: torch.Tensor, mu: float,
                      fold_momentum: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Eva (Eq. 13) + epilogue.  g: (L, d_in, d_out) f32|bf16;
    a: (L, d_in), b: (L, d_out), m: (L, d_in, d_out), all f32.

    Returns ``(out, aux)``: out (L, d_in, d_out) f32, aux (L, 3) f32.
    """
    if g.device.type == 'cpu':
        return ref.eva_fused_ref(g, a, b, gamma, m, mu, fold_momentum)
    L, d_in, d_out = g.shape
    check = _bil.check_operands
    check(g, a, b, m, widths=(d_in, d_out, (d_in, d_out)))
    lib = build.library('eva_fused', _SIGNATURES)
    out = torch.empty((L, d_in, d_out), dtype=torch.float32, device=g.device)
    chunks = _bil.n_chunks(d_in, d_out)
    aux_partials = torch.empty((L, chunks, 3), dtype=torch.float32,
                               device=g.device)
    with torch.cuda.device(g.device):
        dot, sq = _bil.launch_dot(g, a, b)
        denom = gamma + sq[:, 0] * sq[:, 1]
        sc = torch.stack([denom, torch.full_like(denom, 1.0 / gamma),
                          torch.full_like(denom, mu)], dim=-1)
        build.check(lib, lib.repro_eva_fused_emit(
            g.data_ptr(), int(g.dtype == torch.bfloat16), a.data_ptr(),
            b.data_ptr(), sc.data_ptr(), dot.data_ptr(), m.data_ptr(),
            out.data_ptr(), aux_partials.data_ptr(), L, d_in, d_out,
            int(fold_momentum),
            torch.cuda.current_stream(g.device).cuda_stream),
            'eva_fused emit launch')
        aux = _bil.sum_partials(aux_partials)
    launches.COUNTS['eva_fused'] += 1
    return out, aux
