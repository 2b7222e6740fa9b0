"""Bilinear form d = aᵀ G b (Eq. 13's numerator): wrapper of
``csrc/bilinear.cu``.

Counterpart of ``repro/kernels/bilinear.py``.  ``bilinear_and_norms_stacked``
takes a stack g (L, d_in, d_out) f32|bf16, a (L, d_in), b (L, d_out) f32 and
returns dot (L,) f32 and sq (L, 2) f32 = [‖a‖², ‖b‖²] from one launch;
``bilinear_stacked`` the dot alone, and ``bilinear`` / ``bilinear_and_norms``
the same for one matrix, run as a stack of one.  The kernel runs the first
launch of ``eva_fused`` (``csrc/eva_fused.cu``) and finishes the dot inside
the launch in the order ``eva_fused``'s second launch sums it, so on f32 G
the two give the same dot and norms bit for bit.  Its partials and arrival
counters come from the stream's workspace (``launch.py``), through the lean
launch path: call once eagerly, on the stream you capture on, with the
shapes of a CUDA graph before capturing it.  CUDA tensors only
(``dispatch.py`` routes CPU tensors to the plain versions in ``ref.py``);
nothing synchronises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, fused, launch, launches, ref

_SIGNATURES = {
    'repro_bilinear': [build.P, build.I32, build.P, build.P, build.P,
                       build.P, build.P, build.I64, build.P, build.I64,
                       build.I64, build.I64, build.I64, build.P],
}
_F32_BYTES = 4


def bilinear_plan(d_in: int, d_out: int) -> tuple[int, int, int]:
    """(rows, blocks, scratch) per stack item: ``blocks`` blocks of ``rows``
    whole rows each (the row partition of ``eva_fused``'s first launch,
    :func:`fused.eva_fused_plan`; one more block sums the norms), each
    leaving one f32 partial, so an item takes ``scratch`` f32 values and
    one counter of the workspace.  Depends on (d_in, d_out) alone."""
    rows, blocks = fused.eva_fused_plan(d_in, d_out)[:2]
    return rows, blocks, blocks


def bilinear_and_norms_stacked(g: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked aᵀ G b -> (L,) f32, and [‖a‖², ‖b‖²] -> (L, 2) f32, from one
    launch.  The norms feed Eq. 13's denominator; summed on the card in a
    fixed order, they are the same for an item alone or in a stack, as the
    dot is."""
    if launch.is_fake_cuda(g):
        return launch.fake_call('bilinear', ref.bilinear_and_norms_ref,
                                g, a, b)
    index = launch.check_g(g, 3)
    L, d_in, d_out = g.shape
    if L < 1 or L > 65535:
        raise ValueError(f'stack size L={L} outside [1, 65535]')
    launch.check_f32(a, (L, d_in), index)
    launch.check_f32(b, (L, d_out), index)
    if d_in * d_out >= 2 ** 31:
        raise ValueError(f'{d_in}x{d_out} item exceeds 32-bit indexing')
    handle = launch.stream(index)
    ws = launch.workspace(index, handle)
    scratch, counters = ws.reserve(L * bilinear_plan(d_in, d_out)[2], L)
    # one allocation for both outputs, dot (L,) then sq (L, 2), viewed with
    # as_strided, the view that costs the host least
    out = a.new_empty((3 * L,))
    ptr = out.data_ptr()
    launch.call(launch.entry('bilinear', 'repro_bilinear', _SIGNATURES),
                index, handle, 'bilinear launch', g.data_ptr(),
                g.dtype is torch.bfloat16, a.data_ptr(), b.data_ptr(), ptr,
                ptr + _F32_BYTES * L, scratch, ws.n_f32, counters, ws.n_i32,
                L, d_in, d_out)
    launches.COUNTS['bilinear'] += 1
    return out.as_strided((L,), (1,)), out.as_strided((L, 2), (2, 1), L)


def bilinear_and_norms(g, a, b):
    """Unstacked form: g (d_in, d_out) -> dot () f32, sq (2,) f32."""
    dot, sq = bilinear_and_norms_stacked(g.unsqueeze(0), a.unsqueeze(0),
                                         b.unsqueeze(0))
    return dot.select(0, 0), sq.select(0, 0)


def bilinear_stacked(g, a, b) -> torch.Tensor:
    """Stacked aᵀ G b -> (L,) f32.  g: (L, d_in, d_out); a: (L, d_in);
    b: (L, d_out)."""
    return bilinear_and_norms_stacked(g, a, b)[0]


def bilinear(g, a, b) -> torch.Tensor:
    """aᵀ G b -> () f32.  g: (d_in, d_out); a: (d_in,); b: (d_out,)."""
    return bilinear_and_norms(g, a, b)[0]
