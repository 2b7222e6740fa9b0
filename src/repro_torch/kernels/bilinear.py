"""Bilinear form d = aᵀ G b (Eq. 13's numerator): wrapper of
``csrc/bilinear.cu``.

Counterpart of ``repro/kernels/bilinear.py``.  ``bilinear_stacked`` takes a
stack g (L, d_in, d_out), a (L, d_in), b (L, d_out) and returns (L,) f32;
``bilinear`` is the same for one matrix, run as a stack of one.  The
wrappers take CUDA tensors only and raise on any other (``dispatch.py``
routes CPU tensors to the plain versions in ``ref.py``).  Outputs and scratch
come from ``torch.empty`` on the input's device; nothing synchronises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, launches

_SIGNATURES = {
    'repro_chunk_elems': [],
    'repro_bilinear_partials': [build.P, build.I32, build.P, build.P, build.P,
                                build.I64, build.I64, build.I64, build.P],
    'repro_bilinear_finish': [build.P, build.P, build.P, build.P, build.P,
                              build.I64, build.I64, build.I64, build.I64,
                              build.P],
    'repro_sum_partials': [build.P, build.P, build.I64, build.I64, build.I64,
                           build.P],
}
G_DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    return build.library('bilinear', _SIGNATURES)


def n_chunks(d_in: int, d_out: int) -> int:
    """Blocks per stack item: the partition of ``csrc/common.cuh``, which
    depends on (d_in, d_out) alone."""
    chunk = _lib().repro_chunk_elems()
    return -(-(d_in * d_out) // chunk)


def check_operands(g: torch.Tensor, *vecs: torch.Tensor,
                   widths: tuple[int, ...]) -> None:
    """Validate a CUDA launch's operands: g (L, d_in, d_out) f32|bf16 and
    the f32 per-item tensors ``vecs``, whose trailing widths are
    ``widths`` — all contiguous, on g's device."""
    if not g.is_cuda:
        raise ValueError(f'kernel operand g must be a CUDA tensor, got '
                         f'{g.device}')
    if g.dtype not in G_DTYPES:
        raise TypeError(f'g must be float32 or bfloat16, got {g.dtype}')
    if g.dim() != 3:
        raise ValueError(f'g must be (L, d_in, d_out), got {tuple(g.shape)}')
    L, d_in, d_out = g.shape
    if L < 1 or L > 65535:
        raise ValueError(f'stack size L={L} outside [1, 65535]')
    if d_in * d_out >= 2 ** 31:
        raise ValueError(f'{d_in}x{d_out} item exceeds 32-bit indexing')
    for v, w in zip(vecs, widths):
        want = (L,) + ((w,) if isinstance(w, int) else tuple(w))
        if tuple(v.shape) != want:
            raise ValueError(f'operand shape {tuple(v.shape)} != {want}')
        if v.dtype != torch.float32:
            raise TypeError(f'per-item operands must be float32, got {v.dtype}')
        if v.device != g.device:
            raise ValueError(f'operand on {v.device}, g on {g.device}')
        if not v.is_contiguous():
            raise ValueError('per-item operands must be contiguous')
    if not g.is_contiguous():
        raise ValueError('g must be contiguous')


def launch_dot(g: torch.Tensor, a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the partials kernel and the finishing launch: dot (L,) f32 and
    sq (L, 2) f32 = [‖a‖², ‖b‖²], all summed in a fixed order per item.

    Shared by the bilinear wrappers and the fused kernel's first two
    launches; it counts nothing itself."""
    L, d_in, d_out = g.shape
    lib = _lib()
    chunks = n_chunks(d_in, d_out)
    partials = torch.empty((L, chunks), dtype=torch.float32, device=g.device)
    dot = torch.empty((L,), dtype=torch.float32, device=g.device)
    sq = torch.empty((L, 2), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    build.check(lib, lib.repro_bilinear_partials(
        g.data_ptr(), int(g.dtype == torch.bfloat16), a.data_ptr(),
        b.data_ptr(), partials.data_ptr(), L, d_in, d_out, stream),
        'bilinear partials launch')
    build.check(lib, lib.repro_bilinear_finish(
        partials.data_ptr(), a.data_ptr(), b.data_ptr(), dot.data_ptr(),
        sq.data_ptr(), L, chunks, d_in, d_out, stream),
        'bilinear finish launch')
    return dot, sq


def sum_partials(partials: torch.Tensor) -> torch.Tensor:
    """(L, P, K) f32 partials -> (L, K), summed over P in a fixed order."""
    L, n, k = partials.shape
    out = torch.empty((L, k), dtype=torch.float32, device=partials.device)
    lib = _lib()
    build.check(lib, lib.repro_sum_partials(
        partials.data_ptr(), out.data_ptr(), L, n, k,
        torch.cuda.current_stream(partials.device).cuda_stream),
        'partial sum launch')
    return out


def bilinear_and_norms_stacked(g: torch.Tensor, a: torch.Tensor,
                               b: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked aᵀ G b -> (L,) f32, and [‖a‖², ‖b‖²] -> (L, 2) f32, from one
    kernel launch pair.  The norms feed Eq. 13's denominator; summed on the
    card in a fixed order, they are the same for an item alone or in a
    stack, as the dot is."""
    check_operands(g, a, b, widths=(g.shape[1], g.shape[2]))
    with torch.cuda.device(g.device):
        out = launch_dot(g, a, b)
    launches.COUNTS['bilinear'] += 1
    return out


def bilinear_and_norms(g, a, b):
    """Unstacked form: g (d_in, d_out) -> dot () f32, sq (2,) f32."""
    dot, sq = bilinear_and_norms_stacked(g[None], a[None], b[None])
    return dot[0], sq[0]


def bilinear_stacked(g, a, b) -> torch.Tensor:
    """Stacked aᵀ G b -> (L,) f32.  g: (L, d_in, d_out); a: (L, d_in);
    b: (L, d_out)."""
    return bilinear_and_norms_stacked(g, a, b)[0]


def bilinear(g, a, b) -> torch.Tensor:
    """aᵀ G b -> () f32.  g: (d_in, d_out); a: (d_in,); b: (d_out,)."""
    return bilinear_and_norms(g, a, b)[0]
