"""Mamba-2's chunked SSD on the card: wrapper of ``csrc/ssd.cu``.

:func:`ssd` is ``models/ssm.py::ssd_plain`` for CUDA tensors: it returns
(y, final_state) through :class:`SSDFunction`, whose forward and backward
are the kernels.  x: (B, S, H, P) and bmat, cmat: (B, S, N), all float32 or
all bfloat16; dt: (B, S, H), a and d_skip: (H,), float32.  Each (b, t) row
of x, dt, bmat and cmat must be contiguous (x's (H, P) block too); the rows
themselves may lie apart, as in ``mamba_block``'s splits of one projection,
which are read in place.  y comes out in x's dtype, final_state in float32,
each gradient in its input's dtype.

The kernels are compiled for (chunk, d_state, headdim) in :data:`SHAPES`,
chosen from the inputs' shapes; any other raises.  A length that does not
fill the last chunk is read as padded with dt = 0, as the plain version
pads.  The forward saves, beside its inputs, seg (B, nc, H, chunk), C·Bᵀ
(B, nc, chunk, chunk) and the state entering each chunk (B, nc, H, N, P),
float32, nc = ceil(S / chunk); the backward recomputes every decay from
seg.  The backward runs under a span ``ssd`` (``obs/spans.py``).
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build, launch
from repro_torch.obs import spans as obs_spans

F32, BF16 = torch.float32, torch.bfloat16

# (chunk, d_state, headdim) the kernels are compiled for: mamba2-780m and
# jamba-v0.1-52b at their published widths, and their reduced configs
SHAPES = ((256, 128, 64), (256, 16, 64), (8, 16, 16))

# calls that launched the forward kernels, and the backward's
LAUNCHES = {'forward': 0, 'backward': 0}

_P, _I64, _I32 = build.P, build.I64, build.I32
# x, its row strides, dt, its strides, a, bmat, cmat with theirs, d_skip
_INPUTS = [_P, _I64, _I64, _P, _I64, _I64, _P, _P, _I64, _I64, _P, _I64,
           _I64, _P]
# bsz, s, h, chunk, d_state, headdim, x is bf16; then the stream
_SIZES = [_I32] * 7 + [_P]
_SIGNATURES = {
    'repro_ssd_forward': _INPUTS + [_P] * 5 + _SIZES,
    'repro_ssd_backward': _INPUTS + [_P, _I64, _I64, _P] + [_P] * 3
    + [_P] * 7 + _SIZES,
    # bsz, s, h, chunk, d_state, headdim; where the count goes
    'repro_ssd_workspace_floats': [_I32] * 6 + [_P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check(x, dt, a, bmat, cmat, d_skip, chunk: int) -> None:
    """Raise on a rank, a dtype, a layout or a shape the kernels do not
    take."""
    for name, t, rank in (('x', x, 4), ('dt', dt, 3), ('a', a, 1),
                          ('bmat', bmat, 3), ('cmat', cmat, 3),
                          ('d_skip', d_skip, 1)):
        if t.dim() != rank:
            raise ValueError(f'ssd: {name} must have {rank} dimensions, got '
                             f'{tuple(t.shape)}')
    if x.dtype is not F32 and x.dtype is not BF16:
        raise TypeError(f'ssd: x must be float32 or bfloat16, got {x.dtype}')
    for name, t, want in (('bmat', bmat, x.dtype), ('cmat', cmat, x.dtype),
                          ('dt', dt, F32), ('a', a, F32),
                          ('d_skip', d_skip, F32)):
        if t.dtype is not want:
            raise TypeError(f'ssd: {name} must be {want}, got {t.dtype}')
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    for name, t, want in (('dt', dt, (bsz, s, h)), ('a', a, (h,)),
                          ('bmat', bmat, (bsz, s, n)),
                          ('cmat', cmat, (bsz, s, n)),
                          ('d_skip', d_skip, (h,))):
        if tuple(t.shape) != want:
            raise ValueError(f'ssd: {name} has shape {tuple(t.shape)}, '
                             f'expected {want}')
    if (x.stride(3) != 1 or x.stride(2) != p or dt.stride(2) != 1
            or bmat.stride(2) != 1 or cmat.stride(2) != 1
            or a.stride(0) != 1 or d_skip.stride(0) != 1):
        raise ValueError('ssd: each (b, t) row of x, dt, bmat and cmat, and '
                         'a and d_skip, must be contiguous')
    if (chunk, n, p) not in SHAPES:
        raise ValueError(f'ssd: no kernel for chunk {chunk}, d_state {n}, '
                         f'headdim {p}; (chunk, d_state, headdim) must be '
                         f'one of {SHAPES}')


def _workspace(bsz: int, s: int, h: int, chunk: int, n: int, p: int) -> int:
    """f32 values of the backward's scratch, as csrc/ssd.cu lays it out."""
    lib, fn = launch.entry('ssd', 'repro_ssd_workspace_floats', _SIGNATURES)
    floats = ctypes.c_longlong()
    build.check(lib, fn(bsz, s, h, chunk, n, p, ctypes.addressof(floats)),
                'ssd workspace')
    return floats.value


def _rows(t) -> list:
    """An input's pointer and its (b, t) row strides."""
    return [t.data_ptr(), t.stride(0), t.stride(1)]


def _inputs(x, dt, a, bmat, cmat, d_skip) -> list:
    return [*_rows(x), *_rows(dt), a.data_ptr(), *_rows(bmat), *_rows(cmat),
            d_skip.data_ptr()]


def _launch(fn: str, index: int, what: str, *args) -> None:
    launch.call(launch.entry('ssd', fn, _SIGNATURES), index,
                launch.stream(index), what, *args)


def _forward(x, dt, a, bmat, cmat, d_skip, chunk: int):
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = -(-s // chunk)
    dev = x.device
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
    final = torch.empty((bsz, h, n, p), dtype=F32, device=dev)
    seg = torch.empty((bsz, nc, h, chunk), dtype=F32, device=dev)
    cb = torch.empty((bsz, nc, chunk, chunk), dtype=F32, device=dev)
    states = torch.empty((bsz, nc, h, n, p), dtype=F32, device=dev)
    _launch('repro_ssd_forward', x.get_device(), 'ssd forward',
            *_inputs(x, dt, a, bmat, cmat, d_skip), y.data_ptr(),
            final.data_ptr(), seg.data_ptr(), cb.data_ptr(),
            states.data_ptr(), bsz, s, h, chunk, n, p, x.dtype is BF16)
    LAUNCHES['forward'] += 1
    return y, final, seg, cb, states


def _backward(chunk: int, dy, dfinal, x, dt, a, bmat, cmat, d_skip, seg, cb,
              states):
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    if dy is None:
        dy = torch.zeros((bsz, s, h, p), dtype=x.dtype, device=dev)
    dy = dy.to(x.dtype)
    if dy.stride(3) != 1 or dy.stride(2) != p:
        dy = dy.contiguous()
    if dfinal is not None:
        dfinal = dfinal.to(F32).contiguous()
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, s, h), dtype=F32, device=dev)
    da = torch.empty((h,), dtype=F32, device=dev)
    dbm = torch.empty((bsz, s, n), dtype=x.dtype, device=dev)
    dcm = torch.empty((bsz, s, n), dtype=x.dtype, device=dev)
    dd = torch.empty((h,), dtype=F32, device=dev)
    ws = torch.empty(_workspace(bsz, s, h, chunk, n, p), dtype=F32,
                     device=dev)
    _launch('repro_ssd_backward', x.get_device(), 'ssd backward',
            *_inputs(x, dt, a, bmat, cmat, d_skip), *_rows(dy),
            0 if dfinal is None else dfinal.data_ptr(), seg.data_ptr(),
            cb.data_ptr(), states.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da.data_ptr(), dbm.data_ptr(), dcm.data_ptr(), dd.data_ptr(),
            ws.data_ptr(), bsz, s, h, chunk, n, p, x.dtype is BF16)
    LAUNCHES['backward'] += 1
    return dx, ddt, da, dbm, dcm, dd


class SSDFunction(torch.autograd.Function):
    """(y, final_state) of the chunked SSD; forward and backward are the
    kernels of csrc/ssd.cu."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, d_skip, chunk):
        y, final, seg, cb, states = _forward(x, dt, a, bmat, cmat, d_skip,
                                             chunk)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, bmat, cmat, d_skip, seg, cb, states)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dfinal):
        with obs_spans.span('ssd'):
            grads = _backward(ctx.chunk, dy, dfinal, *ctx.saved_tensors)
        return (*grads, None)


def ssd(x, dt, a, bmat, cmat, d_skip, chunk: int):
    """(y, final_state) of ``ssd_plain``'s scan on CUDA tensors, with the
    kernels' backward."""
    check(x, dt, a, bmat, cmat, d_skip, chunk)
    dev = x.device
    for name, t in (('dt', dt), ('a', a), ('bmat', bmat), ('cmat', cmat),
                    ('d_skip', d_skip)):
        if t.device != dev:
            raise ValueError(f'ssd: {name} on {t.device}, x on {dev}')
    if not x.is_cuda:
        raise ValueError(f'ssd: the kernels take CUDA tensors, got {dev}')
    return SSDFunction.apply(x, dt, a, bmat, cmat, d_skip, chunk)
