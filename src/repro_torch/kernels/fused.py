"""Fused precondition → update epilogue: wrappers of ``csrc/eva_fused.cu``
(Eva, Eq. 13) and ``csrc/eva_f_fused.cu`` (Eva-f, Eq. 21).

Counterpart of ``repro/kernels/fused.py::eva_fused_stacked`` and
``::eva_f_fused_stacked``.  Both return out = μ·m + P (or P) in f32 and aux
(L, 3) = [⟨out,G⟩, ⟨out,out⟩, ⟨G,G⟩], every sum in a fixed order, so an item
alone and in a stack gets the same bits.

Each is one C call of two launches on the current stream, with no PyTorch
op between them (see the ``.cu`` files).  ``eva_fused_stacked``: the first
writes partial sums of aᵀGb and ‖a‖², ‖b‖², the second forms coeff = dot /
(γ + ‖a‖²‖b‖²) in each of its blocks and writes out and aux.
``eva_f_fused_stacked``: the first is the ``matvec`` kernel (u = aᵀG and
‖a‖²), the second forms coeff = 1 / (γ + ‖a‖²) in each of its blocks and
writes out and aux with the same emit body.  γ, 1/γ and μ go to the kernels
as f32 arguments; the scratch comes from the stream's workspace
(``launch.py``), through the lean launch path.

The emit kernels read m only when the momentum folds in: without the fold m
may be None, and a null pointer takes its place.  CUDA tensors only:
``dispatch.py`` routes CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launch, launches, ref
from repro_torch.kernels import matvec as _mv

_SIGNATURES = {
    'repro_eva_fused': [build.P, build.I32, build.P, build.P, build.P,
                        build.P, build.P, build.P, build.I64, build.P,
                        build.I64, ctypes.c_float, ctypes.c_float,
                        ctypes.c_float, build.I32, build.I64, build.I64,
                        build.I64, build.P],
}
_F_SIGNATURES = {
    'repro_eva_f_fused': [build.P, build.I32, build.P, build.P, build.P,
                          build.P, build.P, build.I64, build.P, build.I64,
                          ctypes.c_float, ctypes.c_float, ctypes.c_float,
                          build.I32, build.I64, build.I64, build.I64,
                          build.I32, build.P],
}

# The partition of csrc/eva_tiles.cuh: kTile elements a block, about
EF_TILE = 1024


def eva_fused_plan(d_in: int, d_out: int) -> tuple[int, int, int, int]:
    """(rows, dot_blocks, emit_blocks, scratch) per stack item: launch 1's
    dot_blocks blocks cover ``rows`` whole rows each (one more block sums
    the norms), launch 2's emit_blocks blocks EF_TILE elements each; an
    item takes ``scratch`` f32 values (its two norms and both launches'
    partials) and one counter of the workspace.  Depends on (d_in, d_out)
    alone."""
    rows = 1 if d_out >= EF_TILE else EF_TILE // d_out
    dot_blocks = -(-d_in // rows)
    emit_blocks = -(-(d_in * d_out) // EF_TILE)
    return rows, dot_blocks, emit_blocks, 2 + dot_blocks + 3 * emit_blocks


def eva_f_fused_plan(d_in: int, d_out: int) -> tuple[int, int]:
    """(emit_blocks, scratch) per stack item: launch 1 (``matvec``) leaves
    u (d_out values) and ‖a‖² in the workspace, launch 2's emit_blocks
    blocks cover EF_TILE elements each and leave one aux partial of three
    values, so an item takes ``scratch`` f32 values and one counter.
    Depends on (d_in, d_out) alone."""
    emit_blocks = -(-(d_in * d_out) // EF_TILE)
    return emit_blocks, d_out + 1 + 3 * emit_blocks


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

    Returns ``(out, aux)``: out (L, d_in, d_out) f32, aux (L, 3) f32.  The
    scratch comes from the stream's workspace (``launch.py``): call once
    eagerly, on the stream you capture on, with the shapes of a CUDA graph
    before capturing it.
    """
    if launch.is_fake_cuda(g):
        return launch.fake_call('eva_fused', ref.eva_fused_ref, g, a, b,
                                gamma, m, mu, fold_momentum)
    index = launch.check_g(g, 3)
    L, d_in, d_out = g.shape
    if L < 1 or L > 65535:
        raise ValueError(f'stack size L={L} outside [1, 65535]')
    launch.check_f32(a, (L, d_in), index)
    launch.check_f32(b, (L, d_out), index)
    ms, m_ptr = _momentum(m, fold_momentum)
    if ms:
        launch.check_f32(m, (L, d_in, d_out), index)
    if d_in * d_out >= 2 ** 31:
        raise ValueError(f'{d_in}x{d_out} item exceeds 32-bit indexing')
    handle = launch.stream(index)
    ws = launch.workspace(index, handle)
    scratch, counters = ws.reserve(L * eva_fused_plan(d_in, d_out)[3], L)
    # the allocations that cost the host least: g is contiguous, a is f32
    out = torch.empty_like(g, dtype=torch.float32)
    aux = a.new_empty((L, 3))
    launch.call(launch.entry('eva_fused', 'repro_eva_fused', _SIGNATURES),
                index, handle, 'eva_fused launch', g.data_ptr(),
                g.dtype is torch.bfloat16, a.data_ptr(), b.data_ptr(), m_ptr,
                out.data_ptr(), aux.data_ptr(), scratch, ws.n_f32, counters,
                ws.n_i32, gamma, 1.0 / gamma, mu, fold_momentum, L, d_in,
                d_out)
    launches.COUNTS['eva_fused'] += 1
    return out, aux


def eva_f_fused_stacked(g: torch.Tensor, a: torch.Tensor, gamma: float,
                        m: torch.Tensor | None, mu: float,
                        fold_momentum: bool = True, warps: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused Eva-f (Eq. 21) + epilogue; the contract of
    :func:`eva_fused_stacked` without b, u = aᵀG taking its place.  Launch 1
    runs blocks of ``warps`` warps (None: ``matvec.matvec_plan``)."""
    if launch.is_fake_cuda(g):
        return launch.fake_call('eva_f_fused', ref.eva_f_fused_ref, g, a,
                                gamma, m, mu, fold_momentum)
    index = launch.check_g(g, 3)
    L, d_in, d_out = g.shape
    if L < 1 or L > 65535:
        raise ValueError(f'stack size L={L} outside [1, 65535]')
    launch.check_f32(a, (L, d_in), index)
    ms, m_ptr = _momentum(m, fold_momentum)
    if ms:
        launch.check_f32(m, (L, d_in, d_out), index)
    if d_in * d_out >= 2 ** 31:
        raise ValueError(f'{d_in}x{d_out} item exceeds 32-bit indexing')
    handle = launch.stream(index)
    ws = launch.workspace(index, handle)
    scratch, counters = ws.reserve(L * eva_f_fused_plan(d_in, d_out)[1], L)
    out = torch.empty_like(g, dtype=torch.float32)
    aux = a.new_empty((L, 3))
    launch.call(launch.entry('eva_f_fused', 'repro_eva_f_fused',
                             _F_SIGNATURES),
                index, handle, 'eva_f_fused launch', g.data_ptr(),
                g.dtype is torch.bfloat16, a.data_ptr(), m_ptr,
                out.data_ptr(), aux.data_ptr(), scratch, ws.n_f32, counters,
                ws.n_i32, gamma, 1.0 / gamma, mu, fold_momentum, L, d_in,
                d_out, _mv.matvec_plan(d_in, d_out)[1] if warps is None
                else _mv.check_warps(warps))
    launches.COUNTS['eva_f_fused'] += 1
    return out, aux
