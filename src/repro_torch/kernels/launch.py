"""The lean launch path of the ``rank1_update`` and ``matvec_cols`` wrappers.

A wrapper's host work is part of every step: the rank-one update runs in a
few microseconds on the card, so building a ``torch.cuda.Stream`` object,
entering a device context or looking a C entry up by name on each call
would cost more than the kernel.  Here each C entry is bound once, the raw
stream handle is read without building a ``Stream``, and the device
context is entered only when the operand lies on another card than the
current one.  The checks are the ones the kernels need and no more, each a
single test on the common path; only a failed test works out which rule
was broken.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

F32, BF16 = torch.float32, torch.bfloat16

# (library, C entry) per entry name, bound at first use
_bound: dict[str, tuple[ctypes.CDLL, ctypes._CFuncPtr]] = {}


def entry(lib_name: str, fn_name: str, signatures: dict[str, list]
          ) -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    """The library ``lib_name`` and its C entry ``fn_name``, built and bound
    once per process."""
    got = _bound.get(fn_name)
    if got is None:
        lib = build.library(lib_name, signatures)
        got = _bound[fn_name] = (lib, getattr(lib, fn_name))
    return got


def call(bound: tuple[ctypes.CDLL, ctypes._CFuncPtr], index: int, what: str,
         *args) -> None:
    """Launch the bound C entry with ``args`` and the current stream of
    device ``index`` as its last argument (the handle PyTorch's current
    stream wraps, read as Triton's launcher reads it); raise if the launch
    was refused."""
    lib, fn = bound
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        build.check(lib, err, what)


def check_g(g: torch.Tensor, dims: int) -> int:
    """g: a contiguous f32 or bf16 CUDA tensor of ``dims`` dimensions.
    Returns its device index."""
    if ((g.dtype is F32 or g.dtype is BF16) and g.is_cuda
            and g.dim() == dims and g.is_contiguous()):
        return g.get_device()
    if g.dtype is not F32 and g.dtype is not BF16:
        raise TypeError(f'g must be float32 or bfloat16, got {g.dtype}')
    if not g.is_cuda:
        raise ValueError(f'kernel operand g must be a CUDA tensor, got '
                         f'{g.device}')
    if g.dim() != dims:
        raise ValueError(f'g must have {dims} dimensions, got '
                         f'{tuple(g.shape)}')
    raise ValueError('g must be contiguous')


def check_f32(v: torch.Tensor, shape: tuple, index: int,
              contiguous: bool = True) -> None:
    """v: an f32 tensor of ``shape`` on device ``index`` (contiguous unless
    the kernel reads it through a stride)."""
    if (v.dtype is F32 and v.shape == shape and v.get_device() == index
            and (not contiguous or v.is_contiguous())):
        return
    if v.shape != shape:
        raise ValueError(f'operand shape {tuple(v.shape)} != {shape}')
    if v.dtype is not F32:
        raise TypeError(f'per-item operands must be float32, got {v.dtype}')
    if v.get_device() != index:
        raise ValueError(f'operand on {v.device}, g on cuda:{index}')
    raise ValueError('per-item operands must be contiguous')
