"""The lean launch path of the port's kernel wrappers, and the workspace of
the kernels that finish a sum across blocks inside their launch
(``eva_fused``, ``eva_f_fused`` and ``bilinear``).

A wrapper's host work is part of every step: the rank-one update runs in a
few microseconds on the card, so building a ``torch.cuda.Stream`` object,
entering a device context or looking a C entry up by name on each call
would cost more than the kernel.  Here each C entry is bound once, the raw
stream handle is read without building a ``Stream`` (:func:`stream`), and
the device context is entered only when the operand lies on another card
than the current one.  The checks are the ones the kernels need and no
more, each a single test on the common path; only a failed test works out
which rule was broken.

A workspace holds f32 scratch (partials that pass from block to block, or
from one launch to the next) and int32 arrival counters with which a launch
finishes its sums.  The kernels leave every counter at 0, so the counters
are zeroed once, when the workspace grows, and never again.  There is one
workspace per (device, stream): the calls on one stream run one after
another, so they can share it, and calls on two streams never meet in one.
A wrapper reads the stream handle once and passes it both to
:func:`workspace` and to :func:`call`.  A workspace grows to the largest
call seen on its stream and never shrinks.  A CUDA graph captures its
pointers, so:

  * warm up on the stream you capture on: an eager call with the captured
    calls' shapes on that stream grows the workspace the capture uses;
    growth during capture raises.  A graph captured before a later growth
    still replays: the buffers it points at are kept;
  * a graph replays with the workspace of the stream it was captured on,
    whatever stream it is replayed on: do not replay it while calls on that
    stream, or another graph captured there, run at the same time.

A fake CUDA tensor (``FakeTensorMode``: a shape and a dtype, no memory) has
no pointer to launch on.  The cost trace (``launch/hlo_analysis.py``) runs a
step on such tensors; a wrapper that receives one hands it to
:func:`fake_call`, which records one custom-call entry with each active
trace and returns outputs of the right shape and dtype from the kernel's
plain version, whose ops the trace does not count.  It launches nothing and
counts no launch.  A real tensor never takes this path.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import build

F32, BF16 = torch.float32, torch.bfloat16

# (library, C entry) per entry name, bound at first use
_bound: dict[str, tuple[ctypes.CDLL, ctypes._CFuncPtr]] = {}
# the active cost traces (launch/hlo_analysis.py registers itself)
tracers: list = []


def is_fake_cuda(g) -> bool:
    """True for a fake CUDA tensor (the cost trace's operands)."""
    return isinstance(g, FakeTensor) and g.is_cuda


def fake_call(name: str, plain, *args):
    """The outputs of kernel ``name`` on fake operands ``args``: ``plain``
    (the kernel's plain version) computes them while every active trace
    stops counting, then each records one custom call of ``name``."""
    for t in tracers:
        t.suspend()
    try:
        out = plain(*args)
    finally:
        for t in tracers:
            t.resume()
    for t in tracers:
        t.custom_call(name, args, out)
    return out


def entry(lib_name: str, fn_name: str, signatures: dict[str, list]
          ) -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    """The library ``lib_name`` and its C entry ``fn_name``, built and bound
    once per process."""
    got = _bound.get(fn_name)
    if got is None:
        lib = build.library(lib_name, signatures)
        got = _bound[fn_name] = (lib, getattr(lib, fn_name))
    return got


def stream(index: int) -> int:
    """The raw handle of device ``index``'s current stream, the one
    PyTorch's current ``Stream`` wraps, read as Triton's launcher reads
    it."""
    return torch._C._cuda_getCurrentRawStream(index)


def call(bound: tuple[ctypes.CDLL, ctypes._CFuncPtr], index: int,
         handle: int, what: str, *args) -> None:
    """Launch the bound C entry with ``args`` and the stream ``handle`` of
    device ``index`` (from :func:`stream`) as its last argument; raise if
    the launch was refused."""
    lib, fn = bound
    if index == torch._C._cuda_getDevice():
        err = fn(*args, handle)
    else:
        with torch.cuda.device(index):
            err = fn(*args, handle)
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


class Workspace:
    """The scratch of one stream of one device: ``n_f32`` f32 values and
    ``n_i32`` int32 counters, zero whenever no kernel runs."""

    def __init__(self, device: torch.device):
        self.device = device
        self.n_f32 = self.n_i32 = 0
        self.ptrs = (0, 0)
        self.buffers: list[torch.Tensor] = []   # current and retired

    def reserve(self, n_f32: int, n_i32: int) -> tuple[int, int]:
        """Pointers to at least ``n_f32`` f32 values and ``n_i32`` zeroed
        counters, grown first if needed."""
        if n_f32 > self.n_f32 or n_i32 > self.n_i32:
            self._grow(max(n_f32, self.n_f32), max(n_i32, self.n_i32))
        return self.ptrs

    def _grow(self, n_f32: int, n_i32: int) -> None:
        if (self.device.type == 'cuda'
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                f'the kernel workspace of {self.device} must grow to '
                f'{n_f32} f32 values and {n_i32} counters during CUDA graph '
                'capture: run the captured calls once eagerly before capture')
        f32 = torch.empty(n_f32, dtype=F32, device=self.device)
        i32 = torch.zeros(n_i32, dtype=torch.int32, device=self.device)
        self.buffers += [f32, i32]
        self.n_f32, self.n_i32 = n_f32, n_i32
        self.ptrs = (f32.data_ptr(), i32.data_ptr())


_workspaces: dict[tuple[int, int], Workspace] = {}


def workspace(index: int, handle: int) -> Workspace:
    """The workspace of stream ``handle`` (from :func:`stream`) on CUDA
    device ``index``."""
    key = (index, handle)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = Workspace(torch.device('cuda', index))
    return ws
