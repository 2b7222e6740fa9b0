"""Impl and configuration autotuner feeding the kernel dispatch cache.

Counterpart of ``repro/kernels/autotune.py``.  For each (op, shape, dtype)
the tuner times the plain PyTorch version (``'torch'``) and each launch-time
configuration of the hand-written kernel (``'cuda'``,
``dispatch.configurations``) and records the winner in a JSON cache keyed
on (device type, op, shape, dtype), the format ``dispatch.install_cache``
reads and ``tile_defaults.json`` ships:

    {"version": 1,
     "backend": "cuda",
     "entries": {"cuda/matvec/float32/768x2048":
                 {"impl": "cuda", "block_in": 768, "block_out": 16,
                  "us": 21.5}}}

Determinism: given the same measurements the output bytes are the same:
entries are written with ``json.dumps(sort_keys=True, indent=2)``, the
candidates come in a fixed order ('torch' first, then the kernel's
configurations in order), and ties break toward (lower µs, 'torch' before
'cuda', smaller blocks).  A candidate builds its operands at its first
call, so a ``bench`` that never calls it (the tests' injected one) runs the
tuner on any device.  The kernel candidates launch through the wrappers,
so they count in ``launches.COUNTS``.

CLI: ``scripts/autotune_torch.py``; programmatic warm start:
``dispatch.install_cache(tune([...]))``.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import bilinear as _bil
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import matvec as _mv
from repro_torch.kernels import rank1_update as _r1
from repro_torch.kernels import ref
from repro_torch.kernels.dispatch import cache_key, configurations

OPS = ('bilinear', 'matvec', 'rank1_update')
FUSED_OPS = ('eva_fused', 'eva_f_fused')
_IMPL_RANK = {'torch': 0, 'cuda': 1}
_GAMMA, _MU, _COEFF, _SCALE = 0.03, 0.9, 0.37, 2.5


def default_bench(fn: Callable[[], object], reps: int = 3,
                  warmup: int = 1) -> float:
    """Median host µs of ``fn()``, which waits for the device itself."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2]


def _operands(d_in: int, d_out: int, dtype: torch.dtype,
              device: torch.device):
    """g (d_in, d_out) of ``dtype``, a (d_in,), b (d_out,) and the zero
    momentum (1, d_in, d_out), f32: drawn from a CPU generator seeded 0,
    then moved to the device."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn((d_in, d_out), generator=gen).to(dtype)
    a = torch.randn((d_in,), generator=gen)
    b = torch.randn((d_out,), generator=gen)
    m = torch.zeros((1, d_in, d_out))
    return tuple(x.to(device) for x in (g, a, b, m))


def _runner(op: str, impl: str, blocks: tuple[int, int], g, a, b, m
            ) -> Callable[[], object]:
    """A no-argument call of one op instance on the operands."""
    coeff = torch.tensor(_COEFF, device=g.device)
    scale = torch.tensor(_SCALE, device=g.device)
    if impl == 'torch':
        table = {
            'bilinear': lambda: ref.bilinear_and_norms_ref(g, a, b),
            'matvec': lambda: ref.matvec_and_norm_ref(g, a),
            'rank1_update': lambda: ref.rank1_update_ref(g, a, b, coeff,
                                                         scale),
            'eva_fused': lambda: ref.eva_fused_ref(
                g[None], a[None], b[None], _GAMMA, m, _MU, True),
            'eva_f_fused': lambda: ref.eva_f_fused_ref(
                g[None], a[None], _GAMMA, m, _MU, True),
        }
    else:
        warps = blocks[0] // (_mv.MV_SUB * _mv.MV_ROWS)
        table = {
            'bilinear': lambda: _bil.bilinear_and_norms(g, a, b),
            'matvec': lambda: _mv.matvec_and_norm(g, a, warps),
            'rank1_update': lambda: _r1.rank1_update(g, a, b, coeff, scale),
            'eva_fused': lambda: _fused.eva_fused_stacked(
                g[None], a[None], b[None], _GAMMA, m, _MU),
            'eva_f_fused': lambda: _fused.eva_f_fused_stacked(
                g[None], a[None], _GAMMA, m, _MU, warps=warps),
        }
    return table[op]


def _lazy_operands(d_in: int, d_out: int, dtype: torch.dtype,
                   device: torch.device) -> Callable[[], tuple]:
    """The shape's operands, made at the first call and kept."""
    made: list = []

    def operands():
        if not made:
            made.append(_operands(d_in, d_out, dtype, device))
        return made[0]
    return operands


def _candidate_fn(op: str, impl: str, blocks: tuple[int, int],
                  operands: Callable[[], tuple]) -> Callable[[], object]:
    """A no-argument callable that runs one candidate and waits for the
    device.  The operands (shared by the shape's candidates) and the call
    are made at the first call."""
    built: list = []

    def fn():
        if not built:
            built.append(_runner(op, impl, blocks, *operands()))
        out = built[0]()
        g = operands()[0]
        if g.is_cuda:
            torch.cuda.synchronize(g.device)
        return out
    return fn


def _candidates(op: str, d_in: int, d_out: int, impls
                ) -> list[tuple[str, int, int]]:
    """Fixed-order (impl, block_in, block_out): 'torch' (no blocks) first,
    then the kernel's configurations in ``dispatch.configurations`` order."""
    out = []
    if 'torch' in impls:
        out.append(('torch', 0, 0))
    if 'cuda' in impls:
        out += [('cuda', bi, bo) for bi, bo in configurations(op, d_in,
                                                               d_out)]
    return out


def _dtype(name) -> torch.dtype:
    dt = name if isinstance(name, torch.dtype) else getattr(torch, name)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f'not a dtype: {name!r}')
    return dt


def tune(shapes: Iterable[tuple[int, int]], *, ops=OPS,
         dtypes=('float32',), impls: Optional[tuple] = None,
         bench: Optional[Callable[[Callable[[], object]], float]] = None,
         backend_name: Optional[str] = None, device='cuda') -> dict:
    """Time the candidates of each (op, shape, dtype) on ``device``;
    return the cache dict (see the module docstring).  ``impls``: the
    candidates' impls, by default ('torch', 'cuda') on a CUDA device and
    ('torch',) on any other, where the kernels do not run.  ``bench(fn) ->
    µs`` is injectable (the tests pin it); ``backend_name`` overrides the
    key prefix, which is otherwise the device type."""
    bench = bench or default_bench
    dev = resolve_device(device)
    be = backend_name or dev.type
    if impls is None:
        impls = ('torch', 'cuda') if dev.type == 'cuda' else ('torch',)
    for impl in impls:
        if impl not in _IMPL_RANK:
            raise ValueError(f"impl {impl!r}: the tuner picks among "
                             f"{tuple(_IMPL_RANK)}")
    entries = {}
    for d_in, d_out in shapes:
        for name in dtypes:
            dt = _dtype(name)
            operands = _lazy_operands(d_in, d_out, dt, dev)
            for op in ops:
                best = None
                for impl, bi, bo in _candidates(op, d_in, d_out, impls):
                    us = float(bench(_candidate_fn(op, impl, (bi, bo),
                                                   operands)))
                    rank = (us, _IMPL_RANK[impl], bi, bo)
                    if best is None or rank < best[0]:
                        best = (rank, impl, bi, bo, us)
                _, impl, bi, bo, us = best
                entries[cache_key(op, d_in, d_out, dt, be)] = {
                    'impl': impl, 'block_in': bi, 'block_out': bo,
                    'us': round(us, 3)}
    return {'version': 1, 'backend': be, 'entries': entries}


def dumps(cache: dict) -> str:
    """Canonical byte-stable serialization of a tune() result."""
    return json.dumps(cache, sort_keys=True, indent=2) + '\n'


def write(cache: dict, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dumps(cache))
    return path


def merge(base: dict, new: dict) -> dict:
    """New entries win; version/backend from ``new``."""
    entries = dict(base.get('entries', {}))
    entries.update(new.get('entries', {}))
    out = dict(new)
    out['entries'] = entries
    return out
