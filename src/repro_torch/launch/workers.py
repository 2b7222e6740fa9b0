"""Worker start-up — the port's counterpart of
``repro/launch/mesh.py::make_data_mesh``.

The reference's ``('data',)`` mesh of the first W devices becomes a
``torch.distributed`` process group of the first W ranks:

* :func:`init_workers` joins this process to the group: NCCL on ``'cuda'``,
  gloo on ``'cpu'``; gloo with CUDA tensors only when asked for by name
  (``backend='gloo'``, as when several ranks share one card: NCCL refuses
  two ranks on one GPU).  Rank r computes on ``cuda:{local_rank %
  device_count}``.
* :func:`data_group` is the subgroup of the first ``w`` ranks (the elastic
  trainer's group after a resize).  Every rank calls it for every ``w`` in
  one order, members or not: each subgroup is made by all of them.
* :func:`spawn` runs ``fn(rank, world, *args)`` in ``world`` fresh
  processes ('spawn' start method) joined through a ``FileStore`` in a
  temporary directory (no ports), waits for all of them within
  ``timeout`` seconds, kills the rest on the first failure, and returns
  each rank's result.  The CPU tests and ``chip_smoke.py`` use it alike.

Nothing starts a process or opens a group at import.
"""
from __future__ import annotations

import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

# w -> the group of the first w ranks, for the life of the default group
_GROUPS: dict[int, Any] = {}


def init_workers(backend: Optional[str] = None, device='cuda', *,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 init_method: str = 'env://') -> torch.device:
    """Join this process to the default group and return its device.

    ``rank`` and ``world`` default to the ``RANK`` and ``WORLD_SIZE``
    environment variables, the local rank (which card) to ``LOCAL_RANK``,
    else the rank; ``init_method`` is any ``torch.distributed`` one
    (``'file://<path>'`` for a FileStore).  ``backend`` None picks NCCL for
    ``'cuda'`` and gloo for ``'cpu'``."""
    dev = resolve_device(device)
    rank = int(os.environ['RANK']) if rank is None else int(rank)
    world = int(os.environ['WORLD_SIZE']) if world is None else int(world)
    local_rank = int(os.environ.get('LOCAL_RANK', rank))
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    if backend == 'nccl' and dev.type != 'cuda':
        raise ValueError("backend 'nccl' needs device 'cuda'")
    if dev.type == 'cuda':
        dev = torch.device('cuda', local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    _GROUPS.clear()
    return dev


def shutdown_workers() -> None:
    """Leave the default group (and forget its subgroups)."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def data_group(w: int):
    """The group of the first ``w`` ranks (None, the default group, when
    ``w`` is the whole world).  Collective the first time for a ``w``:
    every rank calls it at the same point."""
    w = int(w)
    size = dist.get_world_size()
    if not 1 <= w <= size:
        raise ValueError(f'world must be in [1, {size}], got {w}')
    if w == size:
        return None
    if w not in _GROUPS:
        _GROUPS[w] = dist.new_group(ranks=list(range(w)))
    return _GROUPS[w]


def _rank_main(fn: Callable, rank: int, world: int, backend: Optional[str],
               device: str, run_dir: str, threads: Optional[int],
               args: tuple) -> None:
    """One spawned rank: join the group, run ``fn``, save its result (or
    the traceback) under ``run_dir`` for the parent."""
    out = Path(run_dir)
    if threads:
        torch.set_num_threads(threads)
    try:
        init_workers(backend, device, rank=rank, world=world,
                     init_method=f'file://{out / "store"}')
        result = fn(rank, world, *args)
        torch.save(result, out / f'result_{rank}.pt')
    except BaseException:
        (out / f'error_{rank}.txt').write_text(traceback.format_exc())
        raise
    finally:
        shutdown_workers()


def spawn(fn: Callable, world: int, args: tuple = (), *,
          backend: Optional[str] = None, device='cuda',
          timeout: float = 600.0, threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes and
    return their results, rank by rank (each goes through ``torch.save``:
    keep tensors in it on the CPU).  ``fn`` and ``args`` must pickle (a
    module-level function).  Raises, with the failing rank's traceback,
    when a rank fails, and after ``timeout`` seconds; either way every
    rank still running is killed first.  ``threads``: each rank's
    ``torch.set_num_threads``."""
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory(prefix='repro_torch_spawn_') as run_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, str(device),
                                   run_dir, threads, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)
                       or (Path(run_dir) / f'error_{r}.txt').exists()]
                if bad:
                    failed = bad[0]
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f'spawn: {world} ranks of {fn.__name__} still '
                        f'running after {timeout:.0f} s')
                time.sleep(0.05)
            if failed is None:
                bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
                failed = bad[0] if bad else None
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
        if failed is not None:
            err = Path(run_dir) / f'error_{failed}.txt'
            text = err.read_text() if err.exists() else \
                f'exit code {procs[failed].exitcode}'
            raise RuntimeError(f'spawn: rank {failed} of {world} failed:\n'
                               f'{text}')
        return [torch.load(Path(run_dir) / f'result_{r}.pt',
                           map_location='cpu', weights_only=False)
                for r in range(world)]
