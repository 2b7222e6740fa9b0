"""Training launcher — PyTorch port of ``repro/launch/train.py``.

One process runs the full stack (config → model → optimizer → trainer with
checkpointing, resume and preemption) on the card, or on the CPU with
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch demo-100m \\
        --batch 16 --seq-len 512 --steps 50 --opt eva --fused

Weights come from ``init_params`` (a CPU ``torch.Generator`` seeded 0, so
every device and every rank gets the same weights); batches from
``LMStream(seed=0)`` behind a ``Prefetcher``.  The reference's flags map
onto the port:

* ``--kernel-impl {auto,cuda,torch}`` and ``--autotune`` build the
  trainer's ``KernelConfig`` (``kernels/dispatch.py``), as in the
  reference: its impl reaches Eva, Eva-f and Eva-s through
  ``Extras.kernel``, and ``--kernel-impl`` also sets
  ``FactorShardConfig.impl`` (the sharded solve's band products); left
  out, each keeps the process default, ``'auto'``.  ``--autotune`` first
  tunes the distinct trailing 2-D shapes of ``model.precon_paths()`` over
  ``autotune.OPS`` on the run's device and writes
  ``<out-dir>/<arch>-<opt>/tile_cache.json``, which the trainer installs
  (every rank, under ``--elastic``); the step records' ``kernel_tiles``
  show what each op resolved to;
* ``--head-policy``, ``--head-threshold`` and ``--solve-iters`` build the
  ``FactorShardConfig``; ``--profile`` is ``TrainerConfig(profile=True)``;
* ``--elastic --world W`` runs ``Trainer.fit_elastic`` in W processes
  (``launch/workers.py::spawn``; gloo on the CPU, NCCL on the card, one
  card a rank); ``--distributed --elastic`` runs it in this process over a
  group started from the environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, as under ``torchrun``).

Metrics go to ``<out-dir>/<arch>-<opt>/metrics.jsonl``
(``scripts/obs_report_torch.py`` reads them).
"""
from __future__ import annotations

import argparse
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.registry import ARCH_IDS, demo_lm
from repro_torch.core import kv as kvlib
from repro_torch.core import make_optimizer
from repro_torch.core.factor_sharded import FactorShardConfig
from repro_torch.data import LMStream, Prefetcher
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune
from repro_torch.kernels.dispatch import KernelConfig
from repro_torch.launch import workers
from repro_torch.models import build_model
from repro_torch.models import module as M
from repro_torch.train import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog='repro_torch.launch.train')
    ap.add_argument('--arch', default='demo',
                    help=f'demo|demo-base|demo-100m|{"|".join(ARCH_IDS)}')
    ap.add_argument('--reduced', action='store_true',
                    help='use the reduced config (CPU-runnable)')
    ap.add_argument('--opt', default='eva')
    ap.add_argument('--lr', type=float, default=0.05)
    ap.add_argument('--steps', type=int, default=100)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--seq-len', type=int, default=64)
    ap.add_argument('--ckpt-every', type=int, default=25)
    ap.add_argument('--log-every', type=int, default=10)
    ap.add_argument('--profile', action='store_true',
                    help='span-fenced phased step + memory telemetry '
                         '(repro_torch.obs; one synchronize per phase)')
    ap.add_argument('--head-policy', default='dense',
                    choices=['dense', 'exclude', 'shard'],
                    help='oversized-factor policy (core.factor_sharded): '
                         'dense, exclude (identity on that side) or shard '
                         '(matrix-free solve over band products)')
    ap.add_argument('--head-threshold', type=int, default=65536,
                    help='factor dim at/above which --head-policy applies '
                         '(vocab-scale factors by default)')
    ap.add_argument('--solve-iters', type=int, default=32,
                    help="iterations of the head-policy='shard' solve")
    ap.add_argument('--kernel-impl', default=None,
                    choices=['auto', 'cuda', 'torch'],
                    help="kernel dispatch impl for the Eva hot-path ops "
                         "(kernels.dispatch): the hand-written kernels "
                         "('cuda'), their plain PyTorch versions ('torch'), "
                         "or by cache and device ('auto'); default: leave "
                         'the optimizer on the process default')
    ap.add_argument('--autotune', action='store_true',
                    help='tune the model\'s kernel shapes before training '
                         'and install the winners (kernels.autotune)')
    ap.add_argument('--fused', action='store_true',
                    help='fused precondition→update epilogue: one kernel '
                         'call per bucket for eva/eva_f/eva_s, single-'
                         'traversal elementwise tail for kfac/foof/shampoo')
    ap.add_argument('--out-dir', default='runs/launch')
    ap.add_argument('--no-prefetch', action='store_true')
    ap.add_argument('--distributed', action='store_true',
                    help='join a torch.distributed group from the '
                         'environment (torchrun) and run the elastic loop '
                         'in this process')
    ap.add_argument('--elastic', action='store_true',
                    help='elastic outer loop (Trainer.fit_elastic): explicit '
                         'DP over --world workers; checkpoints reshard '
                         'across world sizes (docs/CHECKPOINT_FORMAT.md)')
    ap.add_argument('--world', type=int, default=0,
                    help='data-parallel worker count for --elastic '
                         '(0 = every card; 1 on the CPU)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    return ap


def arch_config(args):
    """The run's ArchConfig; archs without token input are refused."""
    if args.arch == 'demo':
        cfg = demo_lm('small')
    elif args.arch.startswith('demo-'):
        cfg = demo_lm(args.arch.split('-', 1)[1])
    else:
        cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family in ('encdec', 'vlm') or cfg.input_is_embeds:
        raise SystemExit(f'{cfg.name}: use the dry-run/examples for stub-'
                         'frontend archs; the LM trainer needs token input')
    return cfg


def init_params(model, device) -> dict:
    """The run's weights: one draw from a CPU generator seeded 0."""
    return M.init_params(model.param_specs(),
                         torch.Generator().manual_seed(0), device=device)


@functools.lru_cache(maxsize=1)
def lm_stream(vocab: int, seq_len: int, batch: int, device: str) -> LMStream:
    """The run's batches, ``LMStream(seed=0)``.  The stream is kept for the
    next run of this process with the same shape: a vocab-32768 chain
    takes tens of seconds to build.  ``lm_stream.cache_clear()`` frees
    it."""
    return LMStream(vocab=vocab, seq_len=seq_len, batch=batch, seed=0,
                    device=device)


def _opt_kwargs(args) -> dict:
    kw = {'lr': args.lr}
    if args.fused:
        kw['fused'] = True
    return kw


def _precon_shapes(model) -> list[tuple[int, int]]:
    """The distinct trailing 2-D shapes of the preconditioned weights:
    the shapes the dispatch resolves (a layer stack shares one)."""
    flat = M.flatten_specs(model.param_specs())
    return sorted({tuple(int(d) for d in flat[p].shape[-2:])
                   for p in model.precon_paths()
                   if p in flat and len(flat[p].shape) >= 2})


def kernel_config(args, device, tune: bool = True
                  ) -> Optional[KernelConfig]:
    """The run's ``KernelConfig`` from ``--kernel-impl`` and
    ``--autotune``; None without either.  ``--autotune`` tunes the model's
    shapes on ``device`` and writes the cache (``tune=False``: only names
    the file another process writes)."""
    if not (args.kernel_impl or args.autotune):
        return None
    cache_path = None
    if args.autotune:
        cfg = arch_config(args)
        cache_path = f'{args.out_dir}/{cfg.name}-{args.opt}/tile_cache.json'
        if tune:
            shapes = _precon_shapes(build_model(cfg))
            print(f'[launch] autotuning {len(shapes)} shapes: {shapes}',
                  flush=True)
            cache = autotune.tune(shapes, device=device)
            cache_path = str(autotune.write(cache, cache_path))
            print(f'[launch] autotune cache -> {cache_path}', flush=True)
    return KernelConfig(impl=args.kernel_impl or 'auto',
                        autotune_cache=cache_path, autotune=args.autotune)


def run(args, device, world: Optional[int] = None,
        kernel: Optional[KernelConfig] = None) -> list:
    """Build and train one run on ``device``; ``world`` set: the elastic
    loop over a started group; ``kernel``: the trainer's ``KernelConfig``.
    Returns the trainer's history."""
    cfg = arch_config(args)
    model = build_model(cfg)
    params = init_params(model, device)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f'{cfg.name}: {M.count_params(model.param_specs())/1e6:.2f}M '
              'params', flush=True)
    stream = lm_stream(cfg.vocab, args.seq_len, args.batch, str(device))
    opt, capture = make_optimizer(args.opt, **_opt_kwargs(args))
    taps_fn = None
    if capture.b == 'outer':
        # K-FAC-style capture needs full z-shaped taps, sized from the
        # batch each step is handed (a rank's rows under the elastic loop)
        paths = set(model.precon_paths()) & set(kvlib.flatten_params(params))
        taps_fn = lambda p, b: kvlib.make_full_taps(  # noqa: E731
            p, paths, tuple(b['tokens'].shape))
    factor = None
    if args.head_policy != 'dense':
        factor = FactorShardConfig(head_policy=args.head_policy,
                                   shard_threshold=args.head_threshold,
                                   solve_iters=args.solve_iters,
                                   impl=args.kernel_impl or 'auto')
    tc = TrainerConfig(total_steps=args.steps, log_every=args.log_every,
                       ckpt_every=args.ckpt_every, profile=args.profile,
                       out_dir=f'{args.out_dir}/{cfg.name}-{args.opt}')
    trainer = Trainer(model, opt, capture, tc, taps_fn=taps_fn,
                      factor=factor, kernel=kernel, device=device)
    data = stream if args.no_prefetch else Prefetcher(stream)
    try:
        if world is not None:
            _, _, history = trainer.fit_elastic(params, data, world=world)
        else:
            _, _, history = trainer.fit(params, data)
    finally:
        if data is not stream:
            data.close()
    return history


def _elastic_rank(rank: int, world: int, args, kernel) -> list:
    """One spawned rank of ``--elastic``."""
    del rank
    return run(args, resolve_device(args.device), world=world, kernel=kernel)


def main(argv: Optional[list[str]] = None) -> list:
    """Parse ``argv`` (default: the command line) and train.  Returns the
    history: the losses of ``Trainer.fit``, or rank 0's (step, loss)
    pairs under ``--elastic``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.kernel_impl == 'cuda' and device.type != 'cuda':
        raise ValueError("--kernel-impl cuda runs the hand-written kernels "
                         "and needs --device cuda")
    arch_config(args)
    if args.distributed:
        if not args.elastic:
            raise SystemExit('--distributed runs the elastic loop over the '
                             'started group: add --elastic')
        device = workers.init_workers(device=device)
        try:
            # rank 0 tunes and writes the cache; every rank installs it
            kernel = kernel_config(args, device,
                                   tune=dist.get_rank() == 0)
            if args.autotune:
                dist.barrier()
            return run(args, device, world=args.world or dist.get_world_size(),
                       kernel=kernel)
        finally:
            workers.shutdown_workers()
    kernel = kernel_config(args, device)
    if args.elastic:
        world = args.world or (torch.cuda.device_count()
                               if device.type == 'cuda' else 1)
        results = workers.spawn(_elastic_rank, world, args=(args, kernel),
                                device=args.device, timeout=float('inf'))
        return results[0]
    return run(args, device, kernel=kernel)


if __name__ == '__main__':
    main()
