"""Where the one-worker DP step's extra time goes.

``train/step.py::make_dp_step`` at W = 1 gives ``make_train_step``'s
result bit for bit, and costs more: it takes the local rows, mean-reduces
the loss, the gradients (site ``grads/dp``) and the statistics
(``stats/dp``), and runs the optimizer with the group in scope, where the
optimizer's own statistics mean (``stats/eva``, ``stats/kfac``, ...) is a
collective too.  This script times each of those pieces alone on the
full-width autoencoder (784-1000-500-250-30-250-500-1000-784, batch 1000)
under a one-rank group, NCCL on the card (gloo on the CPU), beside the two
whole steps: the median of ``--reps`` synchronized calls after two warm-up
calls, in ms.  It prints one JSON line.

    PYTHONPATH=src python scripts/dp_overhead.py                 # the card
    PYTHONPATH=src python scripts/dp_overhead.py --device cpu    # rehearsal
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / 'src'))

import torch  # noqa: E402

# optimizer spec per tag: (name, lr, make_optimizer keywords, sharded sides)
PATHS = {
    'eva fused': ('eva', 0.15, {'fused': True}, None),
    'kfac shard': ('kfac', 0.15, {'fused': False},
                   dict(head_policy='shard', shard_threshold=1000,
                        solve_iters=32, solver='cg')),
}


def _timed(device, fn, reps):
    out, times = None, []
    for i in range(reps + 2):
        if device.type == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device.type == 'cuda':
            torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def measure(tag: str, device, reps: int) -> dict:
    from repro_torch.comm import exchange
    from repro_torch.comm import group as group_mod
    from repro_torch.core.factor_sharded import FactorShardConfig
    from repro_torch.core.registry import make_optimizer
    from repro_torch.core.transform import Extras
    from repro_torch.data.synthetic import AEStream
    from repro_torch.models import module as M
    from repro_torch.models.simple import ae_loss_fn, autoencoder
    from repro_torch.train.step import (_local_rows, _plan_for_stats,
                                        compute_grads_and_stats,
                                        init_opt_state, make_dp_step,
                                        make_train_step)
    name, lr, kw, shard = PATHS[tag]
    model = autoencoder()
    model.loss_fn = ae_loss_fn(model)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device=device)
    batch = AEStream(batch=1000, device=device).batch_at(0)
    opt, cap = make_optimizer(name, lr=lr, **kw)
    factor = FactorShardConfig(**shard) if shard else None
    state = init_opt_state(model, opt, cap, params, batch, factor=factor,
                           device=device)
    train = make_train_step(model, opt, cap, factor=factor, device=device)
    dp = make_dp_step(model, opt, cap, None, factor=factor, device=device)
    scope = group_mod.scope_of(None)
    ms = {}
    _, ms['make_train_step'] = _timed(
        device, lambda: train(params, state, batch), reps)
    _, ms['make_dp_step'] = _timed(
        device, lambda: dp(params, state, batch), reps)
    (loss, grads, stats), ms['forward_backward'] = _timed(
        device, lambda: compute_grads_and_stats(model, params, batch, cap),
        reps)
    with group_mod.in_scope(scope):
        _, ms['local_rows'] = _timed(
            device, lambda: _local_rows(batch, scope.world, scope.rank), reps)
        _, ms['loss_allreduce'] = _timed(
            device, lambda: exchange.allreduce_mean_tree(loss, codec='f32'),
            reps)
        _, ms['grads_dp_allreduce'] = _timed(
            device, lambda: exchange.allreduce_mean_tree(
                grads, codec='f32', site='grads/dp'), reps)
        _, ms['stats_dp_allreduce'] = _timed(
            device, lambda: exchange.allreduce_mean_tree(
                stats, codec='f32', site='stats/dp'), reps)
    extras = Extras(stats=stats, loss=loss, plan=_plan_for_stats(grads, stats),
                    factor=factor)
    _, ms['update_outside_scope'] = _timed(
        device, lambda: opt.update(grads, state, params=params,
                                   extras=extras), reps)
    with group_mod.in_scope(scope):
        _, ms['update_in_scope'] = _timed(
            device, lambda: opt.update(grads, state, params=params,
                                       extras=extras), reps)
    ms['dp_minus_train'] = ms['make_dp_step'] - ms['make_train_step']
    ms['exchanges'] = (ms['loss_allreduce'] + ms['grads_dp_allreduce']
                       + ms['stats_dp_allreduce'])
    ms['update_scope_cost'] = (ms['update_in_scope']
                               - ms['update_outside_scope'])
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda', choices=('cpu', 'cuda'))
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--tags', nargs='*', default=list(PATHS))
    ap.add_argument('--out', default=None, help='also write the JSON here')
    args = ap.parse_args(argv)
    from repro_torch.launch import workers
    store = tempfile.mkdtemp(prefix='dp_overhead_')
    device = workers.init_workers(device=args.device, rank=0, world=1,
                                  init_method=f'file://{store}/store')
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {'device': args.device,
               'backend': torch.distributed.get_backend(),
               'card': (torch.cuda.get_device_name(0)
                        if device.type == 'cuda' else None),
               'ms': {tag: measure(tag, device, args.reps)
                      for tag in args.tags}}
    finally:
        workers.shutdown_workers()
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
