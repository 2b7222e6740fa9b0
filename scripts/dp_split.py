"""How far splitting the batch over W workers moves one optimizer step.

For each path of ``chip_smoke.py``'s phase 10b (the autoencoder
784-1000-500-250-30-250-500-1000-784 at batch 1000 with Eva composed and
fused, Eva-f fused, K-FAC and Shampoo with their 1000-wide factor sides
sharded, FOOF; the MLP 784-1000-1000-1000-1000-10 at batch 512 with K-FAC
sharded), W = 4 workers take ``make_dp_step`` steps over gloo, and rank 0
takes, from the same state at every step:

* ``whole``: ``make_train_step`` on the whole batch;
* ``twin``: the W shard means on one process (``chip_smoke._p10_twin``);
* ``ulp_stats``: the whole-batch step with its statistics multiplied by
  ``1 + 2**-24 * z`` (z standard normal, seeded);
* ``ulp_x``: the whole-batch step on the batch's inputs multiplied by
  ``1 + 2**-24 * z``: how far one f32 rounding of the data moves the step.

It prints, a step each, ``dp`` (the W-worker step against ``whole``),
``twin``, ``ulp_stats`` and ``ulp_x`` (each against ``whole``), each
``‖Δa − Δb‖ / ‖Δb‖`` over the whole update (Δ = the step's change of the
parameters), and the largest of each over the run as one JSON line.

``--f64`` runs the port in double precision: ``torch.float32`` is aliased
to ``torch.float64`` in every process before the port is imported, so each
of its f32 casts keeps f64.  CPU only (the kernels take f32).  If the
workers' statistics combine as the whole batch's, ``dp`` and ``twin`` then
fall to the f64 rounding level; a statistic that does not split linearly
(a per-shard centring, a per-shard normalisation) stays at its own size.

``--dump DIR`` keeps, for every step, rank 0's state before it and the
three f32 results (``whole``, ``twin``, ``dp``); ``--truth DIR --f64`` then
retakes each of those steps in f64 on the CPU from the same state and
batch, and prints how far each f32 result lies from it (``e_whole``,
``e_twin``, ``e_dp``): whether the W-worker step is further from the exact
step than the whole-batch step is.

    PYTHONPATH=src python scripts/dp_split.py --device cpu --f64
    PYTHONPATH=src python scripts/dp_split.py --device cuda --dump build/split
    PYTHONPATH=src python scripts/dp_split.py --f64 --truth build/split
    PYTHONPATH=src python scripts/dp_split.py --device cpu --f64 --small \\
        --max-rel 1e-9                 # exits 1 if dp or twin exceed it

``--small`` cuts the widths (a 64-48-24-48-64 autoencoder at batch 64, an
MLP 64-48-48-48-10 at batch 64, factor sides over 32 sharded) for a quick
check.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / 'src')):
    if p not in sys.path:
        sys.path.insert(0, p)

os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
import torch  # noqa: E402

F64 = '--f64' in sys.argv
if F64:      # before the port is imported: its module-level F32 = f64
    torch.float32 = torch.float64
    torch.set_default_dtype(torch.float64)

import chip_smoke as cs  # noqa: E402

WORLD = cs.P10_WORLD
SMALL_SHARD = dict(cs.SHARD, shard_threshold=32)


def _paths(small: bool) -> dict:
    """tag -> (model name, optimizer spec of chip_smoke.P10_PATHS form)."""
    out = {tag: ('ae', spec) for tag, spec in cs.P10_PATHS.items()}
    out['mlp kfac shard'] = ('mlp', cs.P10_MLP)
    if small:
        out = {tag: (m, spec[:3] + ((SMALL_SHARD if spec[3] else None),)
                     + spec[4:]) for tag, (m, spec) in out.items()}
    return out


def _setup(which: str, small: bool, device: str, steps: int):
    from repro_torch.data.synthetic import AEStream, ClassStream
    from repro_torch.models import module as M
    from repro_torch.models.simple import (MLP, ae_loss_fn, autoencoder,
                                           classifier_loss_fn)
    if which == 'ae':
        model = (autoencoder(hidden=(48, 24, 48), d_in=64) if small
                 else autoencoder())
        model.loss_fn = ae_loss_fn(model)
        data = (AEStream(batch=64, side=8, device=device) if small
                else AEStream(batch=1000, device=device))
        seed = 0
    else:
        model = MLP([64, 48, 48, 48, 10] if small
                    else [784, 1000, 1000, 1000, 1000, 10])
        model.loss_fn = classifier_loss_fn(model)
        data = ClassStream(batch=64 if small else 512,
                           dim=64 if small else 784, classes=10,
                           device=device)
        seed = 1
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(seed), device=device)
    batches = [data.batch_at(i) for i in range(steps)]
    if F64:
        params = {k: v.double() for k, v in params.items()}
        batches = [{k: v.double() if v.is_floating_point() else v
                    for k, v in b.items()} for b in batches]
    return model, params, batches


def _noisy(tree, gen):
    """Each floating tensor of ``tree`` times (1 + 2**-24 z)."""
    from repro_torch.core.transform import tree_map
    return tree_map(lambda s: s * (1 + 2.0 ** -24 * torch.randn(
        s.shape, generator=gen, dtype=s.dtype).to(s.device))
        if s.is_floating_point() else s, tree)


def _ulp_step(model, opt, cap, factor, params, state, batch, gen, where):
    """The whole-batch step with one f32 rounding's noise on the
    statistics (``where='stats'``) or on the batch (``'x'``)."""
    from repro_torch.core.transform import Extras, apply_updates
    from repro_torch.train.step import (_plan_for_stats,
                                        compute_grads_and_stats)
    if where == 'x':
        batch = _noisy(batch, gen)
    loss, grads, stats = compute_grads_and_stats(model, params, batch, cap)
    if where == 'stats' and stats is not None:
        stats = _noisy(stats, gen)
    upd, _ = opt.update(grads, state, params=params, extras=Extras(
        stats=stats, loss=loss, plan=_plan_for_stats(grads, stats),
        factor=factor))
    return apply_updates(params, upd)


def _cpu(tree):
    from repro_torch.core.transform import tree_map
    return tree_map(lambda x: x.detach().cpu() if torch.is_tensor(x) else x,
                    tree)


def _rank(rank, world, device, small, steps, tags, plain, dump):
    if device == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
    from repro_torch.train.step import (init_opt_state, make_dp_step,
                                        make_train_step)
    out = {}
    for tag, (which, spec) in _paths(small).items():
        if tags and tag not in tags:
            continue
        n = cs.P10_MLP_STEPS if which == 'mlp' else steps
        model, params, batches = _setup(which, small, device, n)
        opt, cap, factor = _opt(spec, plain)
        state = init_opt_state(model, opt, cap, params, batches[0],
                               factor=factor, device=device)
        step = make_dp_step(model, opt, cap, None, factor=factor,
                            device=device)
        whole_step = make_train_step(model, opt, cap, factor=factor,
                                     device=device)
        gen = torch.Generator().manual_seed(5)
        rows = []
        for i, batch in enumerate(batches):
            if rank == 0:
                whole = whole_step(params, state, batch)[0]
                twin = cs._p10_twin(torch, model, opt, cap, factor, params,
                                    state, batch, world)
                ulp = {w: _ulp_step(model, opt, cap, factor, params, state,
                                    batch, gen, w) for w in ('stats', 'x')}
                before = _cpu((params, state))
            new, state, _ = step(params, state, batch)
            if rank == 0:
                rows.append({
                    'dp': cs._p10_dist(torch, params, whole, new)[0],
                    'twin': cs._p10_dist(torch, params, whole, twin)[0],
                    **{f'ulp_{w}': cs._p10_dist(torch, params, whole, u)[0]
                       for w, u in ulp.items()}})
                if dump:
                    d = Path(dump) / tag.replace(' ', '_')
                    d.mkdir(parents=True, exist_ok=True)
                    torch.save({'params': before[0], 'state': before[1],
                                'batch': _cpu(batch), 'whole': _cpu(whole),
                                'twin': _cpu(twin), 'dp': _cpu(new)},
                               d / f'{i}.pt')
            params = new
        out[tag] = rows
    return out


def _opt(spec, plain):
    opt, cap, factor = cs._p10_opt(torch, spec)
    if plain and factor is not None:
        factor = dataclasses.replace(factor, impl='torch')
    return opt, cap, factor


def _up(tree):
    """An f32 tree in f64, its bucket keys ('float32_16x32') renamed as
    the f64 plan names them."""
    if torch.is_tensor(tree):
        return tree.double() if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {(k.replace('float32_', 'float64_', 1) if isinstance(k, str)
                 else k): _up(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_up(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, '_fields') else tuple(vals)
    if isinstance(tree, list):
        return [_up(v) for v in tree]
    return tree


def _truth(dump: str, small: bool, tags) -> dict:
    """Each dumped step retaken in f64 on the CPU: {tag: [{e_whole, e_twin,
    e_dp}, ...]}."""
    from repro_torch.train.step import make_train_step
    out = {}
    for tag, (which, spec) in _paths(small).items():
        d = Path(dump) / tag.replace(' ', '_')
        if (tags and tag not in tags) or not d.is_dir():
            continue
        model = _setup(which, small, 'cpu', 0)[0]
        opt, cap, factor = _opt(spec, False)
        step = make_train_step(model, opt, cap, factor=factor, device='cpu')
        rows = []
        for i in range(len(list(d.glob('*.pt')))):
            rec = torch.load(d / f'{i}.pt', weights_only=False)
            params = _up(rec['params'])
            exact = step(params, _up(rec['state']), _up(rec['batch']))[0]
            rows.append({f'e_{k}': cs._p10_dist(torch, params, exact,
                                                _up(rec[k]))[0]
                         for k in ('whole', 'twin', 'dp')})
        out[tag] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--device', default='cuda', choices=('cpu', 'cuda'))
    ap.add_argument('--f64', action='store_true')
    ap.add_argument('--small', action='store_true')
    ap.add_argument('--steps', type=int, default=cs.P10_STEPS,
                    help='autoencoder steps (the MLP takes P10_MLP_STEPS)')
    ap.add_argument('--tags', nargs='*', default=[])
    ap.add_argument('--plain', action='store_true',
                    help="the sharded factors' band products in plain torch "
                         "(FactorShardConfig.impl='torch'), not matvec_cols")
    ap.add_argument('--threads', type=int, default=2)
    ap.add_argument('--max-rel', type=float, default=None)
    ap.add_argument('--out', default=None, help='also write the JSON here')
    ap.add_argument('--dump', default=None)
    ap.add_argument('--truth', default=None)
    args = ap.parse_args(argv)
    if args.f64 and args.device != 'cpu':
        ap.error('--f64 runs on the CPU only')
    if args.truth and not args.f64:
        ap.error('--truth needs --f64')
    head = {'device': args.device, 'dtype': 'f64' if args.f64 else 'f32',
            'small': args.small, 'plain': args.plain, 'world': WORLD}
    if args.truth:
        torch.set_num_threads(args.threads)
        res = _truth(args.truth, args.small, args.tags)
        keys = ('e_whole', 'e_twin', 'e_dp')
    else:
        res = _split(args)
        keys = ('dp', 'twin', 'ulp_stats', 'ulp_x')
    summary = {}
    for tag, rows in res.items():
        for i, r in enumerate(rows):
            print(f'{tag} step {i}: ' + ' '.join(f'{k} {r[k]:.3e}'
                                                 for k in keys), flush=True)
        summary[tag] = {k: max(r[k] for r in rows) for k in keys}
    if args.device == 'cuda':
        head['card'] = torch.cuda.get_device_name(0)
    line = json.dumps({**head, 'truth': bool(args.truth), 'max': summary})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    if args.max_rel is not None and not args.truth:
        worst = max(max(s['dp'], s['twin']) for s in summary.values())
        if not worst <= args.max_rel:
            print(f'dp_split: {worst:.3e} > {args.max_rel}', file=sys.stderr)
            return 1
    return 0


def _split(args) -> dict:
    from repro_torch.launch import workers
    if args.device == 'cuda':
        from repro_torch.kernels import build
        build.build_all()         # once, before the ranks load them
    return workers.spawn(_rank, WORLD, args=(args.device, args.small,
                                            args.steps, tuple(args.tags),
                                            args.plain, args.dump),
                        backend='gloo', device=args.device, timeout=1200,
                        threads=args.threads)[0]


if __name__ == '__main__':
    sys.exit(main())
