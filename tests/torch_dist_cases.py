"""Rank functions of the port's multi-worker CPU tests.

``repro_torch.launch.workers.spawn`` runs them in fresh processes over a
gloo group, so this module imports only torch, numpy and the port (a
spawned rank imports it by name).  Every function takes ``(rank, world,
...)`` and returns plain values or CPU tensors.  Inputs come from numpy
seeds, so the test process can hand the same values to the reference.
"""
import copy
import os
import signal

import numpy as np
import torch

from repro_torch.comm import exchange, metrics
from repro_torch.comm import group as group_mod
from repro_torch.core import kv as kvlib
from repro_torch.core.eva import eva_preconditioner
from repro_torch.core.eva_f import eva_f_preconditioner
from repro_torch.core.eva_s import eva_s_preconditioner
from repro_torch.core.factor_sharded import FactorShardConfig
from repro_torch.core.foof import foof_preconditioner
from repro_torch.core.kfac import kfac_preconditioner
from repro_torch.core.registry import make_optimizer
from repro_torch.core.shampoo import shampoo_preconditioner
from repro_torch.core.transform import Extras
from repro_torch.data import synthetic as syn
from repro_torch.models import module as M
from repro_torch.models import simple
from repro_torch.schedule import ownership
from repro_torch.schedule import pipeline as pipemod
from repro_torch.schedule.policy import every_k
from repro_torch.schedule.runtime import RefreshRuntime
from repro_torch.train.step import init_opt_state, make_dp_step

# the preconditioner toy of tests/test_comm_exchange.py and
# tests/test_pipeline.py: three stacked 8x4, a singleton, a scan stack
SHAPES = {'blk0/w': (8, 4), 'blk1/w': (8, 4), 'blk2/w': (8, 4),
          'head/w': (8, 3), 'stack/w': (2, 6, 4)}
GAMMA = 0.03


def toy_grads(seed):
    """{path: f32 array}, numpy-seeded."""
    rng = np.random.default_rng(seed)
    return {p: rng.standard_normal(s).astype(np.float32)
            for p, s in SHAPES.items()}


def _psd(rng, *shape):
    m = rng.standard_normal(shape)
    return (m @ np.swapaxes(m, -1, -2)
            + 0.1 * np.eye(shape[-1])).astype(np.float32)


def toy_stats(seed):
    """{path: dict of the four LayerStats fields as f32 arrays}."""
    rng = np.random.default_rng(1000 + seed)
    out = {}
    for p, s in SHAPES.items():
        lead, d_in, d_out = s[:-2], s[-2], s[-1]
        out[p] = dict(
            a_mean=rng.standard_normal(lead + (d_in,)).astype(np.float32),
            b_mean=rng.standard_normal(lead + (d_out,)).astype(np.float32),
            a_outer=_psd(rng, *lead, d_in, d_in),
            b_outer=_psd(rng, *lead, d_out, d_out))
    return out


def _t_grads(seed):
    return {k: torch.from_numpy(v) for k, v in toy_grads(seed).items()}


def _t_stats(seed):
    return {k: kvlib.LayerStats(**{f: torch.from_numpy(x)
                                   for f, x in v.items()})
            for k, v in toy_stats(seed).items()}


def _t_zero_stats():
    from repro_torch.core.transform import tree_map
    return tree_map(torch.zeros_like, _t_stats(0))


MAKERS = {
    'eva': lambda **kw: eva_preconditioner(GAMMA, 0.9, **kw),
    'eva_f': lambda **kw: eva_f_preconditioner(GAMMA, 0.9, **kw),
    'eva_s': lambda **kw: eva_s_preconditioner(GAMMA, 0.9, **kw),
    'foof': lambda **kw: foof_preconditioner(GAMMA, 0.9, **kw),
    'kfac': lambda **kw: kfac_preconditioner(GAMMA, 0.9, **kw),
    'shampoo': lambda **kw: shampoo_preconditioner(1e-4, **kw),
}
NEEDS_STATS = ('eva', 'eva_f', 'foof', 'kfac')


def run_toy(method, steps, *, sched=None, comm=None, stats_fn=None, **kw):
    """The preconditioner ``method`` on the toy stream under whatever data
    group is in scope: ([flat outputs], final state)."""
    stats_fn = stats_fn or _t_stats
    opt = MAKERS[method](**kw)
    needs = method in NEEDS_STATS
    params = _t_grads(0)
    state = opt.init(params, Extras(stats=stats_fn(0) if needs else None,
                                    sched=sched, comm=comm))
    outs = []
    for t in range(steps):
        ex = Extras(stats=stats_fn(t) if needs else None, sched=sched,
                    comm=comm)
        out, state = opt.update(_t_grads(t), state, extras=ex)
        outs.append({k: v.clone() for k, v in out.items()})
    return outs, pipemod.settle(state)


def shifted_stats(t):
    """[0, s_0, s_1, ...]: the stream a sync run must see to equal onestep."""
    return _t_zero_stats() if t == 0 else _t_stats(t - 1)


def _state_leaves(state):
    from repro_torch.core.transform import tree_leaves_with_path
    return {k: v.clone() for k, v in tree_leaves_with_path(state).items()
            if torch.is_tensor(v)}


# ---------------------------------------------------------------------------
# tests/test_torch_comm.py: the W = 4 exchange cases


def comm_cases(rank, world):
    res = {'world_and_rank_outside': ownership.world_and_rank()}
    scope = group_mod.scope_of(None)
    with group_mod.in_scope(scope):
        res['world_and_rank'] = ownership.world_and_rank()
        # every method: gather vs psum vs int8 gather, state included
        res['methods'] = {}
        for method in MAKERS:
            rt = RefreshRuntime(shard_refresh=True)
            runs = {}
            for tag, comm in (('psum', exchange.ExchangeConfig(
                                  exchange='psum')),
                              ('gather', exchange.ExchangeConfig()),
                              ('int8', exchange.ExchangeConfig(
                                  codec='int8'))):
                outs, state = run_toy(method, 3, sched=rt, comm=comm,
                                      policy=every_k(2))
                runs[tag] = (outs, _state_leaves(state))
            res['methods'][method] = runs
        # int8 mean all-reduce of replicated gradients (and its residual)
        g = _t_grads(7)
        err = {k: torch.zeros_like(v) for k, v in g.items()}
        mean, new_err, info = exchange.allreduce_mean_tree(
            g, err, codec='int8', site='grads/test')
        res['int8_mean'] = mean
        res['int8_err'] = new_err
        res['saturation'] = float(info['saturation'])
        # rank-dependent gradients: the exact integer path
        gr = {k: v * (1.0 + rank) for k, v in g.items()}
        res['int8_ranked'] = exchange.allreduce_mean_tree(
            gr, codec='int8')[0]
        res['int8_ranked_in'] = gr
        # raw owned-slice gather: identity and bf16-of-bf16 are exact
        rng = np.random.default_rng(5)
        stack = torch.from_numpy(
            rng.standard_normal((6, 4, 4)).astype(np.float32))
        from repro_torch.core import bucketing
        plan = bucketing.build_plan({f'l{i}/w': stack[i] for i in range(6)})
        key = plan.buckets[0].key
        owners = ownership.assign_slice_owners(
            plan, ownership.inverse_cost('both'), world)
        w, r = ownership.world_and_rank()
        res['gather'] = {}
        for codec, x in (('identity', stack),
                         ('bf16', stack.to(torch.bfloat16).float()),
                         ('int8', stack)):
            res['gather'][codec] = (x, exchange.allgather_owned_slices(
                plan, owners, w, r, {key: x}, codec=codec)[key])
        # band partials: the sum over the group completes the product
        part = torch.full((3, 5), float(rank + 1))
        res['partials'] = exchange.psum_partials(part.clone(), w)
    # pod topology over (2, 2): collective for every rank
    pods = group_mod.pod_scope((2, 2))
    with group_mod.in_scope(pods):
        rt = RefreshRuntime(shard_refresh=True)
        res['pod'] = {}
        for tag, comm in (('psum', exchange.ExchangeConfig(exchange='psum')),
                          ('pod', exchange.ExchangeConfig(
                              topology='pod'))):
            outs, state = run_toy('kfac', 3, sched=rt, comm=comm,
                                  policy=every_k(2))
            res['pod'][tag] = (outs, _state_leaves(state))
    res['sites'] = metrics.snapshot()
    return res


# ---------------------------------------------------------------------------
# tests/test_torch_dp.py: W = 4 training against the whole-batch step

# tests/test_torch_kfac_shampoo.py's MLP case: threshold 32 trips fc0's out
# side, both sides of fc1 and fc2's in side
MLP_DIMS = [16, 32, 32, 4]
MLP_STREAM = dict(batch=64, dim=16, classes=4, spread=1.5, seed=0)
MLP_LR = 0.03
DP_RUNS = {
    'eva': dict(fused=False),
    'eva_f': dict(fused=True),
    'kfac': dict(shard='cg'),
    'shampoo': dict(shard='binomial'),
    'foof': dict(),
}


def mlp_model():
    model = simple.MLP(MLP_DIMS)
    model.loss_fn = simple.classifier_loss_fn(model)
    return model


def dp_optimizer(name):
    kw = dict(DP_RUNS[name])
    shard = kw.pop('shard', None)
    opt, cap = make_optimizer(name, lr=MLP_LR, **kw)
    factor = (FactorShardConfig(head_policy='shard', shard_threshold=32,
                                solver=shard, solve_iters=32)
              if shard else None)
    return opt, cap, factor


def dp_cases(rank, world, params_np, steps):
    """Each DP_RUNS optimizer ``steps`` steps through ``make_dp_step`` over
    the default group: {name: (losses, params, metric keys)}."""
    data = syn.ClassStream(**MLP_STREAM, device='cpu')
    model = mlp_model()
    out = {}
    for name in DP_RUNS:
        params = M.params_from_numpy(params_np, 'cpu')
        opt, cap, factor = dp_optimizer(name)
        state = init_opt_state(model, opt, cap, params, data.batch_at(0),
                               factor=factor, device='cpu')
        step = make_dp_step(model, opt, cap, None, factor=factor,
                            device='cpu')
        losses = []
        for t in range(steps):
            params, state, met = step(params, state, data.batch_at(t))
            losses.append(float(met['loss']))
        out[name] = (losses, params, sorted(met))
    # the int8-compressed DP step
    from repro_torch.train.compression import make_dp_train_step
    params = M.params_from_numpy(params_np, 'cpu')
    opt, cap = make_optimizer('eva', lr=MLP_LR)
    state = init_opt_state(model, opt, cap, params, data.batch_at(0),
                           device='cpu')
    step, init_err = make_dp_train_step(model, opt, cap, None, device='cpu')
    err = init_err(params)
    losses, sats = [], []
    for t in range(steps):
        params, state, err, met = step(params, state, err, data.batch_at(t))
        losses.append(float(met['loss']))
        sats.append(float(met['comm_saturation']))
    out['int8'] = (losses, params, sats)
    out['sites'] = metrics.snapshot()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_pipeline.py: onestep over four workers


def pipeline_cases(rank, world, steps):
    out = {}
    with group_mod.in_scope(None):
        for method in ('eva', 'eva_f', 'kfac', 'foof', 'shampoo'):
            rt = RefreshRuntime(pipeline='onestep', shard_refresh=True)
            opt = MAKERS[method](policy=every_k(2))
            needs = method in NEEDS_STATS
            state = opt.init(_t_grads(0), Extras(
                stats=_t_stats(0) if needs else None, sched=rt))
            outs, pending = [], []
            for t in range(steps):
                ex = Extras(stats=_t_stats(t) if needs else None, sched=rt)
                o, state = opt.update(_t_grads(t), state, extras=ex)
                # this step's statistics mean is still in flight
                pending.append(sum(
                    isinstance(p.inflight, pipemod.Pending)
                    for _, p in pipemod.pipe_entries(state)))
                outs.append({k: v.clone() for k, v in o.items()})
            # an unsettled state does not copy; a settled one does
            try:
                copy.deepcopy(state)
                copies = [True]
            except TypeError:
                copies = [False]
            state = pipemod.settle(state)
            copies.append(copy.deepcopy(state) is not None)
            lag = {k: int(v) for k, v in
                   pipemod.pipeline_metrics(state).items()}
            out[method] = (outs, _state_leaves(state), lag, pending, copies)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_elastic.py: the chaos and live-resize scenarios of
# tests/test_elastic.py (MLP [8, 16, 3], ClassStream(batch=32))


class ChaosStream:
    """Delivers SIGTERM to this rank when the trainer asks for the kill
    step's batch: that step still runs, then the trainer's own handler
    checkpoints synchronously and returns."""

    def __init__(self, inner, kill_at):
        self.inner, self.kill_at = inner, kill_at

    def batch_at(self, step):
        if step == self.kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.inner.batch_at(step)


def elastic_trainer(name, params_np, out_dir, steps, pipeline='sync',
                    ckpt_every=10 ** 6, log_every=1, comm=None):
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = simple.MLP([8, 16, 3])
    model.loss_fn = simple.classifier_loss_fn(model)
    opt, cap = make_optimizer(name, lr=0.05)
    cfg = TrainerConfig(total_steps=steps, log_every=log_every,
                        ckpt_every=ckpt_every, out_dir=str(out_dir))
    tr = Trainer(model, opt, cap, cfg, sched=RefreshRuntime(
        pipeline=pipeline), comm=comm, device='cpu')
    return tr, M.params_from_numpy(params_np, 'cpu')


def _class_stream(kill_at=None):
    return ChaosStream(syn.ClassStream(batch=32, dim=8, classes=3, seed=0,
                                       device='cpu'), kill_at)


def elastic_cases(rank, world, params_np, root):
    """Per optimizer: the uninterrupted W = 4 run, the chaos run (W = 4
    killed at 8, W = 2 killed at 16, W = 4 to the end) and the live resize
    4 -> 2 -> 4; then the live resize under 'onestep'."""
    out = {}
    steps = 24
    for name in ('eva', 'kfac'):
        tr, p = elastic_trainer(name, params_np, f'{root}/{name}/base',
                                steps)
        base = tr.fit_elastic(p, _class_stream(), world=4)[2]
        chaos = []
        for w, kill in ((4, 8), (2, 16), (4, None)):
            tr, p = elastic_trainer(name, params_np, f'{root}/{name}/chaos',
                                    steps)
            chaos.append(tr.fit_elastic(p, _class_stream(kill), world=w)[2])
        tr, p = elastic_trainer(name, params_np, f'{root}/{name}/live', 16,
                                log_every=4,
                                comm=exchange.ExchangeConfig())
        live = tr.fit_elastic(p, _class_stream(), world=4,
                              world_fn=lambda s: 2 if 6 <= s < 11 else 4)[2]
        out[name] = {'base': base, 'chaos': chaos, 'live': live}
    runs = {}
    for tag, fn in (('base', None),
                    ('resized', lambda s: 2 if 6 <= s < 11 else 4)):
        tr, p = elastic_trainer('kfac', params_np,
                                f'{root}/onestep/{tag}', 16,
                                pipeline='onestep', log_every=4)
        runs[tag] = tr.fit_elastic(p, _class_stream(), world=4,
                                   world_fn=fn)[2]
    out['onestep'] = runs
    return out


def layout_loss(arch, params_np, batch_np, mesh_shape=(2, 2)):
    """The reduced ``arch``'s loss on ``batch_np`` from ``params_np``, in
    one process under an abstract ('data', 'model') mesh of
    ``mesh_shape`` (MoE routes in data-axis groups; every layout call is
    the identity)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.sharding import compat
    model = build_model(get_reduced(arch))
    params = {k: torch.from_numpy(v) for k, v in params_np.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with compat.set_mesh(compat.AbstractMesh(mesh_shape, ('data', 'model'))):
        loss, _ = model.loss_fn(params, None, batch, None)
    return float(loss)


def layout_cases(rank, world, arch, params_np, batch_np):
    """The same loss with DTensor parameters and batch laid out by the
    production rules on a (2, 2) ('data', 'model') DeviceMesh of the four
    gloo ranks; returns (loss, the ops that ran replicated)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.sharding import compat, input_shardings, param_shardings
    model = build_model(get_reduced(arch))
    mesh = compat.make_mesh((2, 2), ('data', 'model'), 'cpu')
    assert compat.is_device_mesh(mesh)
    specs = M.flatten_specs(param_shardings(model.param_specs(), mesh))
    params = {k: compat.distribute(torch.from_numpy(v), specs[k], mesh)
              for k, v in params_np.items()}
    bspec = input_shardings(batch_np and {k: torch.from_numpy(v)
                                          for k, v in batch_np.items()}, mesh)
    batch = {k: compat.distribute(torch.from_numpy(v), bspec[k], mesh)
             for k, v in batch_np.items()}
    log = []
    with compat.set_mesh(mesh, log):
        loss, _ = model.loss_fn(params, None, batch, None)
        loss = loss.full_tensor() if hasattr(loss, 'full_tensor') else loss
    return float(loss), sorted(set(log))
