"""The port's explicit data-parallel steps (``train/step.py::make_dp_step``
and ``train/compression.py::make_dp_train_step``) over ``torch.distributed``.

* W = 1: ``make_dp_step`` over a one-rank gloo group equals
  ``make_train_step`` bit for bit (losses, parameters, every state leaf)
  for Eva composed and fused, Eva-f fused, K-FAC and Shampoo with their
  32-wide factor sides sharded, FOOF, and K-FAC under 'onestep': every
  exchange sums one value and divides by 1.
* W = 4 (four gloo workers, 16 of the 64 samples each): 10 steps of Eva,
  Eva-f (fused), K-FAC (sharded, CG), Shampoo (sharded, binomial series)
  and FOOF on tests/test_torch_kfac_shampoo.py's MLP, against the
  reference's ``make_train_step`` on the whole batch from the same weights:
  losses rtol 1e-4 (atol 1e-6), parameters rtol 1e-4 (atol 1e-5), as that
  file holds one process.  Each rank's band of the sharded factors goes
  through ``psum_partials`` (its ``factor/*`` sites are 'psum-partial');
  the ranks end with the same parameters bit for bit.
* In f64 (``scripts/dp_split.py --f64 --small``: the port's f32 aliased to
  f64 in fresh processes) the four workers' step equals the whole-batch
  step within 1e-9 of its norm on every path of the card's phase 10b, at
  small widths: the shards' statistics combine as the whole batch's, so
  what separates the two in f32 is rounding.
* The int8-compressed DP step reports ``comm_saturation`` 0 and learns at
  W = 4; at W = 1 it tracks the reference's (one-device mesh) within rtol
  1e-4.
* ``Trainer(comm=...)`` runs and its ``comm_exchange`` record names the
  reference's sites, modes and bytes.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro.comm import exchange as jex  # noqa: E402
from repro.core import factor_sharded as jfsh  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.obs.events import validate_record as ref_validate  # noqa: E402
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.comm import exchange  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.core.transform import tree_leaves_with_path  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import workers  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.schedule import pipeline as pipemod  # noqa: E402
from repro_torch.schedule.runtime import RefreshRuntime  # noqa: E402
from repro_torch.train.step import (init_opt_state, make_dp_step,  # noqa
                                    make_train_step)

RTOL, ATOL = 1e-4, 1e-5
STEPS = 10


def _params_np():
    jm = jsimple.MLP(cases.MLP_DIMS)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in jkv.flatten_params(jp).items()}


@pytest.fixture(scope='module')
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp('store') / 'store'
    workers.init_workers(device='cpu', rank=0, world=1,
                         init_method=f'file://{store}')
    yield
    workers.shutdown_workers()


@pytest.fixture(scope='module')
def w4():
    return workers.spawn(cases.dp_cases, 4, args=(_params_np(), STEPS),
                         device='cpu', timeout=300, threads=1)


def _ref_run(name, steps):
    """The reference's one-process run of a DP_RUNS optimizer."""
    jm = jsimple.MLP(cases.MLP_DIMS)
    jm.loss_fn = jsimple.classifier_loss_fn(jm)
    jp = jkv.unflatten_params({k: jax.numpy.asarray(v)
                               for k, v in _params_np().items()})
    kw = dict(cases.DP_RUNS[name])
    shard = kw.pop('shard', None)
    opt, cap = jmake(name, lr=cases.MLP_LR, **kw)
    factor = (jfsh.FactorShardConfig(head_policy='shard', shard_threshold=32,
                                     solver=shard, solve_iters=32)
              if shard else None)
    data = jsyn.ClassStream(**cases.MLP_STREAM)
    b = cases.MLP_STREAM['batch']
    taps_fn = (lambda p: jm.make_taps(b, cap)) if cap.needs_taps else None
    st = jinit(jm, opt, cap, jp, data.batch_at(0), taps_fn=taps_fn,
               factor=factor)
    step = jax.jit(jstep_fn(jm, opt, cap, taps_fn=taps_fn, factor=factor))
    losses = []
    for t in range(steps):
        jp, st, met = step(jp, st, data.batch_at(t))
        losses.append(float(met['loss']))
    return np.array(losses), jkv.flatten_params(jp)


W1_CASES = {
    'eva': ('eva', {}, None),
    'eva fused': ('eva', {'fused': True}, None),
    'eva_f fused': ('eva_f', {'fused': True}, None),
    'kfac shard': ('kfac', {}, 'cg'),
    'shampoo shard': ('shampoo', {}, 'binomial'),
    'foof': ('foof', {}, None),
    'kfac onestep': ('kfac', {}, 'onestep'),
}


@pytest.mark.parametrize('case', sorted(W1_CASES))
def test_dp_step_w1_equals_train_step(one_rank, case):
    from repro_torch.core.factor_sharded import FactorShardConfig
    name, kw, extra = W1_CASES[case]
    model = cases.mlp_model()
    data = tsyn.ClassStream(**cases.MLP_STREAM, device='cpu')
    sched = RefreshRuntime(pipeline='onestep') if extra == 'onestep' \
        else None
    factor = (FactorShardConfig(head_policy='shard', shard_threshold=32,
                                solver=extra, solve_iters=32)
              if extra in ('cg', 'binomial') else None)
    runs = []
    for dp in (False, True):
        params = M.params_from_numpy(_params_np(), 'cpu')
        opt, cap = make_optimizer(name, lr=cases.MLP_LR, **kw)
        state = init_opt_state(model, opt, cap, params, data.batch_at(0),
                               sched=sched, factor=factor, device='cpu')
        step = (make_dp_step(model, opt, cap, None, sched=sched,
                             factor=factor, device='cpu') if dp else
                make_train_step(model, opt, cap, sched=sched, factor=factor,
                                device='cpu'))
        losses = []
        for t in range(5):
            params, state, met = step(params, state, data.batch_at(t))
            losses.append(float(met['loss']))
        state = pipemod.settle(state)  # 'onestep': the last mean in flight
        runs.append((losses, params, tree_leaves_with_path(state),
                     sorted(met)))
    (l0, p0, s0, m0), (l1, p1, s1, m1) = runs
    assert l0 == l1
    assert m0 == m1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert list(s0) == list(s1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


@pytest.mark.multihost
@pytest.mark.parametrize('name', sorted(cases.DP_RUNS))
def test_w4_matches_reference_whole_batch(w4, name):
    losses, params, keys = w4[0][name]
    jl, jp = _ref_run(name, STEPS)
    np.testing.assert_allclose(losses, jl, rtol=RTOL, atol=1e-6)
    for k in jp:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for res in w4[1:]:
        assert res[name][0] == losses
        for k in params:
            assert torch.equal(res[name][1][k], params[k]), k
    assert {'loss', 'grad_norm'} <= set(keys)


@pytest.mark.multihost
def test_w4_step_is_the_whole_batch_step_in_f64():
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run(
        [sys.executable, str(root / 'scripts' / 'dp_split.py'), '--device',
         'cpu', '--f64', '--small', '--steps', '2', '--threads', '1',
         '--max-rel', '1e-9'], capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got['dtype'] == 'f64'
    assert len(got['max']) == 7          # every path of phase 10b


@pytest.mark.multihost
def test_w4_sites(w4):
    """The DP sites carry the reference's bytes for the same trees; the
    sharded solves exchanged their band partials."""
    sites = w4[0]['sites']
    shapes = {k: v.shape for k, v in _params_np().items()}
    grads = {k: jax.ShapeDtypeStruct(s, np.float32)
             for k, s in shapes.items()}
    assert sites['grads/dp']['bytes_per_call'] == jex.tree_payload_bytes(
        grads, jex.get_codec('int8'))   # the last DP run was the int8 one
    assert sites['grads/dp']['codec'] == 'int8'
    assert sites['factor/kfac']['mode'] == 'psum-partial'
    assert sites['factor/shampoo']['mode'] == 'psum-partial'
    assert sites['stats/dp']['mode'] == 'allreduce'
    assert sites['stats/kfac']['mode'] == 'psum'


@pytest.mark.multihost
def test_w4_int8_compressed_step(w4):
    losses, params, sats = w4[0]['int8']
    assert sats == [0.0] * STEPS
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    for res in w4[1:]:
        for k in params:
            assert torch.equal(res['int8'][1][k], params[k])


def test_int8_compressed_step_w1_tracks_reference(one_rank):
    from repro.sharding import compat
    from repro.train.compression import make_dp_train_step as jmake_dp
    from repro_torch.train.compression import make_dp_train_step
    model = cases.mlp_model()
    data = tsyn.ClassStream(**cases.MLP_STREAM, device='cpu')
    params = M.params_from_numpy(_params_np(), 'cpu')
    opt, cap = make_optimizer('eva', lr=cases.MLP_LR)
    state = init_opt_state(model, opt, cap, params, data.batch_at(0),
                           device='cpu')
    step, init_err = make_dp_train_step(model, opt, cap, None, device='cpu')
    err = init_err(params)
    jm = jsimple.MLP(cases.MLP_DIMS)
    jm.loss_fn = jsimple.classifier_loss_fn(jm)
    jp = jkv.unflatten_params({k: jax.numpy.asarray(v)
                               for k, v in _params_np().items()})
    jopt, jcap = jmake('eva', lr=cases.MLP_LR)
    jdata = jsyn.ClassStream(**cases.MLP_STREAM)
    b = cases.MLP_STREAM['batch']
    taps_fn = lambda p: jm.make_taps(b, jcap)   # noqa: E731 (W = 1)
    jst = jinit(jm, jopt, jcap, jp, jdata.batch_at(0), taps_fn=taps_fn)
    jstep, jinit_err = jmake_dp(jm, jopt, jcap,
                                compat.make_mesh((1,), ('data',)),
                                taps_fn=taps_fn)
    jerr = jinit_err(jp)
    for t in range(4):
        params, state, err, met = step(params, state, err, data.batch_at(t))
        jp, jst, jerr, jmet = jstep(jp, jst, jerr, jdata.batch_at(t))
        np.testing.assert_allclose(float(met['loss']), float(jmet['loss']),
                                   rtol=RTOL, atol=1e-6)
        assert float(met['comm_saturation']) == 0.0
    flat = jkv.flatten_params(jp)
    for k in flat:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(flat[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_compress_conflict_raises():
    from repro_torch.train.compression import make_dp_train_step
    with pytest.raises(ValueError, match='conflicting'):
        make_dp_train_step(cases.mlp_model(), *make_optimizer('eva'),
                           compress=False, device='cpu',
                           comm=exchange.ExchangeConfig(grads='int8'))


def test_trainer_comm_sites_match_reference(tmp_path):
    """``Trainer(comm=...)`` in one process: the ``comm_exchange`` record
    holds the reference's sites (K-FAC's statistics, recorded 'local'; its
    refresh, one worker's stack), and every record validates."""
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.obs.events import validate_record
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dict(total_steps=3, log_every=1, ckpt_every=0)
    comm = exchange.ExchangeConfig(stats='bf16')
    model = cases.mlp_model()
    opt, cap = make_optimizer('kfac', lr=cases.MLP_LR)
    Trainer(model, opt, cap, TrainerConfig(**cfg, out_dir=str(
        tmp_path / 'port')), comm=comm, device='cpu').fit(
        M.params_from_numpy(_params_np(), 'cpu'),
        tsyn.ClassStream(**cases.MLP_STREAM, device='cpu'), resume=False)
    jm = jsimple.MLP(cases.MLP_DIMS)
    jm.loss_fn = jsimple.classifier_loss_fn(jm)
    jopt, jcap = jmake('kfac', lr=cases.MLP_LR)
    b = cases.MLP_STREAM['batch']
    JTrainer(jm, jopt, jcap, JTrainerConfig(**cfg, out_dir=str(
        tmp_path / 'ref')), taps_fn=lambda p: jm.make_taps(b, jcap),
        comm=jex.ExchangeConfig(stats='bf16')).fit(
        jkv.unflatten_params({k: jax.numpy.asarray(v)
                              for k, v in _params_np().items()}),
        jsyn.ClassStream(**cases.MLP_STREAM), resume=False)

    def comm_rec(d):
        recs = [json.loads(line) for line in
                (d / 'metrics.jsonl').read_text().splitlines()]
        for r in recs:
            assert ref_validate(r) == [], r
            assert validate_record(r) == [], r
        (rec,) = [r for r in recs if r['event'] == 'comm_exchange']
        steps = [r for r in recs if r['event'] == 'step']
        return ({k: {f: v[f] for f in ('bytes_per_call', 'codec', 'mode')}
                 for k, v in rec['sites'].items()},
                [r['exchanged_mb_cum'] for r in steps])

    got, mb = comm_rec(tmp_path / 'port')
    want, jmb = comm_rec(tmp_path / 'ref')
    assert got == want
    assert mb == jmb
