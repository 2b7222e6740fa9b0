"""Elastic training in the port: ``schedule/reshard.py`` and
``Trainer.fit_elastic`` over ``torch.distributed``.

* Units against the reference: ``plan_fingerprint`` and
  ``elastic_metadata`` give the reference's strings for the same plans;
  ``ownership_delta`` its integers; ``check_metadata`` refuses a changed
  plan or pipeline mode; the drain rule zeroes in-flight buffers at age 0
  on a resize and keeps them otherwise.
* One-rank gloo group: ``fit_elastic(world=1)`` equals ``fit`` bit for
  bit, and a run cut by its checkpoint resumes bit for bit.
* Four gloo workers, the scenarios of tests/test_elastic.py (MLP [8, 16,
  3], ``ClassStream(batch=32)``, Eva and K-FAC): W = 4, SIGTERM at step 8,
  restore at W = 2, SIGTERM at 16, restore at W = 4 to step 24.  The
  stitched trajectory has every step once and lies within the reference's
  ``TRAJ_TOL`` 5e-6 of the uninterrupted W = 4 run (across W only the
  float order of the batch mean changes); the ``reshard`` records are
  (4, 2, 'checkpoint') and (2, 4, 'checkpoint'), the ownership records W
  = 4, 2, 4, and every record passes the port's and the reference's
  validators.  The uninterrupted port run lies within ``TRAJ_TOL`` of the
  reference's ``fit`` on the whole batch from the same weights.  A live
  resize 4 -> 2 -> 4 (``world_fn``, the idle ranks brought back by rank
  0's broadcast) stays within ``TRAJ_TOL`` of the constant-W run; under
  'onestep' it drains the pipeline (a documented cold step: within 0.1).
"""
import json

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro.core import bucketing as jbucketing  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.obs.events import validate_record as ref_validate  # noqa: E402
from repro.schedule import reshard as jreshard  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa
from repro_torch.core import bucketing  # noqa: E402
from repro_torch.launch import workers  # noqa: E402
from repro_torch.obs.events import validate_record  # noqa: E402
from repro_torch.schedule import pipeline as pipemod  # noqa: E402
from repro_torch.schedule import reshard  # noqa: E402
from repro_torch.schedule.policy import every_k  # noqa: E402
from repro_torch.schedule.runtime import RefreshRuntime  # noqa: E402

# the reference's cross-resize trajectory tolerance (sync, f32 wire)
TRAJ_TOL = 5e-6

SHAPES = {'blk0/w': (8, 4), 'blk1/w': (8, 4), 'head/w': (8, 3),
          'stack/w': (2, 6, 4)}


def _params_np():
    jm = jsimple.MLP([8, 16, 3])
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in jkv.flatten_params(jp).items()}


def _plans(shapes):
    return (bucketing.build_plan({p: torch.empty(s, device='meta')
                                  for p, s in shapes.items()}),
            jbucketing.build_plan({p: jax.ShapeDtypeStruct(s, jnp.float32)
                                   for p, s in shapes.items()}))


def _ae_shapes():
    dims = [784, 1000, 500, 250, 30, 250, 500, 1000, 784]
    return {f'fc{i}/w': (dims[i], dims[i + 1]) for i in range(8)}


def _records(out_dir):
    return [json.loads(line) for line in
            (out_dir / 'metrics.jsonl').read_text().splitlines()]


@pytest.fixture(scope='module')
def w4(tmp_path_factory):
    root = tmp_path_factory.mktemp('elastic')
    res = workers.spawn(cases.elastic_cases, 4, args=(_params_np(),
                                                      str(root)),
                        device='cpu', timeout=300, threads=1)
    return res, root


# ---------------------------------------------------------------------------
# reshard.py against the reference


@pytest.mark.parametrize('shapes', [SHAPES, _ae_shapes(),
                                    {'blk0/w': (8, 5)}])
def test_fingerprint_metadata_and_delta_equal_reference(shapes):
    plan, jplan = _plans(shapes)
    assert reshard.plan_fingerprint(plan) == jreshard.plan_fingerprint(jplan)
    for world, pipe in ((1, 'sync'), (4, 'onestep'), (2, 'sync')):
        assert reshard.elastic_metadata(world, plan, pipe) == \
            jreshard.elastic_metadata(world, jplan, pipe)
    for a, b in ((4, 2), (2, 4), (1, 8), (3, 3)):
        assert reshard.ownership_delta(plan, a, b) == \
            jreshard.ownership_delta(jplan, a, b)
    assert reshard.plan_fingerprint(None) == '' == \
        jreshard.plan_fingerprint(None)


def test_check_metadata_mismatches():
    plan, _ = _plans(SHAPES)
    meta = reshard.elastic_metadata(4, plan=plan, pipeline='onestep')
    assert reshard.check_metadata(meta, plan=plan, pipeline='onestep') == 4
    assert reshard.check_metadata(None, plan=plan) == 0
    assert reshard.check_metadata({}, plan=plan) == 0
    other, _ = _plans({'blk0/w': (8, 5)})
    with pytest.raises(reshard.ReshardError, match='plan'):
        reshard.check_metadata(meta, plan=other, pipeline='onestep')
    with pytest.raises(reshard.ReshardError, match='pipeline'):
        reshard.check_metadata(meta, plan=plan, pipeline='sync')


def test_batch_divisibility_check():
    from repro_torch.data import synthetic as tsyn
    batch = tsyn.ClassStream(batch=30, dim=8, classes=3, seed=0,
                             device='cpu').batch_at(0)
    reshard.check_batch_divisible(batch, 2)
    with pytest.raises(reshard.ReshardError, match='batch % W'):
        reshard.check_batch_divisible(batch, 4)


def test_reshard_state_drain_rule():
    _, state = cases.run_toy('kfac', 3, sched=RefreshRuntime(
        pipeline='onestep'), policy=every_k(2))
    plan, _ = _plans({k: v for k, v in cases.SHAPES.items()})
    same, body = reshard.reshard_state(state, world_from=4, world_to=4,
                                       plan=plan, step=3)
    assert same is state and body['pipeline'] == 'kept'
    drained, body = reshard.reshard_state(state, world_from=4, world_to=2,
                                          plan=plan, step=3, source='live')
    assert body['pipeline'] == 'drained' and body['source'] == 'live'
    assert body['world_from'] == 4 and body['world_to'] == 2
    assert body['step'] == 3 and 'slices_moved' in body
    assert validate_record({'event': 'reshard', **body}) == []
    assert ref_validate({'event': 'reshard', **body}) == []
    from repro_torch.core.transform import tree_leaves_with_path
    for _, p in pipemod.pipe_entries(drained):
        assert int(p.age) == 0
        for x in tree_leaves_with_path(p.inflight).values():
            assert float(x.abs().max()) == 0.0
    kept, body = reshard.reshard_state(state, world_from=4, world_to=2,
                                       pipeline_rule='keep')
    assert body['pipeline'] == 'kept' and kept is state
    with pytest.raises(ValueError):
        reshard.reshard_state(state, world_from=1, world_to=2,
                              pipeline_rule='flush')
    _, body = reshard.reshard_state({'x': torch.ones(1)}, world_from=1,
                                    world_to=2)
    assert body['pipeline'] == 'none'


# ---------------------------------------------------------------------------
# One rank


def test_fit_elastic_needs_a_group_and_no_profile(tmp_path):
    import torch.distributed as dist
    assert not dist.is_initialized()
    tr, p = cases.elastic_trainer('eva', _params_np(), tmp_path, 2)
    with pytest.raises(RuntimeError, match='started group'):
        tr.fit_elastic(p, cases._class_stream())
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tr2 = Trainer(cases.mlp_model(), *cases.make_optimizer('eva'),
                  TrainerConfig(total_steps=2, profile=True,
                                out_dir=str(tmp_path / 'p')), device='cpu')
    with pytest.raises(ValueError, match='profile'):
        tr2.fit_elastic(p, cases._class_stream())


@pytest.fixture(scope='module')
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp('store') / 'store'
    workers.init_workers(device='cpu', rank=0, world=1,
                         init_method=f'file://{store}')
    yield
    workers.shutdown_workers()


def test_fit_elastic_w1_matches_fit_bit_exact(one_rank, tmp_path):
    for name in ('eva', 'kfac'):
        tr, p = cases.elastic_trainer(name, _params_np(),
                                      tmp_path / f'{name}_fit', 8)
        pf, sf, h_fit = tr.fit(p, cases._class_stream())
        tr, p = cases.elastic_trainer(name, _params_np(),
                                      tmp_path / f'{name}_el', 8)
        pe, se, h_el = tr.fit_elastic(p, cases._class_stream(), world=1)
        assert [loss for _, loss in h_el] == h_fit
        assert [s for s, _ in h_el] == list(range(8))
        for k in pf:
            assert torch.equal(pf[k], pe[k]), k
        for r in _records(tmp_path / f'{name}_el'):
            assert validate_record(r) == [] and ref_validate(r) == [], r


def test_fit_elastic_resume_same_world_bit_exact(one_rank, tmp_path):
    tr, p = cases.elastic_trainer('eva', _params_np(), tmp_path / 'full',
                                  10)
    _, _, h_full = tr.fit_elastic(p, cases._class_stream(), world=1)
    tr, p = cases.elastic_trainer('eva', _params_np(), tmp_path / 'cut', 6,
                                  ckpt_every=6)
    _, _, h_a = tr.fit_elastic(p, cases._class_stream(), world=1)
    tr, p = cases.elastic_trainer('eva', _params_np(), tmp_path / 'cut', 10,
                                  ckpt_every=6)
    _, _, h_b = tr.fit_elastic(p, cases._class_stream(), world=1)
    assert [s for s, _ in h_b] == list(range(6, 10))
    assert h_a + h_b == h_full
    manifest = json.loads(next((tmp_path / 'cut' / 'ckpt').glob(
        'step_*/manifest.json')).read_text())
    assert manifest['metadata'][reshard.ELASTIC_KEY]['world'] == 1


# ---------------------------------------------------------------------------
# Four workers


def _ref_fit(name, steps, tmp_path):
    jm = jsimple.MLP([8, 16, 3])
    jm.loss_fn = jsimple.classifier_loss_fn(jm)
    jopt, jcap = jmake(name, lr=0.05)
    taps_fn = ((lambda p, b: jm.make_taps(b['x'].shape[0], jcap))
               if jcap.needs_taps else None)
    tr = JTrainer(jm, jopt, jcap, JTrainerConfig(
        total_steps=steps, log_every=100, out_dir=str(tmp_path)),
        taps_fn=taps_fn)
    _, _, hist = tr.fit(
        jkv.unflatten_params({k: jnp.asarray(v)
                              for k, v in _params_np().items()}),
        jsyn.ClassStream(batch=32, dim=8, classes=3, seed=0), resume=False)
    return hist


@pytest.mark.multihost
@pytest.mark.parametrize('name', ['eva', 'kfac'])
def test_chaos_kill_reshard_matches_uninterrupted(w4, name, tmp_path):
    res, root = w4
    out = res[0][name]
    base = out['base']
    stitched = out['chaos'][0] + out['chaos'][1] + out['chaos'][2]
    assert [s for s, _ in stitched] == list(range(24))
    diffs = [abs(a - b) for (_, a), (_, b) in zip(base, stitched)]
    assert max(diffs) < TRAJ_TOL, f'trajectory drift {max(diffs)}'
    # ranks 2 and 3 idled through the W = 2 phase
    assert res[2][name]['chaos'][1] == [] == res[3][name]['chaos'][1]
    recs = _records(root / name / 'chaos')
    for rec in recs:
        assert validate_record(rec) == [] and ref_validate(rec) == [], rec
    resizes = [(r['world_from'], r['world_to'], r['source'])
               for r in recs if r['event'] == 'reshard']
    assert resizes == [(4, 2, 'checkpoint'), (2, 4, 'checkpoint')]
    owns = [r['world'] for r in recs if r['event'] == 'refresh_ownership']
    assert owns == [4, 2, 4]
    ref = _ref_fit(name, 24, tmp_path)
    diffs = [abs(a - b) for (_, a), b in zip(base, ref)]
    assert max(diffs) < TRAJ_TOL, f'port W=4 vs reference {max(diffs)}'


@pytest.mark.multihost
@pytest.mark.parametrize('name', ['eva', 'kfac'])
def test_live_resize_matches_uninterrupted(w4, name):
    res, root = w4
    out = res[0][name]
    live, base = out['live'], out['base'][:16]
    assert [s for s, _ in live] == list(range(16))
    assert max(abs(a - b) for (_, a), (_, b) in zip(base, live)) < TRAJ_TOL
    # rank 3 sat out steps 6-10 and rejoined with rank 0's state
    assert [s for s, _ in res[3][name]['live']] == \
        [s for s in range(16) if not 6 <= s < 11]
    assert [loss for s, loss in res[3][name]['live'] if s > 10] == \
        [loss for s, loss in live if s > 10]
    recs = _records(root / name / 'live')
    for rec in recs:
        assert validate_record(rec) == [] and ref_validate(rec) == [], rec
    assert [(r['world_from'], r['world_to'], r['source']) for r in recs
            if r['event'] == 'reshard'] == [(4, 2, 'live'), (2, 4, 'live')]
    assert any(r['event'] == 'comm_exchange' for r in recs)


@pytest.mark.multihost
def test_live_resize_onestep_drains_pipeline(w4):
    res, root = w4
    runs = res[0]['onestep']
    diff = max(abs(a - b) for (_, a), (_, b) in zip(runs['base'],
                                                    runs['resized']))
    assert diff < 0.1
    drains = [r['pipeline'] for r in _records(root / 'onestep' / 'resized')
              if r['event'] == 'reshard']
    assert drains == ['drained', 'drained']
