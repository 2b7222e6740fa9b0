"""The port's ``Trainer.fit`` on one device: on ``demo_lm('small')`` with
``LMStream(vocab=512, seq_len=32, batch=8, seed=1)`` (the reference's
``tests/test_train_integration.py::_setup``) its loss history tracks the
reference's ``Trainer.fit`` from the same weights within rtol 1e-4 (atol
1e-6; measured: the LM files of this suite hold Eva's 10 steps within
6.1e-7); a run cut by its checkpoints and resumed by a fresh ``Trainer``
equals an unbroken one bit for bit (Eva under ``adaptive`` on the MLP, and
Eva on the LM); a preemption request writes a synchronous checkpoint and
stops; a forced slow step emits a ``straggler`` record; profile mode emits
fenced spans and ``profile`` records; a ``KernelConfig`` with an autotune
cache is accepted, installs its cache and writes ``kernel_impl`` and
``kernel_tiles`` into every step record, with the losses of the run
without it bit for bit and the reference's ``KernelConfig(impl='xla')``
run within rtol 1e-4; and every record of ``metrics.jsonl`` passes the
reference's own ``repro.obs.events.validate_record``.
"""
import json

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import demo_lm as jdemo_lm  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.obs.events import validate_record as ref_validate  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa
from repro_torch.configs.registry import demo_lm  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import autotune, dispatch  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs.events import validate_record  # noqa: E402
from repro_torch.schedule.policy import adaptive  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

RTOL = 1e-4
STREAM = dict(vocab=512, seq_len=32, batch=8, seed=1)


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op torch thread for this module, restored after: torch's
    thread pool beside JAX's own slows these CPU runs several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(out_dir):
    path = out_dir / 'metrics.jsonl'
    return [json.loads(line) for line in path.read_text().splitlines()]


def _check_records(out_dir):
    recs = _records(out_dir)
    for r in recs:
        assert ref_validate(r) == [], r
        assert validate_record(r) == [], r
    return recs


def _lm():
    cfg = demo_lm('small')
    model = build_model(cfg)
    jp = JM.init_params(jbuild(jdemo_lm('small')).param_specs(),
                        jax.random.PRNGKey(0))
    params = M.params_from_numpy(
        {k: np.asarray(v) for k, v in jkv.flatten_params(jp).items()}, 'cpu')
    return model, params, jp, tsyn.LMStream(**STREAM, device='cpu')


def _mlp():
    model = simple.MLP([8, 16, 3])
    model.loss_fn = simple.classifier_loss_fn(model)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device='cpu')
    data = tsyn.ClassStream(batch=32, dim=8, classes=3, seed=0, device='cpu')
    return model, params, data


def _equal_trees(a, b):
    la, lb = ckpt.leaf_paths(a), ckpt.leaf_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), p


def test_lm_history_tracks_reference(tmp_path):
    model, params, jp, data = _lm()
    opt, cap = make_optimizer('eva', lr=0.05)
    cfg = TrainerConfig(total_steps=6, log_every=2, ckpt_every=0,
                        out_dir=str(tmp_path / 'port'))
    before = {k: v.clone() for k, v in params.items()}
    _, _, hist = Trainer(model, opt, cap, cfg, device='cpu').fit(
        params, data, resume=False)
    for k, v in params.items():
        assert torch.equal(v, before[k]), f'fit wrote the caller\'s {k}'
    jmodel = jbuild(jdemo_lm('small'))
    jopt, jcap = jmake('eva', lr=0.05)
    jcfg = JTrainerConfig(total_steps=6, log_every=2, ckpt_every=0,
                          out_dir=str(tmp_path / 'ref'))
    _, _, jhist = JTrainer(jmodel, jopt, jcap, jcfg).fit(
        jp, jsyn.LMStream(**STREAM), resume=False)
    np.testing.assert_allclose(hist, jhist, rtol=RTOL, atol=1e-6)
    recs = _check_records(tmp_path / 'port')
    steps = [r for r in recs if r['event'] == 'step']
    assert [r['step'] for r in steps] == [0, 2, 4, 5]
    assert all({'refreshes', 'staleness', 'refresh_since'} <= set(r)
               for r in steps)
    own = [r for r in recs if r['event'] == 'refresh_ownership']
    jown = [r for r in _records(tmp_path / 'ref')
            if r['event'] == 'refresh_ownership']
    assert len(own) == 1 and own[0]['world'] == 1
    assert own[0]['owners'] == jown[0]['owners']


@pytest.mark.parametrize('case', ['mlp_eva_adaptive', 'mlp_kfac_3',
                                  'lm_eva'])
def test_cut_and_resumed_fit_equals_unbroken(tmp_path, case):
    """A run of 10 steps checkpointing every 4, cut after 6, then finished
    by a fresh Trainer on the same out_dir from step 4, ends in the bits of
    the unbroken run; its records all validate."""
    if case == 'lm_eva':
        model, params, _, data = _lm()
        opt, cap = make_optimizer('eva', lr=0.05)
    else:
        model, params, data = _mlp()
        kw = ({'policy': adaptive(0.05)} if case == 'mlp_eva_adaptive'
              else {'interval': 3})
        opt, cap = make_optimizer(case.split('_')[1], lr=0.05, **kw)

    def run(out, total):
        cfg = TrainerConfig(total_steps=total, log_every=1, ckpt_every=4,
                            keep_ckpts=2, out_dir=str(tmp_path / out))
        return Trainer(model, opt, cap, cfg, device='cpu').fit(params, data)

    pa, sa, ha = run('a', 10)
    run('b', 6)
    assert ckpt.available_steps(tmp_path / 'b' / 'ckpt') == [4]
    pb, sb, hb = run('b', 10)
    assert ckpt.available_steps(tmp_path / 'b' / 'ckpt') == [4, 8]
    assert hb == ha[4:]
    _equal_trees(pa, pb)
    _equal_trees(sa, sb)
    _check_records(tmp_path / 'a')
    _check_records(tmp_path / 'b')
    if case == 'mlp_eva_adaptive':
        refresh = [r for r in _records(tmp_path / 'a')
                   if r['event'] == 'refresh']
        assert 1 < len(refresh) < 10


def test_preemption_writes_a_checkpoint_and_stops(tmp_path):
    model, params, data = _mlp()
    opt, cap = make_optimizer('sgd', lr=0.05)
    cfg = TrainerConfig(total_steps=1000, log_every=10_000, ckpt_every=0,
                        out_dir=str(tmp_path))
    tr = Trainer(model, opt, cap, cfg, device='cpu')
    orig, count = tr.step_fn, {'n': 0}

    def wrapped(*a):
        count['n'] += 1
        if count['n'] == 4:
            tr._preempted = True   # as the SIGTERM handler does
        return orig(*a)

    tr.step_fn = wrapped
    p, _, hist = tr.fit(params, data, resume=False)
    assert count['n'] == 4 and len(hist) == 4
    assert ckpt.latest_step(tmp_path / 'ckpt') == 4
    manifest = json.loads((tmp_path / 'ckpt' / 'step_00000004' /
                           'manifest.json').read_text())
    assert manifest['metadata'] == {'next_step': 4, 'preempted': True}
    restored, _ = ckpt.restore(tmp_path / 'ckpt', 4, {'params': params},
                               device='cpu')
    _equal_trees(restored['params'], p)


def test_sigterm_handler_requests_preemption(tmp_path):
    import os
    import signal
    model, params, data = _mlp()
    opt, cap = make_optimizer('sgd', lr=0.05)
    cfg = TrainerConfig(total_steps=50, log_every=10_000, ckpt_every=0,
                        out_dir=str(tmp_path))
    tr = Trainer(model, opt, cap, cfg, device='cpu')
    orig, count = tr.step_fn, {'n': 0}

    def wrapped(*a):
        count['n'] += 1
        if count['n'] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a)

    tr.step_fn = wrapped
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        tr.fit(params, data, resume=False)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    assert ckpt.latest_step(tmp_path / 'ckpt') == count['n'] < 50


def test_forced_slow_step_emits_a_straggler_record(tmp_path):
    import time
    model, params, data = _mlp()
    opt, cap = make_optimizer('sgd', lr=0.05)
    # a factor of 50 over a ~2 ms median: the 1 s step trips it, and the
    # noise of a loaded host does not
    cfg = TrainerConfig(total_steps=12, log_every=100, ckpt_every=0,
                        out_dir=str(tmp_path), straggler_factor=50.0)
    tr = Trainer(model, opt, cap, cfg, device='cpu')
    orig, count = tr.step_fn, {'n': 0}

    def wrapped(*a):
        count['n'] += 1
        if count['n'] == 10:
            time.sleep(1.0)
        return orig(*a)

    tr.step_fn = wrapped
    tr.fit(params, data, resume=False)
    recs = _check_records(tmp_path)
    flags = [r for r in recs if r['event'] == 'straggler']
    assert [r['step'] for r in flags] == [9]
    assert flags[0]['step_time_s'] >= 1.0 > 50.0 * flags[0]['median_s']


def test_profile_mode_emits_fenced_spans(tmp_path):
    model, params, data = _mlp()
    opt, cap = make_optimizer('eva', lr=0.05)
    cfg = TrainerConfig(total_steps=3, log_every=1, ckpt_every=0,
                        out_dir=str(tmp_path / 'run'), profile=True)
    p_prof, _, h_prof = Trainer(model, opt, cap, cfg, device='cpu').fit(
        params, data)
    cfg = TrainerConfig(total_steps=3, log_every=1, ckpt_every=0,
                        out_dir=str(tmp_path / 'plain'))
    p_plain, _, h_plain = Trainer(model, opt, cap, cfg, device='cpu').fit(
        params, data)
    assert h_prof == h_plain
    _equal_trees(p_prof, p_plain)
    recs = _check_records(tmp_path / 'run')
    by_event = {}
    for r in recs:
        by_event.setdefault(r['event'], []).append(r)
    assert len(by_event['step']) == 3 and len(by_event['profile']) == 3
    assert {'data', 'grad', 'precondition', 'apply', 'step'} == {
        s['name'] for s in by_event['span']}
    assert all(s['parent'] == 'step' for s in by_event['span']
               if s['name'] != 'step')


def test_phased_step_composes_to_the_step():
    from repro_torch.train.step import (init_opt_state, make_phased_step,
                                        make_train_step)
    model, params, data = _mlp()
    opt, cap = make_optimizer('kfac', lr=0.05, interval=2)
    step = make_train_step(model, opt, cap, device='cpu')
    grad_fn, update_fn, apply_fn = make_phased_step(model, opt, cap,
                                                    device='cpu')
    st_f = st_p = init_opt_state(model, opt, cap, params, data.batch_at(0),
                                 device='cpu')
    p_f = p_p = params
    for i in range(3):
        batch = data.batch_at(i)
        p_f, st_f, m_f = step(p_f, st_f, batch)
        loss, grads, stats = grad_fn(p_p, batch)
        updates, st_p, m_p = update_fn(grads, stats, loss, st_p, p_p)
        p_p = apply_fn(p_p, updates)
        assert set(m_f) == set(m_p)
        for k in m_f:
            assert torch.equal(m_f[k], m_p[k]), k
    _equal_trees(p_f, p_p)
    _equal_trees(st_f, st_p)


def test_trainer_entry_points_and_refusals(tmp_path):
    model, params, data = _mlp()
    opt, cap = make_optimizer('sgd', lr=0.05)
    cfg = TrainerConfig(out_dir=str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(model, opt, cap, cfg)

    # a kernel config is accepted: its cache is installed at construction
    cache = tmp_path / 'tiles.json'
    key = dispatch.cache_key('rank1_update', 8, 16, torch.float32, 'cpu')
    cache.write_text(json.dumps({'entries': {key: {'impl': 'torch'}}}))
    try:
        tr = Trainer(model, opt, cap, cfg, device='cpu',
                     kernel=dispatch.KernelConfig(autotune_cache=str(cache)))
        assert tr.kernel.impl == 'auto'
        assert dispatch._cache()[key] == {'impl': 'torch'}
    finally:
        dispatch.reset_cache()
    # the exchange config is accepted (the multi-worker layers are ported);
    # fit_elastic needs a started process group
    from repro_torch.comm.exchange import ExchangeConfig
    tr = Trainer(model, opt, cap, cfg, comm=ExchangeConfig(), device='cpu')
    assert tr.comm == ExchangeConfig()
    with pytest.raises(RuntimeError, match='started group'):
        tr.fit_elastic(params, data)


def test_kernel_config_runs_fit_and_records_its_choices(tmp_path):
    """``Trainer(kernel=KernelConfig(impl='torch', autotune_cache=...))``:
    every step record carries ``kernel_impl`` and ``kernel_tiles`` and
    validates under both validators; the losses equal the ``kernel=None``
    run's bit for bit and the reference's ``Trainer(kernel=KernelConfig(
    impl='xla'))`` within rtol 1e-4."""
    model, params, jp, data = _lm()
    cache = autotune.tune([(128, 64)], device='cpu', bench=lambda fn: 1.0)
    path = autotune.write(cache, tmp_path / 'tile_cache.json')
    kernel = dispatch.KernelConfig(impl='torch', autotune_cache=str(path))
    hists = {}
    try:
        for tag, kc in (('kernel', kernel), ('none', None)):
            opt, cap = make_optimizer('eva', lr=0.05)
            cfg = TrainerConfig(total_steps=4, log_every=1, ckpt_every=0,
                                out_dir=str(tmp_path / tag))
            _, _, hists[tag] = Trainer(model, opt, cap, cfg, kernel=kc,
                                       device='cpu').fit(params, data,
                                                         resume=False)
        assert set(dispatch._cache()) >= set(cache['entries'])
    finally:
        dispatch.reset_cache()
    assert hists['kernel'] == hists['none']
    steps = [r for r in _check_records(tmp_path / 'kernel')
             if r['event'] == 'step']
    assert [r['step'] for r in steps] == [0, 1, 2, 3]
    for r in steps:
        assert r['kernel_impl'] == 'torch'
        assert set(r['kernel_tiles']) == {'bilinear', 'rank1_update'}
        assert all(v.startswith('torch 0x0 @ ')
                   for v in r['kernel_tiles'].values())
    assert not any('kernel_impl' in r for r in _records(tmp_path / 'none'))
    jmodel = jbuild(jdemo_lm('small'))
    jopt, jcap = jmake('eva', lr=0.05)
    jcfg = JTrainerConfig(total_steps=4, log_every=1, ckpt_every=0,
                          out_dir=str(tmp_path / 'ref'))
    try:
        _, _, jhist = JTrainer(
            jmodel, jopt, jcap, jcfg,
            kernel=jdispatch.KernelConfig(impl='xla')).fit(
                jp, jsyn.LMStream(**STREAM), resume=False)
    finally:
        jdispatch.reset_cache()
    np.testing.assert_allclose(hists['kernel'], jhist, rtol=RTOL, atol=1e-6)
    jsteps = [r for r in _records(tmp_path / 'ref') if r['event'] == 'step']
    assert [r['kernel_impl'] for r in jsteps] == ['xla'] * 4
    assert set(jsteps[-1]['kernel_tiles']) >= {'bilinear', 'rank1_update'}
