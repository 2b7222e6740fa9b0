"""The port's one-step pipeline (``schedule/pipeline.py``,
``RefreshRuntime(pipeline='onestep')``) against the reference's.

* Slot semantics: a cold slot is zeros at age 0; ``stage`` hands out the
  old buffer and puts the fresh one in flight at age 1; ``tick`` follows
  the host refresh decision.  Init and update must agree on the mode.
* One process, the cases of tests/test_pipeline.py: Eva and Eva-f under
  'onestep' equal a sync run fed the shifted stream ``[0, s_0, s_1, ...]``
  bit for bit (the cold start preconditions with zero statistics), and
  track the reference's 'onestep' run; K-FAC, FOOF and Shampoo at
  intervals 1 and 3 track the reference's 'onestep' run.  Port against
  reference: rtol 1e-4, atol 1e-5 (f32 LAPACK and eigh in other orders).
  Shampoo's damping is 0.03 here and its outputs are held to atol 1e-4:
  its roots (M + γI)^{-1/4} of the toy's rank-deficient accumulators move
  by (1/4)(λ+γ)^{-5/4} per unit change of an eigenvalue λ near 0, about
  20x at γ = 0.03 (at the reference test's 1e-4, ~1e4x, which one process
  of the port already shows against the reference).  Eva-s exchanges
  nothing: 'onestep' equals 'sync' exactly.
* Four gloo workers: every 'onestep' method tracks the one-process port
  run (rtol 1e-4, atol 1e-5); after a step the statistics mean is still in
  flight (one pending handle for the methods that reduce statistics, none
  for Shampoo), so the state does not copy until it is settled; the
  realized staleness is the reference's.
"""
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core.transform import Extras as JExtras  # noqa: E402
from repro.schedule import policy as jpolicy  # noqa: E402
from repro.schedule import runtime as jrt  # noqa: E402
from repro_torch.core.transform import Extras  # noqa: E402
from repro_torch.launch import workers  # noqa: E402
from repro_torch.schedule import pipeline as pipemod  # noqa: E402
from repro_torch.schedule import policy as tpolicy  # noqa: E402
from repro_torch.schedule.runtime import RefreshRuntime  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
STEPS = 6
ONESTEP = RefreshRuntime(pipeline='onestep')
SHAMPOO_GAMMA = 0.03
SHAMPOO_ATOL = 1e-4


@pytest.fixture(scope='module')
def w4():
    return workers.spawn(cases.pipeline_cases, 4, args=(STEPS,),
                         device='cpu', timeout=240, threads=1)


def _port_makers():
    from repro_torch.core.shampoo import shampoo_preconditioner
    makers = dict(cases.MAKERS)
    makers['shampoo'] = lambda **kw: shampoo_preconditioner(SHAMPOO_GAMMA,
                                                            **kw)
    return makers


def _port_run(method, steps, sched=None, stats_fn=None, **kw):
    makers = _port_makers()
    saved = cases.MAKERS[method]
    cases.MAKERS[method] = makers[method]
    try:
        return cases.run_toy(method, steps, sched=sched, stats_fn=stats_fn,
                             **kw)
    finally:
        cases.MAKERS[method] = saved


def _ref_run(method, steps, sched, policy):
    from repro.core.eva import eva_preconditioner
    from repro.core.eva_f import eva_f_preconditioner
    from repro.core.foof import foof_preconditioner
    from repro.core.kfac import kfac_preconditioner
    from repro.core.shampoo import shampoo_preconditioner
    makers = {
        'eva': lambda: eva_preconditioner(0.03, 0.9, policy=policy),
        'eva_f': lambda: eva_f_preconditioner(0.03, 0.9, policy=policy),
        'foof': lambda: foof_preconditioner(0.03, 0.9, policy=policy),
        'kfac': lambda: kfac_preconditioner(0.03, 0.9, policy=policy),
        'shampoo': lambda: shampoo_preconditioner(SHAMPOO_GAMMA,
                                                  policy=policy),
    }
    opt = makers[method]()
    needs = method in cases.NEEDS_STATS

    def grads(t):
        return jkv.unflatten_params({k: jnp.asarray(v) for k, v in
                                     cases.toy_grads(t).items()})

    def stats(t):
        return {k: jkv.LayerStats(**{f: jnp.asarray(x) for f, x in v.items()})
                for k, v in cases.toy_stats(t).items()}

    state = opt.init(grads(0), JExtras(stats=stats(0) if needs else None,
                                       sched=sched))
    outs = []
    for t in range(steps):
        out, state = opt.update(grads(t), state, extras=JExtras(
            stats=stats(t) if needs else None, sched=sched))
        outs.append(jkv.flatten_params(out))
    return outs


def _close(outs, ref, msg='', atol=ATOL):
    for t, (got, want) in enumerate(zip(outs, ref)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=atol,
                                       err_msg=f'{msg} step {t} {k}')


def test_pipeline_state_slots():
    tmpl = {'a': torch.ones(2, 3)}
    p = pipemod.init_state(tmpl)
    assert torch.equal(p.inflight['a'], torch.zeros(2, 3))
    assert int(p.age) == 0 and p.age.dtype == torch.int32
    applied, p1 = pipemod.stage(p, {'a': torch.full((2, 3), 5.0)})
    assert torch.equal(applied['a'], torch.zeros(2, 3))
    assert torch.equal(p1.inflight['a'], torch.full((2, 3), 5.0))
    assert int(p1.age) == 1
    applied, _ = pipemod.stage(p1, {'a': torch.full((2, 3), 7.0)})
    assert torch.equal(applied['a'], torch.full((2, 3), 5.0))
    r = pipemod.init_state()
    assert r.inflight is None and int(r.age) == 0
    for refresh, age in ((True, 1), (False, 2), (False, 3), (True, 1)):
        r = pipemod.tick(r, refresh)
        assert int(r.age) == age


def test_staged_pmean_sync_is_the_identity_outside_a_scope():
    tree = {'x': torch.arange(6.0).reshape(2, 3)}
    fresh, pipe = pipemod.staged_pmean(tree, None)
    assert pipe is None and torch.equal(fresh['x'], tree['x'])


def test_resolve_pipe_mode_mismatch_raises():
    with pytest.raises(ValueError, match='onestep'):
        _, state = cases.run_toy('kfac', 1)
        cases.MAKERS['kfac']().update(
            cases._t_grads(0), state,
            extras=Extras(stats=cases._t_stats(0), sched=ONESTEP))
    with pytest.raises(ValueError, match='sync'):
        opt = cases.MAKERS['kfac']()
        state = opt.init(cases._t_grads(0), Extras(stats=cases._t_stats(0),
                                                   sched=ONESTEP))
        opt.update(cases._t_grads(0), state,
                   extras=Extras(stats=cases._t_stats(0)))
    with pytest.raises(ValueError):
        RefreshRuntime(pipeline='twostep')


@pytest.mark.parametrize('method', ['eva', 'eva_f'])
@pytest.mark.parametrize('policy', ['every_k(1)', 'adaptive(0.05)'])
def test_onestep_equals_shifted_stream_and_tracks_reference(method, policy):
    pol = (tpolicy.every_k(1) if policy == 'every_k(1)'
           else tpolicy.adaptive(threshold=0.05))
    jpol = (jpolicy.every_k(1) if policy == 'every_k(1)'
            else jpolicy.adaptive(threshold=0.05))
    onestep, _ = _port_run(method, STEPS, sched=ONESTEP, policy=pol)
    sync, _ = _port_run(method, STEPS, stats_fn=cases.shifted_stats,
                        policy=pol)
    for t in range(STEPS):
        for k in onestep[t]:
            assert torch.equal(onestep[t][k], sync[t][k]), (t, k)
    _close(onestep, _ref_run(method, STEPS,
                             jrt.RefreshRuntime(pipeline='onestep'), jpol),
           method)


@pytest.mark.parametrize('method', ['kfac', 'foof', 'shampoo'])
@pytest.mark.parametrize('interval', [1, 3])
def test_onestep_interval_methods_track_reference(method, interval):
    outs, _ = _port_run(method, STEPS, sched=ONESTEP,
                        policy=tpolicy.every_k(interval))
    ref = _ref_run(method, STEPS, jrt.RefreshRuntime(pipeline='onestep'),
                   jpolicy.every_k(interval))
    _close(outs, ref, f'{method}@{interval}',
           SHAMPOO_ATOL if method == 'shampoo' else ATOL)
    # the cold start: step 0 preconditions with zero caches
    for k in outs[0]:
        assert float(outs[0][k].abs().max()) == 0.0, k


def test_onestep_eva_s_is_sync():
    a, sa = cases.run_toy('eva_s', STEPS, sched=ONESTEP)
    b, sb = cases.run_toy('eva_s', STEPS)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    from repro_torch.core.transform import tree_leaves_with_path
    la, lb = tree_leaves_with_path(sa), tree_leaves_with_path(sb)
    assert list(la) == list(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_pipe_entries_and_metrics():
    _, state = cases.run_toy('kfac', STEPS, sched=ONESTEP,
                             policy=tpolicy.every_k(2))
    entries = pipemod.pipe_entries(state)
    assert sorted(k for k, _ in entries) == ['refresh', 'stats']
    by_key = dict(entries)
    assert int(by_key['stats'].age) == 1
    assert int(by_key['refresh'].age) == 2     # refreshed at 0, 2, 4
    m = pipemod.pipeline_metrics(state)
    assert {k: int(v) for k, v in m.items()} == {
        'pipeline_lag': 2, 'pipeline_lag/refresh': 2,
        'pipeline_lag/stats': 1}
    _, state = cases.run_toy('kfac', 1)
    assert pipemod.pipe_entries(state) == []
    assert pipemod.pipeline_metrics(state) == {}


@pytest.mark.parametrize('method', ['eva', 'eva_f', 'kfac', 'foof',
                                    'shampoo'])
@pytest.mark.multihost
def test_w4_onestep_tracks_one_process(w4, method):
    outs, state, lag, pending, copies = w4[0][method]
    single, sstate = cases.run_toy(method, STEPS, sched=ONESTEP,
                                   policy=tpolicy.every_k(2))
    for t, (got, want) in enumerate(zip(outs, single)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f'{method} step {t} {k}')
    from repro_torch.core.transform import tree_leaves_with_path
    want_state = tree_leaves_with_path(sstate)
    assert list(state) == [k for k, v in want_state.items()
                           if torch.is_tensor(v)]
    for k, v in state.items():
        np.testing.assert_allclose(v.float().numpy(),
                                   want_state[k].float().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # every_k(2) refreshed at steps 0, 2, 4: after step 5 the cached
    # values are 2 steps old; the statistics buffer always 1
    expect = {'pipeline_lag': 2, 'pipeline_lag/refresh': 2}
    if method in cases.NEEDS_STATS:
        expect['pipeline_lag/stats'] = 1
    if method in ('eva', 'eva_f'):
        expect = {'pipeline_lag': 1, 'pipeline_lag/stats': 1}
    assert lag == expect
    assert pending == [1 if method in cases.NEEDS_STATS else 0] * STEPS
    assert copies == [method not in cases.NEEDS_STATS, True]
    for res in w4[1:]:
        for a, b in zip(res[method][0], outs):
            for k in a:
                assert torch.equal(a[k], b[k])
