"""The refresh policies against the reference: ``warmup_then_k`` and
``adaptive`` (with ``max_interval``) on eva (composed and fused), eva_f,
eva_s, kfac, foof and shampoo, from the same weights and batches on the MLP
of ``tests/test_optimizers.py``, 15 steps.

Each step's refresh counters (``schedule_metrics``: refreshes and
refresh_since) equal the reference's, and its staleness agrees within rtol
1e-4.  Losses rtol 1e-4 (atol 1e-6); final parameters and every float
leaf of the state rtol 1e-4, atol 1e-5, except the cached operators of the
explicit-inverse methods, held to atol 1e-5 of their largest magnitude
(K-FAC's and FOOF's inverses carry the f32 rounding of their factors
amplified by up to 1/γ), and Shampoo's cached roots, held to atol 2e-2 as
in ``test_torch_kfac_shampoo.py`` (a root at an eigenvalue near ε_init
moves by ~1e-2 for an f32 rounding of its factor).  Under ``adaptive`` each
decision compares a drift with the threshold; the test asserts that every
drift of the run lies at least 1e-3 of the threshold away from it, so that
no decision rests on a summation order (Eva-s, whose KVs are the gradients'
own means, runs at threshold 0.25 so that it skips refreshes too).
Within the port, ``every_k(1)`` gives the default policy's run bit for bit,
and under ``adaptive`` the eva family keeps its applied tree once, in
``SchedState.snapshot``, with ``cached=None`` as in the reference.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.schedule import policy as jpol  # noqa: E402
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.core.transform import tree_leaves_with_path  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.schedule import policy as tpol  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa

RTOL, ATOL = 1e-4, 1e-5
ROOT_ATOL = 2e-2
MARGIN = 1e-3
STREAM = dict(batch=64, dim=16, classes=4, spread=1.5, seed=0)
DIMS = [16, 32, 32, 4]
STEPS = 15
LR = 0.03
POLICIES = {
    'warmup_then_k': dict(warmup=3, k=4),
    'adaptive': dict(threshold=0.05, max_interval=4),
}
OPTIMIZERS = ['eva', 'eva_fused', 'eva_f', 'eva_s', 'kfac', 'foof',
              'shampoo']
# Eva-s's KVs are the gradients' own means, which drift past 0.05 on every
# step of this run; its adaptive threshold is higher, so that it skips too
THRESHOLD = {'eva_s': 0.25}


def _policy_kw(case, pol_name):
    kw = dict(POLICIES[pol_name])
    if pol_name == 'adaptive':
        kw['threshold'] = THRESHOLD.get(case, kw['threshold'])
    return kw


def _opt_kw(case):
    return ('eva', {'fused': True}) if case == 'eva_fused' else (case, {})


def _ref_params():
    return JM.init_params(jsimple.MLP(DIMS).param_specs(),
                          jax.random.PRNGKey(0))


def _ref_run(case, pol_name):
    name, kw = _opt_kw(case)
    jm = jsimple.MLP(DIMS)
    jm.loss_fn = jsimple.classifier_loss_fn(jm)
    data = jsyn.ClassStream(**STREAM)
    jp = _ref_params()
    opt, cap = jmake(name, lr=LR,
                     policy=jpol.named_policy(pol_name,
                                              **_policy_kw(case, pol_name)),
                     **kw)
    taps_fn = (lambda p: jm.make_taps(STREAM['batch'], cap)) \
        if cap.needs_taps else None
    st = jinit(jm, opt, cap, jp, data.batch_at(0), taps_fn=taps_fn)
    step = jax.jit(jstep_fn(jm, opt, cap, taps_fn=taps_fn))
    losses, sched = [], []
    for i in range(STEPS):
        jp, st, met = step(jp, st, data.batch_at(i))
        losses.append(float(met['loss']))
        sched.append({k: float(met[k]) for k in
                      ('refreshes', 'refresh_since', 'staleness')})
    return np.array(losses), sched, jkv.flatten_params(jp), st


def _port_run(case, policy, steps=STEPS):
    name, kw = _opt_kw(case)
    tm = simple.MLP(DIMS)
    tm.loss_fn = simple.classifier_loss_fn(tm)
    data = tsyn.ClassStream(**STREAM, device='cpu')
    params = M.params_from_numpy(
        {k: np.asarray(v)
         for k, v in jkv.flatten_params(_ref_params()).items()}, 'cpu')
    if policy is not None:
        kw = dict(kw, policy=policy)
    opt, cap = make_optimizer(name, lr=LR, **kw)
    st = init_opt_state(tm, opt, cap, params, data.batch_at(0), device='cpu')
    step = make_train_step(tm, opt, cap, device='cpu')
    losses, sched = [], []
    for i in range(steps):
        params, st, met = step(params, st, data.batch_at(i))
        losses.append(float(met['loss']))
        sched.append({k: float(met[k]) for k in
                      ('refreshes', 'refresh_since', 'staleness')})
    return np.array(losses), sched, params, st


def _atol(case, key, want):
    if case == 'shampoo' and ('/p_in/' in key or '/p_out/' in key):
        return ROOT_ATOL
    if '/a_inv/' in key or '/b_inv/' in key:
        return ATOL * max(1.0, float(np.abs(want).max()))
    return ATOL


@pytest.mark.parametrize('pol_name', sorted(POLICIES))
@pytest.mark.parametrize('case', OPTIMIZERS)
def test_matches_reference(case, pol_name):
    jl, jsched, jp, jst = _ref_run(case, pol_name)
    pkw = _policy_kw(case, pol_name)
    tl, tsched, tp, tst = _port_run(case, tpol.named_policy(pol_name, **pkw))
    if pol_name == 'adaptive':
        thr = pkw['threshold']
        drifts = [s['staleness'] for s in jsched[1:]]
        gap = min(abs(d - thr) for d in drifts) / thr
        assert gap >= MARGIN, f'a drift lies {gap:.2e} of the threshold off'
    refreshes = [int(s['refreshes']) for s in jsched]
    assert 1 < refreshes[-1] < STEPS, refreshes
    for i, (j, t) in enumerate(zip(jsched, tsched)):
        assert t['refreshes'] == j['refreshes'], (i, jsched, tsched)
        assert t['refresh_since'] == j['refresh_since'], (i, jsched, tsched)
        np.testing.assert_allclose(t['staleness'], j['staleness'],
                                   rtol=RTOL, atol=1e-7, err_msg=f'step {i}')
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=1e-6)
    tp = M.params_to_numpy(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    want = {k: np.asarray(v) for k, v in tree_leaves_with_path(jst).items()}
    got = M.state_to_numpy(tst)
    assert set(got) == set(want)
    assert any('/sched/snapshot/' in k for k in got) == \
        (pol_name == 'adaptive')
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                       atol=_atol(case, k, w), err_msg=k)


@pytest.mark.parametrize('case', ['eva', 'eva_fused', 'eva_f', 'eva_s'])
def test_eva_family_keeps_the_applied_tree_once(case):
    """Under a snapshot policy ``cached`` is None and the applied tree is
    ``SchedState.snapshot``; under a counter policy ``cached`` holds it and
    there is no snapshot."""
    for policy, snap in ((tpol.adaptive(0.05), True),
                         (tpol.warmup_then_k(2, 3), False)):
        _, _, _, st = _port_run(case, policy, steps=3)
        pre = st.inner[0]
        assert (pre.cached is None) == snap
        assert (pre.sched.snapshot is not None) == snap


@pytest.mark.parametrize('case', ['eva', 'eva_f', 'kfac', 'foof', 'shampoo'])
def test_every_k_1_equals_the_default(case):
    """``every_k(1)`` and no policy give the same run bit for bit."""
    la, sa, pa, st_a = _port_run(case, None, steps=6)
    lb, sb, pb, st_b = _port_run(case, tpol.every_k(1), steps=6)
    np.testing.assert_array_equal(la, lb)
    assert sa == sb
    for a, b in ((M.params_to_numpy(pa), M.params_to_numpy(pb)),
                 (M.state_to_numpy(st_a), M.state_to_numpy(st_b))):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_named_policy():
    p = tpol.named_policy('every_k', k=5)
    assert p.name == 'every_k(5)' and not p.wants_snapshot and not p.always
    assert tpol.named_policy('every_k').always
    p = tpol.named_policy('warmup_then_k', warmup=2, k=3)
    assert p.name == jpol.named_policy('warmup_then_k', warmup=2, k=3).name
    assert not p.always
    p = tpol.named_policy('adaptive', threshold=0.1)
    assert p.wants_snapshot and p.name == 'adaptive(0.1)'
    with pytest.raises(KeyError, match='unknown policy'):
        tpol.named_policy('never')
    with pytest.raises(ValueError):
        tpol.warmup_then_k(-1, 2)
    with pytest.raises(ValueError):
        tpol.adaptive(0.0)


def test_warmup_then_k_decisions_match_reference():
    """The decision sequence over 20 counts, without stats."""
    for warmup, k in ((0, 3), (4, 5), (2, 1)):
        tp, jp = tpol.warmup_then_k(warmup, k), jpol.warmup_then_k(warmup, k)
        st = tpol.init_state(tp, None, 'cpu')
        jst = jpol.init_state(jp, None)
        for _ in range(20):
            r, _ = tp.decide(st, None)
            jr, _ = jp.decide(jst, None)
            assert bool(r) == bool(jr)
            st = tpol.commit(tp, st, None, r, torch.zeros(()))
            jst = jpol.commit(jp, jst, None, jr, 0.0)


def test_adaptive_without_snapshot_raises():
    st = tpol.init_state(tpol.every_k(1), {'a': torch.zeros(2)}, 'cpu')
    with pytest.raises(ValueError, match='no drift snapshot'):
        tpol.adaptive(0.05).decide(st, {'a': torch.ones(2)})
