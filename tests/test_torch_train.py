"""The whole slice: Eva training steps of the port against the reference
(``kernel_impl='pallas_interpret'``), from the same weights and batches.

Both sides run f32 on the CPU; they sum in other orders, and a
second-order step amplifies the difference a little each step.  Stated
tolerances: per-step loss rtol 1e-4 (atol 1e-6); final parameters and every
leaf of the optimizer state (``EvaState`` and the momentum trace) rtol 1e-4,
atol 1e-5; integer counters equal.
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
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.core.transform import tree_leaves_with_path  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa

RTOL, ATOL = 1e-4, 1e-5
RANK_ONE = ('eva', 'eva_f', 'eva_s')   # the reference runs their Pallas kernels

CASES = {
    'mlp': dict(dims=[16, 32, 32, 4], loss='classifier', steps=25,
                stream=('ClassStream', dict(batch=64, dim=16, classes=4,
                                            spread=1.5, seed=0)),
                lr=0.03),
    'autoencoder': dict(hidden=(64, 32, 8, 32, 64), d_in=64, loss='ae',
                        steps=10, stream=('AEStream', dict(batch=32, side=8)),
                        lr=0.15),
}


def _models(case):
    if 'dims' in case:
        jm, tm = jsimple.MLP(case['dims']), simple.MLP(case['dims'])
    else:
        jm = jsimple.autoencoder(case['hidden'], d_in=case['d_in'])
        tm = simple.autoencoder(case['hidden'], d_in=case['d_in'])
    loss = f"{'classifier' if case['loss'] == 'classifier' else 'ae'}_loss_fn"
    jm.loss_fn = getattr(jsimple, loss)(jm)
    tm.loss_fn = getattr(simple, loss)(tm)
    return jm, tm


def _run_both(case, name='eva', microbatches=1, **opt_kw):
    jm, tm = _models(case)
    cls, kw = case['stream']
    jdata = getattr(jsyn, cls)(**kw)
    tdata = getattr(tsyn, cls)(**kw, device='cpu')
    batch = kw['batch']

    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tp = M.params_from_numpy({k: np.asarray(v) for k, v in
                              jkv.flatten_params(jp).items()}, 'cpu')

    jopt, jcap = jmake(name, lr=case['lr'], **(
        dict(opt_kw, kernel_impl='pallas_interpret') if name in RANK_ONE
        else opt_kw))
    taps_fn = (lambda p: jm.make_taps(batch, jcap)) if jcap.needs_taps \
        else None
    jst = jinit(jm, jopt, jcap, jp, jdata.batch_at(0), taps_fn=taps_fn)
    jstep = jax.jit(jstep_fn(jm, jopt, jcap, taps_fn=taps_fn,
                             microbatches=microbatches))

    topt, tcap = make_optimizer(name, lr=case['lr'], **opt_kw)
    tst = init_opt_state(tm, topt, tcap, tp, tdata.batch_at(0), device='cpu')
    tstep = make_train_step(tm, topt, tcap, microbatches=microbatches,
                            device='cpu')

    jl, tl = [], []
    for i in range(case['steps']):
        jp, jst, jmet = jstep(jp, jst, jdata.batch_at(i))
        tp, tst, tmet = tstep(tp, tst, tdata.batch_at(i))
        jl.append(float(jmet['loss']))
        tl.append(float(tmet['loss']))
    return (np.array(jl), jkv.flatten_params(jp), jst), \
        (np.array(tl), M.params_to_numpy(tp), M.state_to_numpy(tst))


def _check(ref, port):
    (jl, jp, jst), (tl, tp, tst) = ref, port
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=1e-6)
    assert jl[-1] < jl[0]
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    jleaves = {k: np.asarray(v) for k, v in tree_leaves_with_path(jst).items()}
    assert set(tst) == set(jleaves)
    for k, want in jleaves.items():
        got = tst[k]
        assert got.shape == want.shape, k
        if np.issubdtype(want.dtype, np.integer) or want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('case', sorted(CASES))
def test_eva_slice_matches_reference(case, fused):
    _check(*_run_both(CASES[case], fused=fused))


def test_eva_microbatches_match_reference():
    case = dict(CASES['mlp'], steps=6)
    _check(*_run_both(case, microbatches=2))


def test_sgd_matches_reference():
    _check(*_run_both(CASES['mlp'], name='sgd'))
