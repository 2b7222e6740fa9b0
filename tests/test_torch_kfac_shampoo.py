"""K-FAC and Shampoo training steps of the port against the reference, from
the same weights and batches: composed and fused, with every factor dense
and with the sharded factor heads of ``FactorShardConfig(head_policy=
'shard')`` (CG for K-FAC, the binomial series for Shampoo).

Both sides run f32 on the CPU: matmuls, LAPACK inverses and eigh in other
summation orders, amplified a little by each second-order step.  Stated
tolerances: per-step loss rtol 1e-4 (atol 1e-6); final parameters and every
float leaf of the optimizer state rtol 1e-4, atol 1e-5, except Shampoo's
cached roots (M + γI)^{-1/4} and its head's dense-side roots, held to atol
2e-2.  A root moves by (1/4)(λ+γ)^{-5/4} per unit change of an eigenvalue
λ; the classifier's last layer has a null direction (softmax gradients sum
to zero over the classes), so its M_out keeps an eigenvalue at ε_init =
1e-6, and an f32 rounding of M (~1e-7 of its norm) moves that root by up
to ~1e-2 on values near 3.  The gradient has no component along that
direction, so the parameters, held to 1e-4, do not see it.  Integer leaves
equal.  Within the port, the same seed gives the same trajectory bit for
bit, and a run stopped and resumed from its state continues it exactly.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import factor_sharded as jfsh  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.core import factor_sharded as fsh  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.core.transform import tree_leaves_with_path  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.schedule import runtime as schedrt  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa

RTOL, ATOL = 1e-4, 1e-5
ROOT_ATOL = 2e-2   # Shampoo's cached roots (see the docstring)

CASES = {
    # threshold 32 trips fc0's out side, both sides of fc1 and fc2's in side
    'mlp': dict(dims=[16, 32, 32, 4], loss='classifier', steps=25,
                stream=('ClassStream', dict(batch=64, dim=16, classes=4,
                                            spread=1.5, seed=0)),
                threshold=32, lr={'kfac': 0.03, 'shampoo': 0.03}),
    # threshold 64 trips both sides of fc0 and fc5, fc1's in, fc4's out
    'autoencoder': dict(hidden=(64, 32, 8, 32, 64), d_in=64, loss='ae',
                        steps=10, stream=('AEStream', dict(batch=32, side=8)),
                        threshold=64, lr={'kfac': 0.15, 'shampoo': 0.3}),
}
SOLVER = {'kfac': 'cg', 'shampoo': 'binomial'}


@pytest.fixture(autouse=True)
def _no_launches():
    """On CPU tensors the sharded solve takes the plain band product."""
    launches.reset()
    yield
    assert launches.snapshot() == {k: 0 for k in launches.COUNTS}


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


def _factor(case, name, shard, pkg):
    if not shard:
        return None
    cls = (jfsh if pkg == 'jax' else fsh).FactorShardConfig
    return cls(head_policy='shard', shard_threshold=case['threshold'],
               solver=SOLVER[name], solve_iters=32)


def _port_run(case, name, fused, shard, steps=None, state=None,
              params=None, start=0):
    """The port's run: (losses, params, state).  ``state``/``params``
    resume a run at batch ``start``."""
    _, tm = _models(case)
    cls, kw = case['stream']
    data = getattr(tsyn, cls)(**kw, device='cpu')
    if params is None:
        jm = _models(case)[0]
        jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
        params = M.params_from_numpy(
            {k: np.asarray(v) for k, v in jkv.flatten_params(jp).items()},
            'cpu')
    opt, cap = make_optimizer(name, lr=case['lr'][name], fused=fused)
    factor = _factor(case, name, shard, 'torch')
    # the reference's one-argument taps_fn form; the port's default taps
    # (from the batch's rows) are the same
    taps_fn = (lambda p: tm.make_taps(kw['batch'], cap, device='cpu')) \
        if cap.needs_taps else None
    if state is None:
        state = init_opt_state(tm, opt, cap, params, data.batch_at(0),
                               taps_fn=taps_fn, factor=factor, device='cpu')
    step = make_train_step(tm, opt, cap, taps_fn=taps_fn, factor=factor,
                           device='cpu')
    losses = []
    for i in range(start, start + (steps or case['steps'])):
        params, state, met = step(params, state, data.batch_at(i))
        losses.append(float(met['loss']))
        if shard:
            assert set(met) == ({'loss', 'grad_norm'} | set(fsh.METRIC_FIELDS)
                                | set(schedrt.METRIC_FIELDS))
    return np.array(losses), params, state


def _ref_run(case, name, fused, shard):
    jm, _ = _models(case)
    cls, kw = case['stream']
    data = getattr(jsyn, cls)(**kw)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    opt, cap = jmake(name, lr=case['lr'][name], fused=fused)
    factor = _factor(case, name, shard, 'jax')
    taps_fn = (lambda p: jm.make_taps(kw['batch'], cap)) \
        if cap.needs_taps else None
    st = jinit(jm, opt, cap, jp, data.batch_at(0), taps_fn=taps_fn,
               factor=factor)
    step = jax.jit(jstep_fn(jm, opt, cap, taps_fn=taps_fn, factor=factor))
    losses = []
    for i in range(case['steps']):
        jp, st, met = step(jp, st, data.batch_at(i))
        losses.append(float(met['loss']))
    return np.array(losses), jkv.flatten_params(jp), st


def _atol(name, key):
    root = name == 'shampoo' and ('/p_in/' in key or '/p_out/' in key
                                  or '/inv_in' in key or '/inv_out' in key)
    return ROOT_ATOL if root else ATOL


@pytest.mark.parametrize('shard', [False, True], ids=['dense', 'shard'])
@pytest.mark.parametrize('fused', [False, True], ids=['composed', 'fused'])
@pytest.mark.parametrize('name', ['kfac', 'shampoo'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_matches_reference(case, name, fused, shard):
    c = CASES[case]
    jl, jp, jst = _ref_run(c, name, fused, shard)
    tl, tp, tst = _port_run(c, name, fused, shard)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=1e-6)
    assert jl[-1] < jl[0]
    tp = M.params_to_numpy(tp)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    want = {k: np.asarray(v) for k, v in tree_leaves_with_path(jst).items()}
    got = M.state_to_numpy(tst)
    assert set(got) == set(want)
    assert any('/head/' in k for k in got) == shard
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                       atol=_atol(name, k), err_msg=k)


@pytest.mark.parametrize('name', ['kfac', 'shampoo'])
def test_same_seed_same_trajectory_and_exact_resume(name):
    """Two runs from one seed agree bit for bit; a run stopped after 4 steps
    and continued from its parameters and state gives the same last 4
    steps."""
    c = dict(CASES['mlp'], steps=8)
    l1, p1, s1 = _port_run(c, name, True, True)
    l2, p2, s2 = _port_run(c, name, True, True)
    np.testing.assert_array_equal(l1, l2)
    la, pa, sa = _port_run(c, name, True, True, steps=4)
    lb, pb, sb = _port_run(c, name, True, True, steps=4, state=sa,
                           params=pa, start=4)
    np.testing.assert_array_equal(np.concatenate([la, lb]), l1)
    for a, b in ((M.params_to_numpy(p1), M.params_to_numpy(pb)),
                 (M.state_to_numpy(s1), M.state_to_numpy(sb)),
                 (M.state_to_numpy(s1), M.state_to_numpy(s2))):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_default_taps_follow_the_batch():
    """Without a taps_fn the port sizes K-FAC's full taps from the batch it
    is handed (the reference asks for a taps_fn): the same step as a
    two-parameter taps_fn and as ``kv.make_full_taps``."""
    from repro_torch.core import kv as kvlib
    c = CASES['mlp']
    _, tm = _models(c)
    cls, kw = c['stream']
    data = getattr(tsyn, cls)(**kw, device='cpu')
    params = M.init_params(tm.param_specs(), torch.Generator().manual_seed(0),
                           device='cpu')
    opt, cap = make_optimizer('kfac', lr=0.03)
    taps_fn = lambda p, batch: tm.make_taps(  # noqa: E731
        batch['x'].shape[0], cap, device='cpu')
    full = lambda p: kvlib.make_full_taps(  # noqa: E731
        p, tm.precon_paths(), (kw['batch'],))
    outs = []
    for fn in (None, taps_fn, full):
        st = init_opt_state(tm, opt, cap, params, data.batch_at(0),
                            taps_fn=fn, device='cpu')
        step = make_train_step(tm, opt, cap, taps_fn=fn, device='cpu')
        outs.append(step(params, st, data.batch_at(0)))
    for other in outs[1:]:
        for k, v in outs[0][0].items():
            assert torch.equal(v, other[0][k]), k


@pytest.mark.parametrize('method', ['kfac', 'shampoo', 'kfac_cached',
                                    'shampoo_cached', 'foof', 'foof_cached'])
def test_precondition_tree_explicit_methods_match_reference(method):
    """``precondition_tree``'s explicit-inverse branches (K-FAC, Shampoo and
    FOOF, direct and cached) on a stacked bucket
    (three 6x5 leaves) and a bucket of one (4x7), against the reference:
    rtol 1e-4, atol 1e-5."""
    from repro.core import precondition as jpre
    from repro_torch.core import kv as kvlib
    from repro_torch.core import precondition as pre
    rng = np.random.default_rng(3)
    shapes = {'a/w': (6, 5), 'b/w': (6, 5), 'c/w': (6, 5), 'd/w': (4, 7)}

    def psd(d):
        x = rng.normal(size=(d, d))
        return (x @ x.T / d + 0.3 * np.eye(d)).astype(np.float32)

    grads = {p: rng.normal(size=s).astype(np.float32)
             for p, s in shapes.items()}
    facs = {p: (psd(s[0]), psd(s[1])) for p, s in shapes.items()}
    want = jpre.precondition_tree(
        {p: jax.numpy.asarray(g) for p, g in grads.items()},
        {p: jkv.LayerStats(a_outer=jax.numpy.asarray(a),
                           b_outer=jax.numpy.asarray(b))
         for p, (a, b) in facs.items()}, method, 0.1)
    got = pre.precondition_tree(
        {p: torch.from_numpy(g) for p, g in grads.items()},
        {p: kvlib.LayerStats(a_outer=torch.from_numpy(a),
                             b_outer=torch.from_numpy(b))
         for p, (a, b) in facs.items()}, method, 0.1)
    assert set(got) == set(want)
    for p in want:
        np.testing.assert_allclose(got[p].numpy(), np.asarray(want[p]),
                                   rtol=RTOL, atol=ATOL, err_msg=p)
