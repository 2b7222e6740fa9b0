"""The rest of the optimizer set against the reference: FOOF (composed and
fused), M-FAC (m=8), AdamW and Adagrad, from the same weights and batches on
the MLP of ``tests/test_optimizers.py`` (16-32-32-4, ``ClassStream(batch=64,
dim=16, classes=4, spread=1.5, seed=0)``), 25 steps.

Both sides run f32 on the CPU: matmuls, LAPACK inverses and solves in other
summation orders.  Stated tolerances: per-step loss rtol 1e-4 (atol 1e-6);
final parameters and every float leaf of the optimizer state rtol 1e-4,
atol 1e-5, except FOOF's cached inverses (A + γI)^{-1}, held to atol 1e-5
of their largest magnitude: with γ = 0.03 the inverse carries the f32
rounding of A (~1e-7 of its norm) amplified by up to 1/γ, and its largest
entries are near 5 here.  Integer leaves equal.

M-FAC is held differently, and this is why: at λ = 1e-3 its step
(g − Bᵀx)/λ subtracts two nearly equal vectors, so the f32 rounding of
either package is amplified by about ‖g‖²/λ.
Against a float64 step from the same gradient the reference's f32 step is
off by more than 1e-3 of its norm, and the port's by no more
(``test_mfac_f32_step_is_ill_conditioned_in_both_packages``); the two
trajectories' losses drift apart.  So M-FAC is held one step
at a time from the reference's own state at each of its 25 steps: the
parameter change within 5e-3 of its norm, the
history buffer (raw gradients, the reference's leaf order column for
column) within rtol 1e-4, atol 1e-5, and the counters equal; and its first
10 losses within rtol 1e-4.  The port's ``test_optimizer_reduces_loss``
runs over all ten registry names.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.core.registry import optimizer_names as joptimizer_names  # noqa
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.core.registry import make_optimizer, optimizer_names  # noqa
from repro_torch.core.transform import tree_leaves_with_path  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa

RTOL, ATOL = 1e-4, 1e-5
STREAM = dict(batch=64, dim=16, classes=4, spread=1.5, seed=0)
DIMS = [16, 32, 32, 4]
STEPS = 25
# name -> (lr of tests/test_optimizers.py, more options)
CASES = {
    'foof': (0.03, {}),
    'foof_fused': (0.03, {'fused': True}),
    'adamw': (1e-3, {}),
    'adagrad': (0.02, {}),
}


def _ref_params():
    jm = jsimple.MLP(DIMS)
    return JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))


def _ref_run(name, lr, kw, steps=STEPS):
    jm = jsimple.MLP(DIMS)
    jm.loss_fn = jsimple.classifier_loss_fn(jm)
    data = jsyn.ClassStream(**STREAM)
    jp = _ref_params()
    opt, cap = jmake(name, lr=lr, **kw)
    taps_fn = (lambda p: jm.make_taps(STREAM['batch'], cap)) \
        if cap.needs_taps else None
    st = jinit(jm, opt, cap, jp, data.batch_at(0), taps_fn=taps_fn)
    step = jax.jit(jstep_fn(jm, opt, cap, taps_fn=taps_fn))
    losses = []
    for i in range(steps):
        jp, st, met = step(jp, st, data.batch_at(i))
        losses.append(float(met['loss']))
    return np.array(losses), jkv.flatten_params(jp), st


def _port_run(name, lr, kw, steps=STEPS, params=None):
    tm = simple.MLP(DIMS)
    tm.loss_fn = simple.classifier_loss_fn(tm)
    data = tsyn.ClassStream(**STREAM, device='cpu')
    if params is None:
        params = M.params_from_numpy(
            {k: np.asarray(v)
             for k, v in jkv.flatten_params(_ref_params()).items()}, 'cpu')
    opt, cap = make_optimizer(name, lr=lr, **kw)
    st = init_opt_state(tm, opt, cap, params, data.batch_at(0), device='cpu')
    step = make_train_step(tm, opt, cap, device='cpu')
    losses = []
    for i in range(steps):
        params, st, met = step(params, st, data.batch_at(i))
        losses.append(float(met['loss']))
    return np.array(losses), params, st


def test_optimizer_names_match_reference():
    assert optimizer_names() == joptimizer_names()
    assert len(optimizer_names()) == 10


def test_captures_match_reference():
    from repro.core.registry import capture_for as jcapture_for
    from repro_torch.core.registry import capture_for
    for name in optimizer_names():
        want, got = jcapture_for(name), capture_for(name)
        assert (got.a, got.b) == (want.a, want.b), name


@pytest.mark.parametrize('case', sorted(CASES))
def test_matches_reference(case):
    name = case.split('_')[0]
    lr, kw = CASES[case]
    jl, jp, jst = _ref_run(name, lr, kw)
    tl, tp, tst = _port_run(name, lr, kw)
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
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            atol = ATOL * max(1.0, float(np.abs(w).max())) \
                if '/a_inv/' in k else ATOL
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=atol,
                                       err_msg=k)


MFAC_STEP_RTOL = 5e-3


def _to_port(jtree, template):
    """The reference's tree as the port's, leaf by leaf through the
    checkpoint paths (``jax.tree_util.keystr`` on both sides)."""
    from repro_torch.train import checkpoint as ckpt
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    by_path = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
    return ckpt._rebuild(template, lambda path, leaf: torch.from_numpy(
        by_path[path].copy()))


def test_mfac_steps_match_reference_from_its_state():
    kw = {'m': 8}
    jm = jsimple.MLP(DIMS)
    jm.loss_fn = jsimple.classifier_loss_fn(jm)
    jdata = jsyn.ClassStream(**STREAM)
    jp = _ref_params()
    jopt, jcap = jmake('mfac', lr=0.01, **kw)
    jst = jinit(jm, jopt, jcap, jp, jdata.batch_at(0))
    jstep = jax.jit(jstep_fn(jm, jopt, jcap))
    tm = simple.MLP(DIMS)
    tm.loss_fn = simple.classifier_loss_fn(tm)
    data = tsyn.ClassStream(**STREAM, device='cpu')
    opt, cap = make_optimizer('mfac', lr=0.01, **kw)
    params = M.params_from_numpy(
        {k: np.asarray(v) for k, v in jkv.flatten_params(jp).items()}, 'cpu')
    template = {'params': params, 'opt_state': init_opt_state(
        tm, opt, cap, params, data.batch_at(0), device='cpu')}
    step = make_train_step(tm, opt, cap, device='cpu')
    for i in range(STEPS):
        here = _to_port({'params': jp, 'opt_state': jst}, template)
        p1, s1, _ = step(here['params'], here['opt_state'], data.batch_at(i))
        jp, jst, _ = jstep(jp, jst, jdata.batch_at(i))
        want = _to_port({'params': jp, 'opt_state': jst}, template)
        num = den = 0.0
        for k, p0 in here['params'].items():
            dt = p1[k].double() - p0.double()
            dj = want['params'][k].double() - p0.double()
            num += ((dt - dj) ** 2).sum().item()
            den += (dj ** 2).sum().item()
        assert (num / den) ** 0.5 <= MFAC_STEP_RTOL, (i, (num / den) ** 0.5)
        got_s, want_s = s1.inner[0], want['opt_state'].inner[0]
        np.testing.assert_allclose(got_s.buffer.numpy(),
                                   want_s.buffer.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f'step {i}')
        assert int(got_s.filled) == int(want_s.filled) == min(i + 1, 8)
        assert int(got_s.head) == int(want_s.head) == (i + 1) % 8
    jl, _, _ = _ref_run('mfac', 0.01, kw, steps=10)
    tl, _, _ = _port_run('mfac', 0.01, kw, steps=10)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=1e-6)


def test_mfac_f32_step_is_ill_conditioned_in_both_packages(monkeypatch):
    """The reason M-FAC is held one step at a time: from one gradient, the
    reference's f32 step and the port's each lie more than 1e-3 of its norm
    from the same step in float64 (the port's preconditioner run with
    float64 in place of f32), and the port's is no further off than the
    reference's."""
    import importlib

    import jax.numpy as jnp
    from repro_torch.core import mfac
    # the module: repro.core re-exports the optimizer under the same name
    jmfac_mod = importlib.import_module('repro.core.mfac')
    rng = np.random.default_rng(0)
    g = {'fc0/w': (0.3 * rng.normal(size=(16, 32))).astype(np.float32),
         'fc0/b': (0.3 * rng.normal(size=(32,))).astype(np.float32)}

    def port_step():
        gt = {k: torch.from_numpy(v).to(mfac.F32) for k, v in g.items()}
        opt = mfac.mfac_preconditioner(m=8)
        out, _ = opt.update(gt, opt.init(gt))
        return np.concatenate([out[k].double().reshape(-1).numpy()
                               for k in sorted(out)])
    port = port_step()
    monkeypatch.setattr(mfac, 'F32', torch.float64)
    truth = port_step()
    jopt = jmfac_mod.mfac_preconditioner(m=8)
    gj = {'fc0': {'w': jnp.asarray(g['fc0/w']), 'b': jnp.asarray(g['fc0/b'])}}
    out, _ = jopt.update(gj, jopt.init(gj))
    ref = np.concatenate([np.asarray(out['fc0']['b'], np.float64).reshape(-1),
                          np.asarray(out['fc0']['w'], np.float64).reshape(-1)])
    norm = np.linalg.norm(truth)
    port_err = np.linalg.norm(port - truth) / norm
    ref_err = np.linalg.norm(ref - truth) / norm
    assert port_err > 1e-3 and ref_err > 1e-3, (port_err, ref_err)
    assert port_err <= ref_err, (port_err, ref_err)


def test_mfac_buffer_columns_follow_the_reference_leaf_order():
    """After one step the buffer's first row is the raw gradient laid out
    as the reference lays it out (nested dict keys sorted), and the rows
    not yet filled are zero; the old state's buffer is left as it was."""
    from repro_torch.core import mfac
    from repro_torch.core.transform import tree_leaves
    grads = {'b/x': torch.arange(3.0), 'a-c': torch.ones(2),
             'a/w': torch.full((2, 2), 5.0)}
    # nested order: a/w (['a']['w']) before a-c, then b/x
    flat = mfac._flatten_all(grads)
    assert flat.tolist() == [5.0] * 4 + [1.0, 1.0] + [0.0, 1.0, 2.0]
    assert [t.numel() for t in tree_leaves(grads)] == [4, 2, 3]
    opt = mfac.mfac_preconditioner(m=3)
    st0 = opt.init(grads)
    _, st1 = opt.update(grads, st0)
    assert torch.equal(st1.buffer[0], flat)
    assert not st1.buffer[1:].any() and not st0.buffer.any()
    back = mfac._unflatten_all(flat, grads)
    assert list(back) == list(grads)
    for k in grads:
        assert torch.equal(back[k], grads[k]), k


def test_adamw_decay_follows_adam():
    """The decoupled weight decay comes after ``scale_by_adam`` in the
    chain, as in the reference."""
    from repro_torch.core.transform import AdamState, EmptyState
    opt = make_optimizer('adamw', lr=1e-3)[0]
    params = {'w': torch.ones(2, 2)}
    st = opt.init(params)
    assert isinstance(st.inner[0], AdamState)
    assert isinstance(st.inner[1], EmptyState)


@pytest.mark.parametrize('name', optimizer_names())
def test_optimizer_reduces_loss(name):
    """The port's ``tests/test_optimizers.py::test_optimizer_reduces_loss``:
    25 steps from the reference's weights lower the loss."""
    kw = {'m': 8} if name == 'mfac' else {}
    lr = {'adamw': 1e-3, 'adagrad': 0.02, 'mfac': 0.01}.get(name, 0.03)
    losses, _, _ = _port_run(name, lr, kw)
    assert np.isfinite(losses[-1]), name
    assert losses[-1] < losses[0], f'{name}: {losses[0]} -> {losses[-1]}'
