"""The port's sharded-factor policies (``repro_torch.core.factor_sharded``):
the reference's contracts (``tests/test_factor_sharded.py``) restated on the
same toy — ``blk/w`` (8, 6) and ``head/w`` (8, 40) at threshold 32, whose
head trips its 40-wide out side only — and each policy's output and state
against the JAX package.

Within the port: 'dense' (and an untripped threshold) is the legacy path
bit for bit, outputs and state; 'exclude' changes the head only; 'shard'
matches the dense inverse within the iterative tolerance of the reference's
test (CG at 60 iterations within 1e-5, the binomial series at 600 within
1e-4), with the dense bucket bit-exact.  Port against JAX (both f32 on the
CPU, LAPACK inverses and eigh on either side, other summation orders):
outputs and every float state leaf within rtol 1e-4, atol 1e-5, as
``tests/test_torch_train.py``; integer leaves equal.
"""
import importlib

import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import factor_sharded as jfsh  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core.transform import Extras as JExtras  # noqa: E402
from repro_torch.core import bucketing  # noqa: E402
from repro_torch.core import factor_sharded as fsh  # noqa: E402
from repro_torch.core import kv as kvlib  # noqa: E402
from repro_torch.core.factor_sharded import FactorShardConfig  # noqa: E402
from repro_torch.core.kfac import kfac_preconditioner  # noqa: E402
from repro_torch.core.shampoo import shampoo_preconditioner  # noqa: E402
from repro_torch.core.transform import Extras  # noqa: E402
from repro_torch.core.transform import tree_leaves_with_path  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.schedule import ownership  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
PATHS = {'blk/w': (8, 6), 'head/w': (8, 40)}


@pytest.fixture(autouse=True)
def _no_launches():
    """On CPU tensors the solve takes the plain band product."""
    launches.reset()
    yield
    assert launches.snapshot() == {k: 0 for k in launches.COUNTS}


# ---------------------------------------------------------------------------
# Config + plan split


def test_config_validation():
    assert FactorShardConfig().head_policy == 'dense'
    assert FactorShardConfig().impl == 'auto'
    for bad in (dict(head_policy='drop'), dict(solver='chebyshev'),
                dict(shard_threshold=1), dict(solve_iters=0),
                dict(impl='pallas')):
        with pytest.raises(ValueError):
            FactorShardConfig(**bad)
    assert fsh.from_extras(None) == FactorShardConfig()
    assert fsh.from_extras(Extras()) == FactorShardConfig()
    cfg = FactorShardConfig(head_policy='shard', shard_threshold=128)
    assert fsh.from_extras(Extras(factor=cfg)) is cfg
    kw = fsh.from_extras(Extras(factor={'head_policy': 'exclude'}))
    assert kw.head_policy == 'exclude'


def _toy_plan():
    return bucketing.build_plan({'blk/w': torch.zeros(8, 6),
                                 'head/w': torch.zeros(8, 40)})


def test_split_plan_identity_when_nothing_trips():
    plan = _toy_plan()
    for cfg in (FactorShardConfig(),
                FactorShardConfig(head_policy='shard', shard_threshold=64)):
        dense, pol = fsh.split_plan(plan, cfg)
        assert dense is plan and pol == {}


def test_split_plan_trips_per_side():
    plan = _toy_plan()
    dense, pol = fsh.split_plan(
        plan, FactorShardConfig(head_policy='shard', shard_threshold=32))
    assert not ({b.key for b in dense.buckets} & set(pol))
    assert pol == {'float32_8x40': ('dense', 'shard')}


def test_ownership_helpers():
    assert ownership.factor_block(40, 4) == 10
    assert ownership.factor_block(41, 4) == 11
    (head,) = [b for b in _toy_plan().buckets if b.key == 'float32_8x40']
    assert ownership.subslice_trips(head, 32) == (False, True)
    assert ownership.lead_size(head) == 1
    assert ownership.inverse_cost('both')(head) == 8.0 ** 3 + 40.0 ** 3
    assert ownership.world_and_rank() == (1, None)
    with pytest.raises(ValueError):
        ownership.inverse_cost('right')


# ---------------------------------------------------------------------------
# The optimizer on the toy, in the port and in the reference


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {p: rng.normal(size=s).astype(np.float32)
            for p, s in PATHS.items()}


def _factors(seed=10):
    rng = np.random.default_rng(seed)

    def psd(d):
        m = rng.normal(size=(d, d))
        return (m @ m.T / d + 0.5 * np.eye(d)).astype(np.float32)

    return {p: (psd(s[0]), psd(s[1])) for p, s in PATHS.items()}


def _run(method, factor, steps=3):
    """``steps`` updates of the port's preconditioner on fixed grads and
    factors: (flat output as numpy, state)."""
    opt = (kfac_preconditioner if method == 'kfac'
           else shampoo_preconditioner)(gamma=0.5, interval=1)
    params = {p: torch.from_numpy(v) for p, v in _arrays(0).items()}
    grads = {p: torch.from_numpy(v) for p, v in _arrays(1).items()}
    stats = {p: kvlib.LayerStats(a_outer=torch.from_numpy(a),
                                 b_outer=torch.from_numpy(b))
             for p, (a, b) in _factors().items()}
    ex = Extras(stats=stats, factor=factor)
    state = opt.init(params, ex)
    out = None
    for _ in range(steps):
        out, state = opt.update(grads, state, params=params, extras=ex)
    return {p: v.numpy() for p, v in kvlib.flatten_params(out).items()}, state


def _jrun(method, factor, steps=3):
    mod = importlib.import_module(f'repro.core.{method}')
    opt = getattr(mod, f'{method}_preconditioner')(gamma=0.5, interval=1)
    params = {p: jnp.asarray(v) for p, v in _arrays(0).items()}
    grads = {p: jnp.asarray(v) for p, v in _arrays(1).items()}
    stats = {p: jkv.LayerStats(a_outer=jnp.asarray(a),
                               b_outer=jnp.asarray(b))
             for p, (a, b) in _factors().items()}
    ex = JExtras(stats=stats, factor=factor)
    state = opt.init(params, ex)
    out = None
    for _ in range(steps):
        out, state = opt.update(grads, state, params=params, extras=ex)
    return {p: np.asarray(v) for p, v in jkv.flatten_params(out).items()}, \
        state


def _md(a, b, p):
    return float(np.max(np.abs(np.asarray(a[p], np.float64)
                               - np.asarray(b[p], np.float64))))


@pytest.mark.parametrize('method', ['kfac', 'shampoo'])
def test_dense_policy_is_legacy_bit_exact(method):
    legacy_out, legacy_st = _run(method, None)
    for cfg in (FactorShardConfig(head_policy='dense', shard_threshold=32),
                FactorShardConfig(head_policy='shard', shard_threshold=64)):
        out, st = _run(method, cfg)
        for p in legacy_out:
            assert _md(legacy_out, out, p) == 0.0, p
        la, da = M.state_to_numpy(legacy_st), M.state_to_numpy(st)
        assert set(la) == set(da)
        for k in la:
            np.testing.assert_array_equal(la[k], da[k], err_msg=k)
        assert st.head is None


def test_exclude_touches_only_head_path():
    legacy, _ = _run('kfac', None)
    excl, st = _run('kfac', FactorShardConfig(head_policy='exclude',
                                              shard_threshold=32))
    assert _md(excl, legacy, 'blk/w') == 0.0
    assert _md(excl, legacy, 'head/w') > 0.0
    entry = st.head.buckets['float32_8x40']
    assert entry['inv_out'] == () and entry['inv_in'].shape == (1, 8, 8)


def test_shard_cg_matches_dense_within_tolerance():
    legacy, st = _run('kfac', None)
    shard, st_shard = _run('kfac', FactorShardConfig(
        head_policy='shard', shard_threshold=32, solver='cg',
        solve_iters=60))
    assert _md(shard, legacy, 'blk/w') == 0.0
    assert _md(shard, legacy, 'head/w') < 1e-5
    m = fsh.step_metrics(st_shard)
    assert set(m) == set(fsh.METRIC_FIELDS)
    assert int(m['factor_solve_iters']) == 60
    assert float(m['factor_shard_bytes']) == 4.0 * 8 * 40 * 60
    assert fsh.step_metrics(st) == {}
    assert fsh.head_states(st_shard) == [st_shard.head]


def test_shard_binomial_matches_shampoo_root():
    legacy, _ = _run('shampoo', None)
    shard, _ = _run('shampoo', FactorShardConfig(
        head_policy='shard', shard_threshold=32, solver='binomial',
        solve_iters=600))
    assert _md(shard, legacy, 'blk/w') == 0.0
    assert _md(shard, legacy, 'head/w') < 1e-4


POLICY_CASES = {
    'legacy': None,
    'dense': dict(head_policy='dense', shard_threshold=32),
    'exclude': dict(head_policy='exclude', shard_threshold=32),
    'shard_cg': dict(head_policy='shard', shard_threshold=32, solver='cg',
                     solve_iters=20),
    'shard_binomial': dict(head_policy='shard', shard_threshold=32,
                           solver='binomial', solve_iters=40),
}


def _state_leaves(state):
    return {k: np.asarray(v) for k, v in tree_leaves_with_path(state).items()}


@pytest.mark.parametrize('case', sorted(POLICY_CASES))
@pytest.mark.parametrize('method', ['kfac', 'shampoo'])
def test_policy_matches_reference(method, case):
    kw = POLICY_CASES[case]
    out, st = _run(method, None if kw is None else FactorShardConfig(**kw))
    jout, jst = _jrun(method, None if kw is None
                      else jfsh.FactorShardConfig(**kw))
    assert set(out) == set(jout)
    for p in jout:
        np.testing.assert_allclose(out[p], jout[p], rtol=RTOL, atol=ATOL,
                                   err_msg=p)
    got, want = M.state_to_numpy(st), _state_leaves(jst)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_excluded_and_sharded_sides_have_no_leaves():
    """A side that is () in the reference's HeadState is () in the port's
    and leaves no entry in the flattened state of either."""
    _, st = _run('kfac', FactorShardConfig(**POLICY_CASES['shard_cg']))
    _, jst = _jrun('kfac', jfsh.FactorShardConfig(**POLICY_CASES['shard_cg']))
    assert st.head.buckets['float32_8x40']['inv_out'] == ()
    assert jst.head.buckets['float32_8x40']['inv_out'] == ()
    names = set(M.state_to_numpy(st))
    assert 'head/buckets/float32_8x40/inv_in' in names
    assert not any(k.endswith('inv_out') for k in names)
    assert names == set(_state_leaves(jst))
