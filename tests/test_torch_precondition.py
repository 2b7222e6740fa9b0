"""The port's bucketing, KV capture and Eva preconditioning against the
reference on the same inputs.

Tolerances (f32): bucket plans and keys equal exactly; gradients and
captured stats to 1e-6 relative (the two frameworks sum in other orders);
preconditioned outputs to 1e-5 on the γ-scaled values; fused aux partials to
rtol 2e-5 / atol 1e-4, as ``tests/test_fused.py``.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bucketing as jbk  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core import precondition as jpre  # noqa: E402
from repro.data.synthetic import ClassStream as JClassStream  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models.simple import MLP as JMLP  # noqa: E402
from repro.models.simple import classifier_loss_fn as jclf  # noqa: E402
from repro.train.step import compute_grads_and_stats as jgrads  # noqa: E402
from repro_torch.core import bucketing as bk  # noqa: E402
from repro_torch.core import kv  # noqa: E402
from repro_torch.core import precondition as pre  # noqa: E402
from repro_torch.data.synthetic import ClassStream  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.simple import MLP, classifier_loss_fn  # noqa: E402
from repro_torch.train.step import compute_grads_and_stats  # noqa: E402

GAMMA, MU = 0.03, 0.9
# one stacked bucket (three 32x32 layers) and three 1-path buckets
SHAPES = {'fc0/w': (16, 32), 'fc1/w': (32, 32), 'fc2/w': (32, 32),
          'fc3/w': (32, 32), 'fc4/w': (32, 4), 'head/w': (4, 16)}


def _tree(seed=0, with_bias=False):
    rng = np.random.default_rng(seed)
    grads, stats = {}, {}
    for p, (d_in, d_out) in SHAPES.items():
        grads[p] = rng.standard_normal((d_in, d_out), dtype=np.float32)
        stats[p] = (rng.standard_normal(d_in, dtype=np.float32),
                    rng.standard_normal(d_out, dtype=np.float32))
    if with_bias:
        grads['fc0/b'] = rng.standard_normal(32, dtype=np.float32)
    jst = {p: jkv.LayerStats(a_mean=jnp.asarray(a), b_mean=jnp.asarray(b))
           for p, (a, b) in stats.items()}
    tst = {p: kv.LayerStats(a_mean=torch.from_numpy(a),
                            b_mean=torch.from_numpy(b))
           for p, (a, b) in stats.items()}
    return ({p: jnp.asarray(g) for p, g in grads.items()}, jst,
            {p: torch.from_numpy(g) for p, g in grads.items()}, tst)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(GAMMA * got.numpy(), GAMMA * np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize('min_size', [None, 2, 5])
def test_bucket_plans_and_keys_equal(min_size):
    rng = np.random.default_rng(1)
    arrays = {p: rng.standard_normal(s).astype(np.float32)
              for p, s in SHAPES.items()}
    arrays['half/w'] = rng.standard_normal((32, 32)).astype(np.float32)
    jflat = {p: jnp.asarray(x) for p, x in arrays.items()}
    jflat['half/w'] = jflat['half/w'].astype(jnp.bfloat16)
    tflat = {p: torch.from_numpy(x) for p, x in arrays.items()}
    tflat['half/w'] = tflat['half/w'].to(torch.bfloat16)
    want = jbk.build_plan(jflat, min_bucket_size=min_size)
    got = bk.build_plan(tflat, min_bucket_size=min_size)
    assert [(b.key, b.paths, b.shape, b.stacked) for b in got.buckets] == \
        [(b.key, b.paths, b.shape, b.stacked) for b in want.buckets]
    assert [bk.dtype_name(b.dtype) for b in got.buckets] == \
        [b.dtype.name for b in want.buckets]
    assert bk.bucket_key((784, 1000), torch.float32) == 'float32_784x1000'


def test_flatten_unflatten_match_reference():
    nested = {'fc0': {'w': 1, 'b': 2}, 'blocks': {'0': {'attn': {'w': 3}}}}
    flat = kv.flatten_params(nested)
    assert flat == jkv.flatten_params(nested)
    assert kv.flatten_params(flat) == flat
    assert kv.unflatten_params(flat) == jkv.unflatten_params(flat) == nested


def test_gather_scatter_round_trip():
    _, _, tg, tst = _tree(2)
    plan = bk.build_plan(tg)
    back = bk.scatter(plan, bk.gather(plan, tg))
    assert all(torch.equal(back[p], tg[p]) for p in tg)
    stacked = bk.gather_tree(plan, tst)
    assert bk.is_bucketed(plan, stacked) and not bk.is_bucketed(plan, tst)
    assert stacked['float32_32x32'].a_mean.shape == (3, 32)


@pytest.mark.parametrize('bucketed_aux', [False, True])
def test_precondition_tree_matches(bucketed_aux):
    jg, jst, tg, tst = _tree(3, with_bias=True)
    jplan = jbk.build_plan({p: jg[p] for p in jst})
    tplan = bk.build_plan({p: tg[p] for p in tst})
    if bucketed_aux:
        jst, tst = jbk.gather_tree(jplan, jst), bk.gather_tree(tplan, tst)
    want = jpre.precondition_tree(jg, jst, 'eva', GAMMA, plan=jplan,
                                  impl='pallas_interpret')
    got = pre.precondition_tree(tg, tst, 'eva', GAMMA, plan=tplan,
                                impl='torch')
    assert set(got) == set(want)
    for p in want:
        _close(got[p], want[p])
    assert torch.equal(got['fc0/b'], tg['fc0/b'])     # passes through


@pytest.mark.parametrize('fold', [False, True])
def test_precondition_tree_fused_matches(fold):
    jg, jst, tg, tst = _tree(4, with_bias=True)
    rng = np.random.default_rng(40)
    trace = {p: rng.standard_normal(g.shape).astype(np.float32)
             for p, g in tg.items() if p != 'fc2/w'}      # one missing: zeros
    want, wpart = jpre.precondition_tree_fused(
        jg, jst, 'eva', GAMMA, trace={p: jnp.asarray(t)
                                      for p, t in trace.items()},
        momentum=MU, fold_momentum=fold, impl='pallas_interpret')
    got, gpart = pre.precondition_tree_fused(
        tg, tst, 'eva', GAMMA, trace={p: torch.from_numpy(t)
                                      for p, t in trace.items()},
        momentum=MU, fold_momentum=fold, impl='torch')
    assert set(got) == set(want) and set(gpart) == set(wpart)
    for p in want:
        _close(got[p], want[p])
        np.testing.assert_allclose(gpart[p].numpy(), np.asarray(wpart[p]),
                                   rtol=2e-5, atol=1e-4)


def test_precondition_rejects_unported_method():
    """Every method of the reference is ported: a name it does not have
    raises, and the fused tree takes the rank-one methods only."""
    _, _, tg, tst = _tree()
    assert set(pre.PORTED_METHODS) == {
        'eva', 'eva_f', 'eva_s', 'foof', 'kfac', 'shampoo', 'foof_cached',
        'kfac_cached', 'shampoo_cached'}
    with pytest.raises(ValueError, match='not ported'):
        pre.precondition_tree(tg, tst, 'newton', GAMMA)
    with pytest.raises(ValueError, match='not ported'):
        pre.precondition_tree_fused(tg, tst, 'foof', GAMMA)


def _both_models(dims):
    jm = JMLP(dims)
    jm.loss_fn = jclf(jm)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tm = MLP(dims)
    tm.loss_fn = classifier_loss_fn(tm)
    tp = M.params_from_numpy({k: np.asarray(v) for k, v in
                              jkv.flatten_params(jp).items()}, 'cpu')
    return jm, jp, tm, tp


def test_grads_stats_and_ema_match_after_one_batch():
    dims = [16, 32, 32, 32, 32, 4]
    jm, jp, tm, tp = _both_models(dims)
    kw = dict(batch=64, dim=16, classes=4, spread=1.5, seed=0)
    jb, tb = JClassStream(**kw).batch_at(0), \
        ClassStream(**kw, device='cpu').batch_at(0)
    jloss, jgr, jstats = jgrads(jm, jp, jb, jkv.EVA_CAPTURE,
                                taps=jm.make_taps(64, jkv.EVA_CAPTURE))
    tloss, tgr, tstats = compute_grads_and_stats(tm, tp, tb, kv.EVA_CAPTURE)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    jgr = jkv.flatten_params(jgr)
    assert set(tgr) == set(jgr) and set(tstats) == set(jstats)
    for p in jgr:
        np.testing.assert_allclose(tgr[p].numpy(), np.asarray(jgr[p]),
                                   rtol=1e-5, atol=1e-6)
    for p in jstats:
        for f in ('a_mean', 'b_mean', 'count'):
            np.testing.assert_allclose(
                getattr(tstats[p], f).numpy(),
                np.asarray(getattr(jstats[p], f)), rtol=1e-5, atol=1e-7)
    # EMA'd, bias-corrected KVs on the bucket-stacked tree
    jplan = jbk.build_plan({p: jgr[p] for p in jstats})
    tplan = bk.build_plan({p: tgr[p] for p in tstats})
    assert [b.key for b in tplan.buckets] == [b.key for b in jplan.buckets]
    jfresh = jbk.gather_tree(jplan, {p: jkv.LayerStats(s.a_mean, s.b_mean)
                                     for p, s in jstats.items()})
    tfresh = bk.gather_tree(tplan, {p: kv.LayerStats(s.a_mean, s.b_mean)
                                    for p, s in tstats.items()})
    jrun = jkv.init_running(jfresh)
    trun = kv.init_running(tfresh)
    for _ in range(2):
        jused, jrun = jkv.update_running(jrun, jfresh, 0.95)
        tused, trun = kv.update_running(trun, tfresh, 0.95)
    assert int(trun.count) == int(jrun.count) == 2
    for key in jfresh:
        for f in ('a_mean', 'b_mean'):
            for t, j in ((tused, jused), (trun.stats, jrun.stats)):
                np.testing.assert_allclose(
                    getattr(t[key], f).numpy(), np.asarray(getattr(j[key], f)),
                    rtol=1e-5, atol=1e-7)
