"""The port's exchange layer (``repro_torch.comm``) and ownership maps
against the reference's ``repro.comm`` and ``repro.schedule.ownership``.

* Codecs: encode / decode of f32, bf16 and int8 equal the reference's bit
  for bit on the same numpy inputs (``torch.round`` and ``jnp.round`` both
  round half to even; the clip follows the round), saturation included.
* The int8 (and bf16) mean all-reduce at W = 1 equals the reference's bit
  for bit: without a group against the reference without axes, and over a
  one-rank gloo group against the reference under a one-device
  ``shard_map``.
* The LPT owner maps (row, slice, pod), ``_gather_maps``, the describe
  helpers and every call site's logical bytes equal the reference's as
  integers, on the autoencoder's, qwen2-0.5b's (reduced and full) and the
  toy's bucket plans.
* Four gloo workers (``launch.workers.spawn``): the owned-slice gather
  equals the zero-padded psum exchange atol 0 in f32, outputs and state,
  for all six methods, and the pod exchange over (2, 2) equals it too; the
  raw gather returns f32 and bf16-of-bf16 stacks exactly, int8 within half
  a step of each row's scale; the int8 mean of replicated gradients sits
  within half a quantization step with zero saturation, and of
  rank-dependent ones equals a numpy transcription of the reference's
  op sequence bit for bit; the band partials sum; ``world_and_rank`` is
  (4, rank) in scope and (1, None) outside; W = 4 against the reference's
  one-process run of each method, rtol 1e-4 atol 1e-5 (LAPACK on one slice
  where one process batches a row moves the last ulps).
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dist_cases as cases  # noqa: E402
from repro.comm import codec as jcodec  # noqa: E402
from repro.comm import exchange as jex  # noqa: E402
from repro.core import bucketing as jbucketing  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core.transform import Extras as JExtras  # noqa: E402
from repro.schedule import ownership as jown  # noqa: E402
from repro.schedule.policy import every_k as jevery_k  # noqa: E402
from repro.sharding import compat  # noqa: E402
from repro_torch.comm import codec, exchange, metrics  # noqa: E402
from repro_torch.comm import group as group_mod  # noqa: E402
from repro_torch.core import bucketing  # noqa: E402
from repro_torch.launch import workers  # noqa: E402
from repro_torch.schedule import ownership  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope='module')
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process for the module's tests."""
    store = tmp_path_factory.mktemp('store') / 'store'
    workers.init_workers(device='cpu', rank=0, world=1,
                         init_method=f'file://{store}')
    yield
    workers.shutdown_workers()


@pytest.fixture(scope='module')
def w4():
    """The W = 4 exchange cases, run once for the module."""
    return workers.spawn(cases.comm_cases, 4, device='cpu', timeout=240,
                         threads=1)


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else x)


def _vals(seed, shape=(6, 33)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x.reshape(-1)[:4] = [0.5, 1.5, -2.5, 0.0]   # ties at the int8 grid
    return x


# ---------------------------------------------------------------------------
# Codecs


@pytest.mark.parametrize('name', ['f32', 'identity', 'bf16', 'int8'])
def test_codec_round_trip_matches_reference(name):
    x = _vals(0)
    amax = np.float32(np.abs(x).max())
    if name == 'int8':
        # a scale of exactly 1: the ties .5, 1.5, -2.5 round half to even
        amax = np.float32(127.0)
    c, jc = codec.get_codec(name), jcodec.get_codec(name)
    assert (c.name, c.wire_bits, c.error_feedback, c.passthrough,
            c.has_scale) == (jc.name, jc.wire_bits, jc.error_feedback,
                             jc.passthrough, jc.has_scale)
    p, s, n = c.encode(torch.from_numpy(x), torch.tensor(amax))
    jp, js, jn = jc.encode(jnp.asarray(x), jnp.asarray(amax))
    np.testing.assert_array_equal(_np(p), np.asarray(jp, np.float32))
    assert float(n) == float(jn)
    if s is not None:
        np.testing.assert_array_equal(_np(s), np.asarray(js))
    np.testing.assert_array_equal(_np(c.decode(p, s)),
                                  np.asarray(jc.decode(jp, js)))


def test_int8_saturation_counts_a_stale_max():
    x = _vals(1)
    stale = np.float32(np.abs(x).max() / 2)
    p, s, n = codec.INT8_EF.encode(torch.from_numpy(x), torch.tensor(stale))
    jp, js, jn = jcodec.INT8_EF.encode(jnp.asarray(x), jnp.asarray(stale))
    assert float(n) == float(jn) > 0
    np.testing.assert_array_equal(_np(p), np.asarray(jp, np.float32))
    assert codec.get_codec(None) is codec.F32
    with pytest.raises(KeyError):
        codec.get_codec('fp4')
    err = codec.INT8_EF.init_err({'a': torch.ones(2, 3)})
    assert torch.equal(err['a'], torch.zeros(2, 3))
    assert codec.F32.init_err({'a': torch.ones(2)}) is None


@pytest.mark.parametrize('name', ['int8', 'bf16', 'f32'])
def test_allreduce_mean_leaf_w1_matches_reference(name):
    """No group, no axes: the leaf still round-trips through the codec."""
    g, e = _vals(2), _vals(3) * 1e-3
    mean, new_err, n_sat = exchange.allreduce_mean_leaf(
        torch.from_numpy(g), torch.from_numpy(e), codec=name, scope=None)
    jm, je, jn = jex.allreduce_mean_leaf(jnp.asarray(g), jnp.asarray(e),
                                         codec=name, axes=())
    np.testing.assert_array_equal(_np(mean), np.asarray(jm))
    np.testing.assert_array_equal(_np(new_err), np.asarray(je))
    assert float(n_sat) == float(jn)


def test_allreduce_mean_tree_one_rank_matches_reference(one_rank):
    """Over a one-rank gloo group against the reference under a one-device
    shard_map, run op by op (``jax.disable_jit``: its jitted body contracts
    the residual x - q·s into a fused multiply-add, one rounding fewer):
    int8 with its residual, bf16 and f32, bit for bit."""
    tree_np = {'a': _vals(4, (5, 7)), 'b': _vals(5, (9,))}
    err_np = {k: v * 1e-3 for k, v in tree_np.items()}
    mesh = compat.make_mesh((1,), ('data',))
    for name in ('int8', 'bf16', 'f32'):
        with group_mod.in_scope(None):
            mean, new_err, info = exchange.allreduce_mean_tree(
                {k: torch.from_numpy(v) for k, v in tree_np.items()},
                {k: torch.from_numpy(v) for k, v in err_np.items()},
                codec=name)

        def body(t, e, name=name):
            return jex.allreduce_mean_tree(t, e, codec=name, axes=('data',))

        red = compat.shard_map(body, mesh=mesh, in_specs=(P(), P()),
                               out_specs=(P(), P(), P()), check=False)
        with jax.disable_jit():
            jm, je, jinfo = red(
                {k: jnp.asarray(v) for k, v in tree_np.items()},
                {k: jnp.asarray(v) for k, v in err_np.items()})
        for k in tree_np:
            np.testing.assert_array_equal(_np(mean[k]), np.asarray(jm[k]))
            if jcodec.get_codec(name).error_feedback:
                np.testing.assert_array_equal(_np(new_err[k]),
                                              np.asarray(je[k]))
        assert float(info['saturation']) == float(jinfo['saturation']) == 0


def test_pmean_stats_identity_outside_a_scope():
    tree = {'s': torch.ones(3, 3)}
    for name in (None, 'f32', 'bf16', 'int8'):
        out = exchange.pmean_stats(tree, codec=name)
        assert torch.equal(out['s'], tree['s'])
    assert exchange.pmean_stats(None, codec='int8') is None
    assert exchange.psum_tree(tree) is tree
    assert ownership.world_and_rank() == (1, None)


def test_exchange_config_and_from_extras():
    from repro_torch.core.transform import Extras
    cfg = exchange.ExchangeConfig()
    jcfg = jex.ExchangeConfig()
    assert (cfg.grads, cfg.stats, cfg.codec, cfg.exchange, cfg.topology) == \
        (jcfg.grads, jcfg.stats, jcfg.codec, jcfg.exchange, jcfg.topology)
    with pytest.raises(ValueError):
        exchange.ExchangeConfig(exchange='broadcast')
    with pytest.raises(ValueError):
        exchange.ExchangeConfig(topology='ring')
    assert exchange.from_extras(None) == cfg
    mine = exchange.ExchangeConfig(codec='int8', exchange='psum')
    assert exchange.from_extras(Extras(comm=mine)) is mine


# ---------------------------------------------------------------------------
# Owner maps and byte accounting, integer for integer


def _ae_flat(pkg):
    dims = [784, 1000, 500, 250, 30, 250, 500, 1000, 784]
    shapes = {f'fc{i}/w': (dims[i], dims[i + 1]) for i in range(8)}
    return _plans(shapes, pkg)


def _plans(shapes, pkg):
    if pkg == 'jax':
        return jbucketing.build_plan(
            {p: jax.ShapeDtypeStruct(s, jnp.float32)
             for p, s in shapes.items()})
    return bucketing.build_plan(
        {p: torch.empty(s, device='meta') for p, s in shapes.items()})


def _qwen_shapes(reduced):
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import module as M
    from repro_torch.models.registry import build_model
    cfg = (get_reduced if reduced else get_config)('qwen2-0.5b')
    model = build_model(cfg)
    specs = M.flatten_specs(model.param_specs())
    return {p: tuple(specs[p].shape)
            for p in sorted(set(model.precon_paths()) & set(specs))}


def _ref_qwen_shapes(reduced):
    from repro.configs.registry import get_config, get_reduced
    from repro.models import build_model
    from repro.models import module as JM
    cfg = (get_reduced if reduced else get_config)('qwen2-0.5b')
    model = build_model(cfg)
    specs = JM.flatten_specs(model.param_specs())
    return {p: tuple(specs[p].shape)
            for p in sorted(set(model.precon_paths()) & set(specs))}


PLANS = {
    'toy': lambda: {p: s for p, s in cases.SHAPES.items()},
    'autoencoder': None,
    'qwen2-0.5b reduced': lambda: _qwen_shapes(True),
    'qwen2-0.5b': lambda: _qwen_shapes(False),
}


def _plan_pair(name):
    if name == 'autoencoder':
        return _ae_flat('torch'), _ae_flat('jax')
    shapes = PLANS[name]()
    if name.startswith('qwen'):
        assert shapes == _ref_qwen_shapes(name.endswith('reduced'))
    return _plans(shapes, 'torch'), _plans(shapes, 'jax')


def _same_maps(a, b):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize('name', sorted(PLANS))
def test_owner_maps_equal_reference(name):
    plan, jplan = _plan_pair(name)
    assert [(b.key, b.paths, b.shape, b.stacked) for b in plan.buckets] == \
        [(b.key, b.paths, b.shape, b.stacked) for b in jplan.buckets]
    for sides in ('left', 'both'):
        cost, jcost = ownership.inverse_cost(sides), jown.inverse_cost(sides)
        assert [cost(b) for b in plan.buckets] == \
            [jcost(b) for b in jplan.buckets]
        for world in (1, 2, 3, 4, 8):
            _same_maps(ownership.assign_owners(plan, cost, world),
                       jown.assign_owners(jplan, jcost, world))
            _same_maps(ownership.assign_slice_owners(plan, cost, world),
                       jown.assign_slice_owners(jplan, jcost, world))
            assert ownership.describe_ownership(plan, world, sides) == \
                jown.describe_ownership(jplan, world, sides)
        for pods in ((2, 2), (2, 4), (4, 2)):
            _same_maps(ownership.assign_pod_slice_owners(plan, cost, pods),
                       jown.assign_pod_slice_owners(jplan, jcost, pods))
    for world in (1, 3, 4):
        for thr in (8, 500, 1000, 896):
            assert ownership.describe_subslices(plan, world, thr) == \
                jown.describe_subslices(jplan, world, thr)
        np.testing.assert_array_equal(
            ownership.assign_subslice_owners(1000, world),
            jown.assign_subslice_owners(1000, world))


@pytest.mark.parametrize('owner,world', [
    ((0, 1, 2, 3, 0, 0), 4), ((0, 0), 4), ((1, 0, 1), 2), ((0,), 1),
    ((3, 2, 1, 0, 3, 2, 1), 4)])
def test_gather_maps_equal_reference(owner, world):
    got, want = exchange._gather_maps(owner, world), \
        jex._gather_maps(owner, world)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize('name', sorted(PLANS))
def test_site_bytes_equal_reference(name):
    """Every call site's logical bytes: the gradient and statistics
    all-reduces (f32, bf16, int8), the refresh exchange (psum, and gather
    under each codec) at several W, and the stack specs behind them."""
    plan, jplan = _plan_pair(name)
    for cname in ('f32', 'bf16', 'int8'):
        c, jc = codec.get_codec(cname), jcodec.get_codec(cname)
        grads = {p: torch.empty(s, device='meta')
                 for b in plan.buckets for p in b.paths
                 for s in [b.shape]}
        jgrads = {p: jax.ShapeDtypeStruct(b.shape, jnp.float32)
                  for b in jplan.buckets for p in b.paths}
        assert exchange.tree_payload_bytes(grads, c) == \
            jex.tree_payload_bytes(jgrads, jc)
    for sides in ('left', 'both'):
        stacks = exchange.slice_stack_specs(plan, sides)
        jstacks = jex.slice_stack_specs(jplan, sides)
        assert {k: [tuple(x.shape) for x in v] for k, v in stacks.items()} \
            == {k: [tuple(x.shape) for x in v] for k, v in jstacks.items()}
        cost, jcost = ownership.inverse_cost(sides), jown.inverse_cost(sides)
        for world in (1, 2, 4, 8):
            own = ownership.assign_slice_owners(plan, cost, world)
            jo = jown.assign_slice_owners(jplan, jcost, world)
            assert exchange.refresh_exchange_bytes(
                plan, own, stacks, world, mode='psum') == \
                jex.refresh_exchange_bytes(jplan, jo, jstacks, world,
                                           mode='psum')
            for cname in ('f32', 'bf16', 'int8'):
                assert exchange.refresh_exchange_bytes(
                    plan, own, stacks, world, codec=cname) == \
                    jex.refresh_exchange_bytes(jplan, jo, jstacks, world,
                                               codec=cname)
            for b, jb in zip(plan.buckets, jplan.buckets):
                assert exchange.owned_slice_bytes(
                    stacks[b.key], own[b.key], world, codec.INT8_EF) == \
                    jex.owned_slice_bytes(jstacks[jb.key], jo[jb.key],
                                          world, jcodec.INT8_EF)


def test_psum_partials_records_local_outside_a_scope():
    metrics.reset()
    x = torch.ones(3, 4)
    assert exchange.psum_partials(x, 1, site='factor/t', calls=32) is x
    rec = metrics.snapshot()['factor/t']
    assert rec['mode'] == 'local' and rec['bytes_per_call'] == 48 * 32


def test_metrics_scope_sees_only_its_sites():
    s = metrics.push_scope()
    metrics.record('a/x', bytes_per_call=4, codec='f32', mode='local')
    metrics.pop_scope(s)
    metrics.record('a/y', bytes_per_call=8, codec='f32', mode='local')
    assert set(s.snapshot()) == {'a/x'}
    assert {'a/x', 'a/y'} <= set(metrics.snapshot())


# ---------------------------------------------------------------------------
# Four gloo workers


@pytest.mark.multihost
def test_w4_world_and_rank(w4):
    for r, res in enumerate(w4):
        assert res['world_and_rank_outside'] == (1, None)
        assert res['world_and_rank'] == (4, r)


@pytest.mark.multihost
@pytest.mark.parametrize('method', sorted(cases.MAKERS))
def test_w4_gather_equals_psum_atol0(w4, method):
    """The owned-slice gather and the zero-padded psum, bit for bit in f32
    (outputs and state), on every rank; int8 within 1e-2 of the scale."""
    for res in w4:
        runs = res['methods'][method]
        (o_ps, s_ps), (o_ag, s_ag) = runs['psum'], runs['gather']
        for a, b in zip(o_ag, o_ps):
            for k in a:
                assert torch.equal(a[k], b[k]), (method, k)
        assert list(s_ag) == list(s_ps)
        for k in s_ag:
            assert torch.equal(s_ag[k], s_ps[k]), (method, k)
        o_i8 = runs['int8'][0]
        scale = max(v.abs().max().item() for o in o_ps for v in o.values())
        diff = max((a[k] - b[k]).abs().max().item()
                   for a, b in zip(o_i8, o_ps) for k in a)
        assert diff <= 1e-2 * scale, (method, diff, scale)
    # every rank holds the same values
    for res in w4[1:]:
        for a, b in zip(res['methods'][method]['gather'][0],
                        w4[0]['methods'][method]['gather'][0]):
            for k in a:
                assert torch.equal(a[k], b[k])


def _ref_toy(method, steps):
    """The reference's one-process run of the toy preconditioner."""
    from repro.core.eva import eva_preconditioner
    from repro.core.eva_f import eva_f_preconditioner
    from repro.core.eva_s import eva_s_preconditioner
    from repro.core.foof import foof_preconditioner
    from repro.core.kfac import kfac_preconditioner
    from repro.core.shampoo import shampoo_preconditioner
    makers = {
        'eva': lambda: eva_preconditioner(0.03, 0.9, policy=jevery_k(2)),
        'eva_f': lambda: eva_f_preconditioner(0.03, 0.9,
                                              policy=jevery_k(2)),
        'eva_s': lambda: eva_s_preconditioner(0.03, 0.9,
                                              policy=jevery_k(2)),
        'foof': lambda: foof_preconditioner(0.03, 0.9, policy=jevery_k(2)),
        'kfac': lambda: kfac_preconditioner(0.03, 0.9, policy=jevery_k(2)),
        'shampoo': lambda: shampoo_preconditioner(1e-4,
                                                  policy=jevery_k(2)),
    }
    opt = makers[method]()
    needs = method in cases.NEEDS_STATS

    def grads(t):
        return jkv.unflatten_params({k: jnp.asarray(v) for k, v in
                                     cases.toy_grads(t).items()})

    def stats(t):
        return {k: jkv.LayerStats(**{f: jnp.asarray(x) for f, x in v.items()})
                for k, v in cases.toy_stats(t).items()}

    state = opt.init(grads(0), JExtras(stats=stats(0) if needs else None))
    outs = []
    for t in range(steps):
        out, state = opt.update(grads(t), state, extras=JExtras(
            stats=stats(t) if needs else None))
        outs.append(jkv.flatten_params(out))
    return outs


# Shampoo is held to the reference on the MLP (tests/test_torch_dp.py): on
# this toy its roots (M + 1e-4 I)^{-1/4} of rank-deficient accumulators
# amplify eigh's f32 rounding ~1e4-fold, and even one port process lies
# 0.13 from the reference at step 1
@pytest.mark.multihost
@pytest.mark.parametrize('method', sorted(set(cases.MAKERS) - {'shampoo'}))
def test_w4_matches_reference_one_process(w4, method):
    ref = _ref_toy(method, 3)
    for got, want in zip(w4[0]['methods'][method]['gather'][0], ref):
        for k in want:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.multihost
def test_w4_pod_exchange_equals_psum(w4):
    for res in w4:
        (o_ps, s_ps), (o_pod, s_pod) = res['pod']['psum'], res['pod']['pod']
        for a, b in zip(o_pod, o_ps):
            for k in a:
                assert torch.equal(a[k], b[k]), k
        for k in s_pod:
            assert torch.equal(s_pod[k], s_ps[k]), k


@pytest.mark.multihost
def test_w4_raw_gather(w4):
    for res in w4:
        for name in ('identity', 'bf16'):
            x, got = res['gather'][name]
            assert torch.equal(got, x), name
        x, got = res['gather']['int8']
        scale = x.abs().amax(dim=(1, 2), keepdim=True) / 127.0
        assert bool(((got - x).abs() <= 0.5 * scale + 1e-7).all())


@pytest.mark.multihost
def test_w4_int8_mean(w4):
    """Replicated inputs: within half a step of the value, no saturation.
    Rank-dependent inputs: the reference's op sequence in numpy, bit for
    bit (per leaf: the MAX of the ranks' amax, the half-to-even rounding,
    the int32 sum, the shared scale, the division by 4)."""
    g = cases.toy_grads(7)
    for res in w4:
        assert res['saturation'] == 0.0
        for k, v in g.items():
            scale = np.abs(v).max() / 127.0
            assert np.abs(_np(res['int8_mean'][k]) - v).max() <= \
                0.5 * scale + 1e-7
    ins = [res['int8_ranked_in'] for res in w4]
    for k in g:
        xs = [_np(i[k]) for i in ins]
        amax = np.float32(max(np.abs(x).max() for x in xs))
        scale = np.maximum(amax / np.float32(127.0), np.float32(1e-12))
        qs = [np.clip(np.round(x / scale), -127, 127).astype(np.int32)
              for x in xs]
        total = sum(qs).astype(np.int32)
        want = (total.astype(np.float32) * scale) / np.float32(4.0)
        for res in w4:
            np.testing.assert_array_equal(_np(res['int8_ranked'][k]), want)


@pytest.mark.multihost
def test_w4_partials_and_sites(w4):
    for res in w4:
        assert torch.equal(res['partials'], torch.full((3, 5), 10.0))
    sites = w4[0]['sites']
    assert sites['grads/test']['codec'] == 'int8'
    assert sites['grads/test']['mode'] == 'allreduce'
    refresh = {s for s in sites if s.startswith('refresh/')}
    # the eva family refreshes a snapshot and exchanges nothing
    assert refresh == {'refresh/kfac', 'refresh/foof', 'refresh/shampoo'}
    assert all(sites[s]['mode'] in ('gather', 'gather-pod', 'psum')
               for s in refresh)
    kf = sites['refresh/kfac']
    assert kf['mode'] == 'gather-pod' and kf['pods'] == [2, 2]
    assert kf['ici_bytes'] > 0 and kf['dcn_bytes'] > 0
    assert kf['bytes_per_call'] == kf['ici_bytes'] + kf['dcn_bytes']
    assert sites['factor']['mode'] == 'psum-partial'
