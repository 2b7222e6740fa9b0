"""The refresh of K-FAC's inverses and Shampoo's roots at ``interval=10``:
the port against the reference over 12 steps, every factor dense and with
the sharded factor heads of ``FactorShardConfig(head_policy='shard')``.

The reference skips the recomputation on a step that keeps the old values
(``lax.cond``); so does the port, deciding on the host.  The dense operators
(``precondition._damped_inv``, ``_inv_proot_psd``) run on the refresh steps
0 and 10 and on no other, and the schedule's device counters (``count``,
``since``, ``n_refresh``) advance as the reference's.  Tolerances are those
of ``tests/test_torch_kfac_shampoo.py``, whose docstring gives the reasons:
per-step loss rtol 1e-4 (atol 1e-6); parameters and every float leaf of the
state rtol 1e-4, atol 1e-5, Shampoo's cached roots atol 2e-2; integer
leaves equal.  One addition: Shampoo's momentum traces are held to atol
1e-4.  At ``interval=10`` the roots of step 0 are applied for ten steps;
at step 0 each M_out (d_out > d_in) or M_in still has eigenvalues at
ε_init, whose roots differ between the two frameworks as that docstring
says (up to ~1e-2), and the later gradients do have components in that
span.  The traces differ by up to 3.0e-5 (values up to 0.2), the same
without the skip (every refresh computed and dropped by ``torch.where``);
the parameters stay within rtol 1e-4, atol 1e-5.

Also the key of the kernels' workspace (``kernels/launch.py``): one per
(device, stream), which needs no card to check.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_kfac_shampoo import (ATOL, CASES, RTOL, _atol,  # noqa: E402
                                     _factor, _models)

from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.core import precondition as pre  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.core.transform import tree_leaves_with_path  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import launch  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.schedule import policy as schedpol  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa

INTERVAL, STEPS = 10, 12
REFRESH_STEPS = [0, 10]
CASE = CASES['mlp']
DENSE_OPS = ('_damped_inv', '_inv_proot_psd')
TRACE_ATOL = 1e-4   # Shampoo's momentum traces (see the docstring)


def _port_run(name, shard, on_step=None):
    """12 port steps at ``interval=10``: (losses, params, state).
    ``on_step(i)`` is called before step i."""
    jm, tm = _models(CASE)
    cls, kw = CASE['stream']
    data = getattr(tsyn, cls)(**kw, device='cpu')
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    params = M.params_from_numpy(
        {k: np.asarray(v) for k, v in jkv.flatten_params(jp).items()}, 'cpu')
    opt, cap = make_optimizer(name, lr=CASE['lr'][name], interval=INTERVAL)
    factor = _factor(CASE, name, shard, 'torch')
    taps_fn = (lambda p: tm.make_taps(kw['batch'], cap, device='cpu')) \
        if cap.needs_taps else None
    state = init_opt_state(tm, opt, cap, params, data.batch_at(0),
                           taps_fn=taps_fn, factor=factor, device='cpu')
    step = make_train_step(tm, opt, cap, taps_fn=taps_fn, factor=factor,
                           device='cpu')
    losses = []
    for i in range(STEPS):
        if on_step is not None:
            on_step(i)
        params, state, met = step(params, state, data.batch_at(i))
        losses.append(float(met['loss']))
    return np.array(losses), params, state


def _ref_run(name, shard):
    jm, _ = _models(CASE)
    cls, kw = CASE['stream']
    data = getattr(jsyn, cls)(**kw)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    opt, cap = jmake(name, lr=CASE['lr'][name], interval=INTERVAL)
    factor = _factor(CASE, name, shard, 'jax')
    taps_fn = (lambda p: jm.make_taps(kw['batch'], cap)) \
        if cap.needs_taps else None
    st = jinit(jm, opt, cap, jp, data.batch_at(0), taps_fn=taps_fn,
               factor=factor)
    step = jax.jit(jstep_fn(jm, opt, cap, taps_fn=taps_fn, factor=factor))
    losses = []
    for i in range(STEPS):
        jp, st, met = step(jp, st, data.batch_at(i))
        losses.append(float(met['loss']))
    return np.array(losses), jkv.flatten_params(jp), st


def _sched_leaves(leaves):
    """{field: value} of the schedule's counters in a flattened state."""
    out = {}
    for k, v in leaves.items():
        for field in ('count', 'since', 'n_refresh'):
            if k.endswith(f'sched/{field}'):
                out[k] = np.asarray(v)
    return out


@pytest.mark.parametrize('shard', [False, True], ids=['dense', 'shard'])
@pytest.mark.parametrize('name', ['kfac', 'shampoo'])
def test_interval_matches_reference(name, shard):
    """12 steps at ``interval=10``: losses, parameters and every state leaf
    track the reference; the schedule's counters equal it."""
    jl, jp, jst = _ref_run(name, shard)
    tl, tp, tst = _port_run(name, shard)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=1e-6)
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
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            atol = TRACE_ATOL if name == 'shampoo' and '/trace/' in k \
                else _atol(name, k)
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=atol,
                                       err_msg=k)
    sched = _sched_leaves(got)
    assert len(sched) == 3 and sched == _sched_leaves(want)
    by_field = {k.rsplit('/', 1)[-1]: int(v) for k, v in sched.items()}
    # 12 steps; refreshed at 0 and 10; one step since the last refresh
    assert by_field == {'count': STEPS,
                        'since': STEPS - 1 - REFRESH_STEPS[-1],
                        'n_refresh': len(REFRESH_STEPS)}


@pytest.mark.parametrize('shard', [False, True], ids=['dense', 'shard'])
@pytest.mark.parametrize('name', ['kfac', 'shampoo'])
def test_dense_operators_run_only_on_refresh_steps(name, shard,
                                                   monkeypatch):
    """The dense inverses (K-FAC) and eigh roots (Shampoo), of the dense
    buckets and of the head buckets' dense sides, run on steps 0 and 10 and
    on no other step."""
    step_of = {'now': None}
    ran = []
    for op in DENSE_OPS:
        fn = getattr(pre, op)

        def spy(*args, _fn=fn, **kw):
            ran.append(step_of['now'])
            return _fn(*args, **kw)
        monkeypatch.setattr(pre, op, spy)
    _port_run(name, shard, on_step=lambda i: step_of.update(now=i))
    assert sorted(set(ran)) == REFRESH_STEPS
    # the same operators on both refresh steps
    assert ran.count(REFRESH_STEPS[0]) == ran.count(REFRESH_STEPS[1]) > 0


@pytest.mark.parametrize('k', [1, 3, 10])
def test_on_host_reads_the_flag_unless_every_step_refreshes(k):
    """``every_k(1)`` refreshes on every step without reading the device
    flag; any other interval reads it."""
    pol = schedpol.every_k(k)

    class Flag:
        reads = 0

        def __init__(self, v):
            self.v = v

        def __bool__(self):
            Flag.reads += 1
            return self.v

    st = schedpol.init_state(pol, None, 'cpu')
    for i in range(12):
        refresh, _ = pol.decide(st, None)
        got = schedpol.on_host(pol, Flag(bool(refresh)))
        assert got == (i % k == 0)
        st = schedpol.commit(pol, st, None, refresh, _)
    assert Flag.reads == (0 if k == 1 else 12)


def test_workspace_is_keyed_on_device_and_stream():
    """One workspace per (device, stream handle): two streams of a device
    never share scratch or counters, one stream always finds its own
    again.  Building a Workspace allocates nothing, so no card is needed."""
    keys = [(0, 0x1000), (0, 0x2000), (1, 0x1000)]
    assert not any(k in launch._workspaces for k in keys)
    try:
        made = [launch.workspace(*k) for k in keys]
        assert len({id(ws) for ws in made}) == len(keys)
        for k, ws in zip(keys, made):
            assert launch.workspace(*k) is ws
            assert ws.device == torch.device('cuda', k[0])
            assert (ws.n_f32, ws.n_i32, ws.buffers) == (0, 0, [])
        assert set(keys) <= set(launch._workspaces)
    finally:
        for k in keys:
            launch._workspaces.pop(k, None)
