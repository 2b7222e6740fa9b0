"""The port's spans and counters (``repro_torch/obs/spans.py``) on the CPU.

With tracing off nothing is recorded and a step's outputs are the same bits
as with it on (``make_train_step`` at one and two microbatches, and
``make_phased_step``'s phases composed).  A step records its five phases,
which tile it, with the statistics' ``capture`` spans under 'forward' and
'backward' and, on a remat model, autograd's recompute under 'backward'.  A
``torch.profiler`` session turns the default tracker on, each session in a
session of its own.  The MoE counters equal what ``route`` returned, and
the gather-form counter counts each call on plain tensors.
``device_split`` on hand-made spans and device intervals.  Exact
comparisons throughout: nothing here rounds.
"""
import threading

import pytest

torch = pytest.importorskip('torch')

from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.train.step import (init_opt_state, make_phased_step,  # noqa
                                    make_train_step)

PHASES = ['forward', 'backward', 'update', 'step_metrics', 'apply']
LAYERS = 2           # the reduced qwen3-moe's depth
CAPTURED = 8         # q, k, v, o, the router and three expert stacks a layer


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(remat='none', capacity_factor=1.25):
    cfg = get_reduced('qwen3-moe-30b-a3b').replace(
        remat=remat, capacity_factor=capacity_factor)
    model = build_model(cfg)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device='cpu')
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=gen)
             for k in ('tokens', 'labels')}
    opt, cap = make_optimizer('eva', lr=0.05)
    state = init_opt_state(model, opt, cap, params, batch, device='cpu')
    return model, opt, cap, params, state, batch


def _stepper(kind, model, opt, cap):
    if kind == 'phased':
        grad_fn, update_fn, apply_fn = make_phased_step(model, opt, cap,
                                                        device='cpu')

        def step(params, state, batch):
            loss, grads, stats = grad_fn(params, batch)
            updates, state, metrics = update_fn(grads, stats, loss, state,
                                                params)
            return apply_fn(params, updates), state, metrics
        return step
    return make_train_step(model, opt, cap, microbatches=int(kind[-1]),
                           device='cpu')


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _run(step, params, state, batch, n=2):
    for _ in range(n):
        params, state, metrics = step(params, state, batch)
    return _leaves((params, state, metrics))


@pytest.mark.parametrize('kind, remat', [('mb1', 'dots'), ('mb2', 'none'),
                                         ('phased', 'dots')])
def test_tracing_off_records_nothing_and_leaves_the_bits(kind, remat):
    model, opt, cap, params, state, batch = _setup(remat)
    step = _stepper(kind, model, opt, cap)
    default = spans.default_tracker()
    before = list(default.records)
    assert spans.tracing() is None
    assert spans.span('forward') is spans.span('apply')     # shared no-op
    off = _run(step, params, state, batch)
    assert default.records == before
    tracker = spans.SpanTracker()
    with spans.recording(tracker):
        on = _run(step, params, state, batch)
    assert spans.tracing() is None
    assert default.records == before
    assert len(off) == len(on) > 0
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)
    names = [r['name'] for r in tracker.records]
    assert names.count('update') == names.count('apply') == 2
    assert names.count('forward') == 2 * int(kind[-1] if kind != 'phased'
                                             else 1)


def _by(records, **want):
    return [r for r in records if all(r[k] == v for k, v in want.items())]


def test_one_step_spans_nest_and_tile():
    model, opt, cap, params, state, batch = _setup('dots')
    step = make_train_step(model, opt, cap, device='cpu')
    with spans.recording(spans.SpanTracker()) as tracker:
        step(params, state, batch)
    recs = tracker.resolve()
    top = sorted(_by(recs, depth=0), key=lambda r: r['start_ms'])
    assert [r['name'] for r in top] == PHASES
    assert all(r['parent'] is None for r in top)
    for a, b in zip(top, top[1:]):          # in order, none overlapping
        assert a['end_ms'] <= b['start_ms']
    for r in recs:                          # the CPU's device times: host
        assert (r['start_ms'], r['end_ms']) == (r['host_start_ms'],
                                                r['host_end_ms'])
        assert r['start_ms'] <= r['end_ms']
    # every statistic of the forward, the recompute's under 'recompute'
    # (autograd's, inside 'backward'), finalize_stats under 'backward'
    assert len(_by(recs, name='capture', parent='forward')) == \
        LAYERS * CAPTURED + 1
    assert len(_by(recs, name='recompute', parent='backward')) == LAYERS
    assert len(_by(recs, name='capture', parent='recompute')) == \
        LAYERS * CAPTURED
    assert len(_by(recs, name='capture', parent='backward')) == 1
    assert {r['depth'] for r in _by(recs, parent='recompute')} == {2}
    assert {r['name'] for r in recs} == set(PHASES) | {'capture',
                                                       'recompute'}
    parents = {r['name']: r for r in top}
    for r in recs:
        if r['depth'] == 1:
            p = parents[r['parent']]
            assert p['start_ms'] <= r['start_ms'] <= r['end_ms'] \
                <= p['end_ms']
    assert [r['seq'] for r in recs] == list(range(len(recs)))


def test_span_on_another_thread_nests_under_the_waiting_span():
    """Autograd runs a recompute on its device thread while the thread that
    called backward waits inside its span."""
    tracker = spans.SpanTracker()
    with spans.recording(tracker):
        with spans.span('backward'):
            worker = threading.Thread(target=_open_close, args=('inner',))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    inner = _by(tracker.records, name='inner')
    assert len(inner) == 1
    assert inner[0]['parent'] == 'backward' and inner[0]['depth'] == 1


def _open_close(name):
    with spans.span(name):
        pass


def test_sessions_and_counters():
    tracker = spans.SpanTracker()
    with spans.recording(tracker):
        assert spans.tracing() is tracker
        inner = spans.SpanTracker()
        with spans.recording(inner):           # the innermost records
            with spans.span('a'):
                spans.tracing().count('n', 2)
        assert spans.tracing() is tracker
        with spans.span('b'):
            tracker.count('n', 3)
            tracker.count('n', torch.tensor(4))
    assert [r['name'] for r in inner.records] == ['a']
    assert [r['name'] for r in tracker.records] == ['b']
    assert inner.total('n') == 2 and tracker.total('n') == 7
    assert tracker.total('absent') is None
    with spans.recording(tracker):              # a new session
        pass
    assert tracker.records == [] and tracker.counters == {}


def test_profiler_session_turns_the_default_tracker_on():
    from torch.profiler import ProfilerActivity, profile
    model, opt, cap, params, state, batch = _setup()
    step = make_train_step(model, opt, cap, device='cpu')
    default = spans.default_tracker()
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.tracing() is default
        mine = spans.SpanTracker()
        with spans.recording(mine):             # an installed tracker wins
            assert spans.tracing() is mine
        assert spans.tracing() is default
        step(params, state, batch)
    assert spans.tracing() is None
    first = default.resolve()
    assert sorted(r['name'] for r in first if r['depth'] == 0) == \
        sorted(PHASES)
    assert default.total('moe.assignments/moe') == \
        LAYERS * 4 * 16 * 2                     # tokens x top-k a layer
    step(params, state, batch)                  # off: the session stays
    assert default.records is first
    with profile(activities=[ProfilerActivity.CPU]):
        pass
    assert default.records == [] and default.counters == {}
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, state, batch)
        step(params, state, batch)
    assert [r['name'] for r in default.records if r['depth'] == 0] == \
        PHASES * 2


@pytest.mark.parametrize('remat, grad', [('none', False), ('dots', True)])
def test_moe_counters_equal_route(monkeypatch, remat, grad):
    model, opt, cap, params, state, batch = _setup(remat,
                                                   capacity_factor=0.5)
    seen = []
    route = moe.route

    def spy(*args):
        out = route(*args)
        seen.append(out[3])
        return out
    monkeypatch.setattr(moe, 'route', spy)
    step = make_train_step(model, opt, cap, device='cpu')
    with spans.recording(spans.SpanTracker()) as tracker:
        if grad:
            step(params, state, batch)
        else:
            with torch.no_grad():
                model.loss_fn(params, None, batch, None)
    # one route a MoE layer, and again in each layer's recompute
    assert len(seen) == LAYERS * (2 if grad else 1)
    assert tracker.counters['moe.assignments/moe'] == \
        [ok.numel() for ok in seen]
    dropped = [int(v) for v in tracker.counters['moe.dropped/moe']]
    assert dropped == [int((~ok).sum()) for ok in seen]
    assert sum(dropped) > 0
    assert tracker.total('moe.dropped/moe') == sum(dropped)
    assert set(tracker.counters) == {'moe.assignments/moe',
                                     'moe.dropped/moe',
                                     'moe.gather_form/moe'}


@pytest.mark.parametrize('remat, grad, plain', [
    ('none', False, True), ('dots', True, True), ('dots', True, False)])
def test_moe_gather_form_counter(monkeypatch, remat, grad, plain):
    """``moe.gather_form/<path>`` counts 1 for each ``moe_apply`` call on
    plain tensors, call for call with ``moe.assignments/<path>`` (the
    recompute's calls too), and nothing on the advanced-index path."""
    model, opt, cap, params, state, batch = _setup(remat)
    if not plain:
        monkeypatch.setattr(moe, '_plain', lambda *ts: False)
    step = make_train_step(model, opt, cap, device='cpu')
    with spans.recording(spans.SpanTracker()) as tracker:
        if grad:
            step(params, state, batch)
        else:
            with torch.no_grad():
                model.loss_fn(params, None, batch, None)
    calls = len(tracker.counters['moe.assignments/moe'])
    assert calls == LAYERS * (2 if grad else 1)
    if plain:
        assert tracker.counters['moe.gather_form/moe'] == [1] * calls
        assert tracker.total('moe.gather_form/moe') == calls
    else:
        assert 'moe.gather_form/moe' not in tracker.counters


def _rec(name, start, end, depth=0, parent=None):
    return {'name': name, 'start_ms': start, 'end_ms': end, 'depth': depth,
            'parent': parent}


def _split_case(offset_us, scale):
    """Spans on one clock (ms); the device intervals on another, µs,
    ``offset_us`` later and ``scale`` times slower."""
    recs = [_rec('capture', 2.0, 4.0, 1, 'forward'),
            _rec('forward', 0.0, 10.0), _rec('backward', 10.0, 30.0),
            _rec('apply', 30.0, 35.0), _rec('forward', 40.0, 45.0),
            _rec('apply', 45.0, 50.0)]
    ms = [(0.0, 8.0), (3.0, 3.5), (12.0, 29.0), (30.0, 35.0), (41.0, 44.0),
          (44.5, 50.0)]

    def at(t):
        return offset_us + t * 1e3 * scale
    return recs, [(f'k{i}', at(s), at(e)) for i, (s, e) in enumerate(ms)]


@pytest.mark.parametrize('offset_us, scale', [(0.0, 1.0), (1.7e12, 1.0),
                                              (5e9, 1.0001)])
def test_device_split(offset_us, scale):
    recs, kernels = _split_case(offset_us, scale)
    got = spans.device_split(recs, kernels)
    assert got.scale == pytest.approx(scale, rel=1e-12)
    want = {'forward': (15.0, 2.0 + 1.5, 2), 'backward': (20.0, 3.0, 1),
            'apply': (10.0, 0.0, 2), 'capture': (2.0, 0.0, 1)}
    assert set(got.by_key) == set(want)
    for name, (device_ms, idle_ms, n) in want.items():
        g = got.by_key[name]
        assert g['spans'] == n
        assert g['device_ms'] == pytest.approx(device_ms * scale, abs=1e-6)
        assert g['idle_ms'] == pytest.approx(idle_ms * scale, abs=1e-6)
    assert got.kernel_ms == pytest.approx(38.5 * scale, abs=1e-6)
    assert got.outside_ms == pytest.approx(0.0, abs=1e-6)
    # grouped by a key, spans left out by None
    only = spans.device_split(
        recs, kernels, key=lambda r: 'fwd' if r['name'] == 'forward'
        else None)
    assert set(only.by_key) == {'fwd'}


def test_device_split_outside_and_empty():
    recs, kernels = _split_case(100.0, 1.0)
    # the second step's forward not recorded: its kernel lies outside
    part = [r for r in recs if r['start_ms'] != 40.0]
    got = spans.device_split(part, kernels)
    assert got.outside_ms == pytest.approx(3.5, abs=1e-6)
    assert spans.device_split([], kernels).by_key == {}
    assert spans.device_split(recs, []).by_key == {}
    unresolved = [{k: v for k, v in r.items() if k != 'start_ms'}
                  for r in recs]
    assert spans.device_split(unresolved, kernels).by_key == {}
