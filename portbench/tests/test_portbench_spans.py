"""The readers of the program's spans and counters (``harness/phases.py``
and the metrics that use it) on a made-up traced run: two steps of the
five phases with their captures and the MoE counters in the program's
default tracker, against device intervals on a profiler's clock.  Each
reader gives None where the program recorded nothing, and where it has no
such tracker at all."""
import pytest

from portbench.harness import manifest
from portbench.harness.bench import TraceContext
from portbench.harness.trace import Profile
from portbench_cpu import ROOT  # noqa: F401  (puts src/ on the path)
from repro_torch.obs import spans

READERS = ('forward_ms', 'backward_ms', 'update_ms', 'step_metrics_ms',
           'apply_ms', 'capture_ms', 'idle_in_step_ms', 'moe_drop_share')
OFFSET_US = 3.2e12          # the profiler's clock, far from the events'


def _rec(name, start, end, depth=0, parent=None):
    return {'name': name, 'start_ms': start, 'end_ms': end, 'depth': depth,
            'parent': parent}


def _step(t):
    """One step from ``t`` ms: its spans and its kernels (ms)."""
    recs = [_rec('forward', t, t + 10), _rec('capture', t + 2, t + 3, 1,
                                             'forward'),
            _rec('backward', t + 10, t + 30),
            _rec('recompute', t + 12, t + 16, 1, 'backward'),
            _rec('capture', t + 13, t + 14, 2, 'recompute'),
            _rec('capture', t + 28, t + 29, 1, 'backward'),
            _rec('update', t + 30, t + 36), _rec('step_metrics', t + 36,
                                                 t + 38),
            _rec('apply', t + 38, t + 40)]
    kernels = [(t, t + 9), (t + 10, t + 29.5), (t + 30, t + 36),
               (t + 36.5, t + 38), (t + 38, t + 40)]
    return recs, kernels


@pytest.fixture
def default():
    tracker = spans.default_tracker()
    tracker.begin()
    yield tracker
    tracker.begin()


def _ctx(kernels_ms, steps=2):
    kernels = [('k', OFFSET_US + s * 1e3, OFFSET_US + e * 1e3)
               for s, e in kernels_ms]
    profile = Profile(steps=steps, window_s=0.1, busy_s=0.0, kernels=kernels,
                      device_ops=[], idle_gaps=[])
    return TraceContext(cell=None, ref_model=None, peaks=None, grad_s=[],
                        opt_s=[], profile=profile)


def _read(ctx):
    return {name: manifest.metric_reader(name).read(ctx)
            for name in READERS}


def test_readers_on_two_steps(default):
    kernels = []
    for t in (0.0, 45.0):            # 5 ms between steps: the harness's loop
        recs, ks = _step(t)
        default.records.extend(recs)
        kernels += ks
    for dropped in (3, 5, 3, 5):     # two MoE layers, two steps
        default.count('moe.assignments/moe', 64)
        default.count('moe.dropped/moe', dropped)
    got = _read(_ctx(kernels))
    want = {'forward_ms': 10.0, 'backward_ms': 20.0, 'update_ms': 6.0,
            'step_metrics_ms': 2.0, 'apply_ms': 2.0,
            'capture_ms': 2.0,       # the recompute's capture left out
            'idle_in_step_ms': 1.0 + 0.5 + 0.5,
            'moe_drop_share': 100.0 * 16 / 256}
    assert got == pytest.approx(want, abs=1e-6)


def test_readers_without_spans(default):
    assert set(_read(_ctx([(0.0, 1.0)])).values()) == {None}
    recs, kernels = _step(0.0)
    default.records.extend(recs)
    assert set(_read(TraceContext(None, None, None, [], [], None))
               .values()) == {None}
    got = _read(_ctx(kernels, steps=1))
    assert got['moe_drop_share'] is None      # no MoE counters
    assert got['forward_ms'] == pytest.approx(10.0)


def test_readers_on_a_program_without_a_tracker(default, monkeypatch):
    recs, kernels = _step(0.0)
    default.records.extend(recs)
    default.count('moe.assignments/moe', 8)
    monkeypatch.delattr(spans, 'default_tracker')
    assert set(_read(_ctx(kernels, steps=1)).values()) == {None}
