"""``ssd_ms`` on a made-up traced run: two steps whose forward, remat's
recompute and backward each hold 'ssd' spans, against device intervals on a
profiler's clock; None where the program recorded none, and on a program
without a tracker."""
import pytest

from portbench.harness import manifest
from portbench.harness.bench import TraceContext
from portbench.harness.trace import Profile
from portbench_cpu import ROOT  # noqa: F401  (puts src/ on the path)
from repro_torch.obs import spans

OFFSET_US = 3.2e12          # the profiler's clock, far from the events'


def _rec(name, start, end, depth=0, parent=None):
    return {'name': name, 'start_ms': start, 'end_ms': end, 'depth': depth,
            'parent': parent}


def _step(t, ssd=True):
    """One step from ``t`` ms: its spans (two layers' scans in each of the
    forward, the recompute and the backward) and its kernels (ms)."""
    recs = [_rec('forward', t, t + 10), _rec('backward', t + 10, t + 30),
            _rec('recompute', t + 12, t + 16, 1, 'backward'),
            _rec('update', t + 30, t + 36)]
    if ssd:
        recs += [_rec('ssd', t + 1, t + 2, 1, 'forward'),
                 _rec('ssd', t + 5, t + 6.5, 1, 'forward'),
                 _rec('ssd', t + 13, t + 14, 2, 'recompute'),
                 _rec('ssd', t + 20, t + 23, 1, 'backward'),
                 _rec('ssd', t + 24, t + 27, 1, 'backward')]
    return recs, [(t, t + 29.5), (t + 30, t + 36)]


@pytest.fixture
def default():
    tracker = spans.default_tracker()
    tracker.begin()
    yield tracker
    tracker.begin()


def _ctx(kernels_ms, steps):
    kernels = [('k', OFFSET_US + s * 1e3, OFFSET_US + e * 1e3)
               for s, e in kernels_ms]
    profile = Profile(steps=steps, window_s=0.1, busy_s=0.0, kernels=kernels,
                      device_ops=[], idle_gaps=[])
    return TraceContext(cell=None, ref_model=None, peaks=None, grad_s=[],
                        opt_s=[], profile=profile)


def _read(ctx):
    return manifest.metric_reader('ssd_ms').read(ctx)


@pytest.mark.parametrize('ssd,want', [(True, 1 + 1.5 + 1 + 3 + 3),
                                      (False, None)],
                         ids=['ssd_spans', 'no_ssd_spans'])
def test_ssd_ms_on_two_steps(default, ssd, want):
    kernels = []
    for t in (0.0, 40.0):
        recs, ks = _step(t, ssd)
        default.records.extend(recs)
        kernels += ks
    got = _read(_ctx(kernels, steps=2))
    assert got == (None if want is None else pytest.approx(want, abs=1e-6))


def test_ssd_ms_on_a_program_without_a_tracker(default, monkeypatch):
    recs, kernels = _step(0.0)
    default.records.extend(recs)
    monkeypatch.delattr(spans, 'default_tracker')
    assert _read(_ctx(kernels, steps=1)) is None
    assert _read(TraceContext(None, None, None, [], [], None)) is None
