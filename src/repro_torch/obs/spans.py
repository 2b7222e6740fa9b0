"""Spans and counters, the straggler watchdog and the profile-mode
samplers — PyTorch port of ``repro/obs/spans.py``.

A span is a named window of a tracker's session, with its parent and depth:
its host open and close on ``time.perf_counter`` and its device start and
end.  On a CUDA device a span records a CUDA timing event on the current
stream when it opens and again when it closes, and never synchronizes; the
events are read after the caller's own synchronize (``resolve``), each
against the session's anchor event.  On the CPU the device times are the
host times.  A span may instead carry a fence (``SpanHandle.fence``): the
tensors produced inside it, whose devices are synchronized before its host
clock stops, which serializes phases that could overlap; the trainer's
``profile`` mode times its phases so, and each such span is one ``span``
record of ``obs/events.py``.  Counters are per-call values (host ints or
device tensors, never read back while recording) kept beside the spans.

The program's span and counter sites (``span``, ``tracing``) record into the
tracker installed by ``recording(tracker)``, else, while a ``torch.profiler``
session records, into the module's default tracker (``default_tracker``),
which begins a new session with each profiler session.  With neither, a site
costs one module-global read and records nothing.  Spans are not emitted as
``record_function`` ranges: under a profiler recording the device, their
device copies would count as device activity.  ``device_split`` puts a
session's spans on a profiler's device clock.

Profile mode also samples the live tensor bytes (``live_buffer_mb``), the
allocator's bytes in use, and a one-shot cost and blocking-collective
summary per phase function (``hlo_costs``, from the cost trace of
``launch/hlo_analysis.py``).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import gc
import statistics
import time
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch.obs import events


class SpanHandle:
    """Yielded by ``SpanTracker.span``; ``fence(x)`` registers the tensors
    the span must wait on before its clock stops."""

    __slots__ = ('_fence',)

    def __init__(self) -> None:
        self._fence: Any = None

    def fence(self, x: Any) -> Any:
        self._fence = x
        return x


def _cuda_devices(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    return out


def fence_devices(fence: Any, synchronize=None) -> list:
    """Synchronize each CUDA device that holds a tensor of ``fence`` (a
    tensor or a tree of dicts, tuples and lists), as the reference blocks
    on the fence itself; returns the devices, in index order.
    ``synchronize`` stands in for ``torch.cuda.synchronize`` (tests)."""
    devices = sorted(_cuda_devices(fence, set()), key=lambda d: d.index)
    sync = synchronize or torch.cuda.synchronize
    for d in devices:
        sync(d)
    return devices


class SpanTracker:
    """The spans and counters of one session at a time.

    ``records`` holds one dict per closed span, in closing order: ``name``,
    ``ms`` (host, fence included), ``seq`` (emission order), ``depth``,
    ``parent``, ``step`` when given, ``host_start_ms``/``host_end_ms`` and,
    once resolved, the device ``start_ms``/``end_ms``, all from the
    session's start.  A ``recorder`` gets each span as a ``span`` record of
    the reference's schema.  ``counters`` maps a name to its values, one a
    ``count`` call.  ``begin`` starts a new session and drops the last one's
    records and counters.  Spans may open on another thread while this one
    waits in them (autograd's recompute runs on its device thread), and nest
    under the span open there."""

    def __init__(self, recorder: Optional[events.Recorder] = None,
                 clock=time.perf_counter):
        self.recorder = recorder
        self._clock = clock
        self._stack: list[str] = []
        self.begin()

    def begin(self) -> None:
        self.records: list[dict] = []
        self.counters: dict[str, list] = {}
        self._seq = 0
        self._t0 = self._clock()
        # CUDA timing events from the session's first span on, when the
        # process runs on a card
        self._cuda = torch.cuda.is_initialized()
        self._anchor = None
        self._pending: list = []

    def _event(self):
        # torch.Event records on the current stream from C++: about a third
        # of torch.cuda.Event's host time on the card
        if not self._cuda:
            return None
        if self._anchor is None:
            self._anchor = torch.Event('cuda', enable_timing=True)
            self._anchor.record()
        ev = torch.Event('cuda', enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def span(self, name: str, step: Optional[int] = None
             ) -> Iterator[SpanHandle]:
        handle = SpanHandle()
        parent = self._stack[-1] if self._stack else None
        depth = len(self._stack)
        self._stack.append(name)
        start = self._event()
        t0 = self._clock()
        try:
            yield handle
        finally:
            if handle._fence is not None:
                fence_devices(handle._fence)
            t1 = self._clock()
            end = self._event()
            self._stack.pop()
            rec = {'name': name, 'ms': round((t1 - t0) * 1e3, 4),
                   'seq': self._seq, 'depth': depth, 'parent': parent}
            if step is not None:
                rec['step'] = int(step)
            self._seq += 1
            if self.recorder is not None:
                self.recorder.emit('span', **rec)
            rec['host_start_ms'] = (t0 - self._t0) * 1e3
            rec['host_end_ms'] = (t1 - self._t0) * 1e3
            if start is None:
                rec['start_ms'] = rec['host_start_ms']
                rec['end_ms'] = rec['host_end_ms']
            else:
                self._pending.append((rec, start, end))
            self.records.append(rec)

    def count(self, name: str, value) -> None:
        """One value of counter ``name`` (an int, or a device tensor left
        on the device)."""
        self.counters.setdefault(name, []).append(value)

    def total(self, name: str):
        """The sum of counter ``name``'s values, read back to the host
        once (None if it has none)."""
        values = self.counters.get(name)
        if not values:
            return None
        return int(sum(values))

    def resolve(self) -> list:
        """``records``, each with its device ``start_ms``/``end_ms``.  Call
        it after a synchronize of the spans' devices (an event still in
        flight is waited for)."""
        for rec, start, end in self._pending:
            end.synchronize()
            rec['start_ms'] = self._anchor.elapsed_time(start)
            rec['end_ms'] = self._anchor.elapsed_time(end)
        self._pending.clear()
        return self.records


# ---------------------------------------------------------------------------
# The program's span and counter sites

_DEFAULT = SpanTracker()
_installed: Optional[SpanTracker] = None
_profiling = False
_on: Optional[SpanTracker] = None       # where the sites record, or None
_OFF = contextlib.nullcontext()


def _retarget() -> None:
    global _on
    _on = _installed if _installed is not None else (
        _DEFAULT if _profiling else None)


def span(name: str):
    """A span of the active tracker, else a shared no-op context."""
    t = _on
    return _OFF if t is None else t.span(name)


def tracing() -> Optional[SpanTracker]:
    """The tracker the sites record into, or None (a counter site computes
    nothing then)."""
    return _on


def default_tracker() -> SpanTracker:
    """The tracker that records while a ``torch.profiler`` session does
    (and no tracker is installed); it holds the last such session."""
    return _DEFAULT


@contextlib.contextmanager
def recording(tracker: SpanTracker) -> Iterator[SpanTracker]:
    """Trace into ``tracker``, in a new session of it, inside the block."""
    global _installed
    prev = _installed
    tracker.begin()
    _installed = tracker
    _retarget()
    try:
        yield tracker
    finally:
        _installed = prev
        _retarget()


def _profiler_hooks() -> None:
    """Follow ``torch.profiler``'s sessions through the hooks that
    ``torch.autograd.profiler`` calls when a session starts and stops."""
    from torch.autograd import profiler as tprof
    start, stop = tprof._run_on_profiler_start, tprof._run_on_profiler_stop
    if getattr(start, '_spans_hook', False):
        return

    def on_start():
        global _profiling
        start()
        _DEFAULT.begin()
        _profiling = True
        _retarget()

    def on_stop():
        global _profiling
        stop()
        _profiling = False
        _retarget()

    on_start._spans_hook = on_stop._spans_hook = True
    tprof._run_on_profiler_start = on_start
    tprof._run_on_profiler_stop = on_stop


_profiler_hooks()


# ---------------------------------------------------------------------------
# Spans on a profiler's device clock


@dataclasses.dataclass
class DeviceSplit:
    """``device_split``'s result.  ``by_key``: per group of spans, the
    device ms the spans cover (summed over them), the ms of it in which no
    device interval ran, and the number of spans.  ``kernel_ms``: the union
    of the device intervals; ``outside_ms``: the part of it outside every
    top-level span.  ``scale``: profiler µs per span µs of the mapping."""
    by_key: dict
    kernel_ms: float
    outside_ms: float
    scale: float


class _Union:
    """The union of (start, end) intervals, for covered length queries."""

    def __init__(self, intervals) -> None:
        self.starts, self.ends, self.before = [], [], [0.0]
        for s, e in sorted(intervals):
            if self.ends and s <= self.ends[-1]:
                if e > self.ends[-1]:
                    self.before[-1] += e - self.ends[-1]
                    self.ends[-1] = e
                continue
            self.starts.append(s)
            self.ends.append(e)
            self.before.append(self.before[-1] + e - s)
        self.before.pop()
        self.total = (self.before[-1] + self.ends[-1] - self.starts[-1]
                      if self.starts else 0.0)

    def upto(self, x: float) -> float:
        """Covered length below ``x``."""
        i = bisect.bisect_right(self.starts, x) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(x, self.ends[i]) - self.starts[i]

    def within(self, a: float, b: float) -> float:
        return self.upto(b) - self.upto(a) if b > a else 0.0


def device_split(records: list, intervals: list,
                 key: Optional[Callable] = None) -> DeviceSplit:
    """A session's resolved spans against device intervals ``(name,
    start_us, end_us)`` on a profiler's clock, of the same stretch of work.

    The spans are put on the profiler's clock by two anchors: the earliest
    span start on the first interval's start and the latest span end on the
    last interval's end (the session's work begins with its first span and
    ends with its last, from an idle device to a synchronize).  ``key(rec)``
    names the group of each span (None leaves it out); by default its
    name."""
    key = key or (lambda r: r['name'])
    spans = [r for r in records if 'start_ms' in r]
    busy = _Union((s, e) for _, s, e in intervals)
    by_key: dict = {}
    if not spans or not busy.starts:
        return DeviceSplit(by_key, busy.total / 1e3, busy.total / 1e3, 1.0)
    s0 = min(r['start_ms'] for r in spans) * 1e3
    s1 = max(r['end_ms'] for r in spans) * 1e3
    k0, k1 = busy.starts[0], busy.ends[-1]
    scale = (k1 - k0) / (s1 - s0) if s1 > s0 else 1.0

    def at(ms):
        return k0 + (ms * 1e3 - s0) * scale

    for r in spans:
        k = key(r)
        if k is None:
            continue
        a, b = at(r['start_ms']), at(r['end_ms'])
        g = by_key.setdefault(k, {'device_ms': 0.0, 'idle_ms': 0.0,
                                  'spans': 0})
        g['device_ms'] += (b - a) / 1e3
        g['idle_ms'] += ((b - a) - busy.within(a, b)) / 1e3
        g['spans'] += 1
    top = _Union((at(r['start_ms']), at(r['end_ms']))
                 for r in spans if r['depth'] == 0)
    inside = sum(busy.within(s, e) for s, e in zip(top.starts, top.ends))
    return DeviceSplit(by_key, busy.total / 1e3,
                       (busy.total - inside) / 1e3, scale)


class StragglerWatchdog:
    """Median-of-window straggler detection.

    ``observe(step, dt)`` returns True, and emits a ``straggler`` record,
    when ``dt`` exceeds ``factor ×`` the median of the last ``window`` step
    times (this step's included); it needs ``min_history`` samples before it
    can trigger.
    """

    def __init__(self, factor: float = 3.0,
                 recorder: Optional[events.Recorder] = None,
                 window: int = 64, min_history: int = 8):
        self.factor = factor
        self.recorder = recorder
        self.window = window
        self.min_history = min_history
        self.times: list[float] = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) < self.min_history:
            return False
        med = statistics.median(self.times[-self.window:])
        if dt <= self.factor * med:
            return False
        if self.recorder is not None:
            self.recorder.emit('straggler', step=int(step),
                               step_time_s=round(dt, 6),
                               median_s=round(med, 6), factor=self.factor)
        print(f'[obs] STRAGGLER step {step}: {dt*1e3:.0f} ms vs median '
              f'{med*1e3:.0f} ms', flush=True)
        return True


# ---------------------------------------------------------------------------
# Profile-mode samplers


def device_bytes_in_use() -> Optional[int]:
    """Bytes the caching allocator has handed out on the current card
    (``torch.cuda.memory_allocated``); None without a card."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.memory_allocated())


def live_buffer_mb() -> float:
    """Bytes of the live tensors of this process, in MiB: on a card, the
    allocator's bytes in use summed over the visible devices; on the CPU,
    the storages of the tensors the garbage collector reaches, each counted
    once."""
    if torch.cuda.is_available():
        total = sum(torch.cuda.memory_allocated(i)
                    for i in range(torch.cuda.device_count()))
        return round(total / 2 ** 20, 3)
    from torch._subclasses.fake_tensor import FakeTensor
    seen: set = set()
    total = 0
    for obj in gc.get_objects():
        if not issubclass(type(obj), torch.Tensor) \
                or isinstance(obj, FakeTensor) or obj.is_meta \
                or obj.layout != torch.strided:
            continue
        try:
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):   # tensor subclasses
            continue
        key = st.data_ptr()
        if key in seen:
            continue
        seen.add(key)
        total += st.nbytes()
    return round(total / 2 ** 20, 3)


def hlo_costs(fn, *args) -> dict:
    """One phase function's cost and blocking-collective summary — the
    ``fns`` entries of a ``profile`` record — from one run of ``fn`` on
    fake copies of ``args`` (``launch/hlo_analysis.py``): nothing is
    computed or launched, and the port's kernels count as custom calls."""
    from repro_torch.launch import hlo_analysis
    device = next((t.device for t in hlo_analysis._tensors(args)
                   if not t.is_meta), 'cpu')
    record = hlo_analysis.trace(fn, *args, device=device)[0]
    costs, overlap = record.costs, record.overlap()
    return {
        'flops': costs.flops,
        'traffic_bytes': costs.traffic_bytes,
        'collective_bytes': costs.collective_bytes,
        'collective_count': overlap.collective_count,
        'blocking_collectives': overlap.blocking_collectives,
        'dependent_dot_flop_frac': round(overlap.dependent_fraction, 4),
    }


def compiled_fn_costs(fn, *args) -> dict:
    """``hlo_costs`` of ``fn`` at ``args``' shapes (the port compiles
    nothing: the trace runs the function as the step does)."""
    return hlo_costs(fn, *args)
