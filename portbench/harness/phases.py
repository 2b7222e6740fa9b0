"""The program's own spans and counters in the traced run.

While the profiler records the traced run's steps, ``repro_torch`` records
its spans and counters into its default tracker (``repro_torch/obs/
spans.py``): each step's phases 'forward', 'backward', 'update',
'step_metrics' and 'apply', which tile it; the statistics' 'capture' spans;
the MoE layers' ``moe.assignments/<path>`` and ``moe.dropped/<path>``
counters.  Here the spans are put on the profile's device clock
(``device_split``) and read a step.  Each function gives None where the
program records no such span or counter (a program without them)."""
from __future__ import annotations

from typing import Callable, Optional

PHASES = ('forward', 'backward', 'update', 'step_metrics', 'apply')


def _program():
    """(the program's spans module, its default tracker), or (None, None)
    where it has none."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None, None
    default = getattr(spans, 'default_tracker', None)
    if default is None or not hasattr(spans, 'device_split'):
        return None, None
    return spans, default()


def split(ctx, key: Optional[Callable] = None):
    """The profiled steps' spans against ``ctx.profile.kernels``: a
    ``DeviceSplit`` (groups by ``key``, by default the span's name), or
    None."""
    p = ctx.profile
    spans, tracker = _program()
    if p is None or tracker is None or p.steps <= 0 or not p.kernels:
        return None
    records = tracker.resolve()
    if not records:
        return None
    return spans.device_split(records, p.kernels, key)


def ms_per_step(ctx, name: str, key: Optional[Callable] = None):
    """Device ms a step of the spans grouped as ``name``, or None."""
    s = split(ctx, key)
    if s is None or name not in s.by_key:
        return None
    return s.by_key[name]['device_ms'] / ctx.profile.steps


def counter_total(prefix: str):
    """The sum of the counters whose name starts with ``prefix``, or
    None."""
    _, tracker = _program()
    if tracker is None:
        return None
    names = [n for n in tracker.counters if n.startswith(prefix)]
    if not names:
        return None
    return sum(tracker.total(n) for n in names)
