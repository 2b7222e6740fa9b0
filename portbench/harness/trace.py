"""The profiler's trace of a few steps, reduced: the device's busy time
(the union of its kernels' intervals), the window's length, device time by
kernel, the device's idle gaps by the operation that ended each, and the
union time of any named set of kernels.

Only the device's activity is recorded: recording the host's ops too slows
the host by a good part of a step, which would show as idle device time.
What remains of the profiler's cost (its annotations and the copy of the
device's records) is in the window, so the idle share it gives is a little
above that of an untraced step."""
from __future__ import annotations

import collections
import dataclasses
import time

import torch

WINDOW = 'portbench.window'
TOP = 10


def union(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, float('-inf')
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclasses.dataclass
class Profile:
    steps: int
    window_s: float              # the host's clock over the traced steps
    busy_s: float
    kernels: list                # (name, start µs, end µs) on the device
    device_ops: list             # [[name, seconds]], most time first
    idle_gaps: list              # [[before <op>, seconds]], most first

    def kernel_seconds(self, parts) -> float:
        """Union time of the kernels whose name holds any of ``parts``."""
        return union((s, e) for n, s, e in self.kernels
                     if any(p in n for p in parts)) / 1e6


def profile_steps(run, steps: int) -> Profile:
    """``run(steps)`` under the profiler, with device activity alone, from
    a synchronized start to a synchronized end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            run(steps)
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    # the window on the profiler's clock: the device's copy of the
    # annotation where it has one, else every event's span
    marks = sorted((e.time_range.start, e.time_range.end)
                   for e in events if e.name == WINDOW)
    if marks:
        w0, w1 = marks[0]
    else:
        w0 = min(e.time_range.start for e in events)
        w1 = max(e.time_range.end for e in events)
    kernels = []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name != WINDOW and e.device_type == DeviceType.CUDA:
            kernels.append((e.name, max(s, w0), min(t, w1)))
    kernels = [k for k in kernels if k[2] > k[1]]
    per_name = collections.Counter()
    for n, s, t in kernels:
        per_name[n[:160]] += (t - s) / 1e6
    return Profile(steps=steps, window_s=window_s,
                   busy_s=union((s, t) for _, s, t in kernels) / 1e6,
                   kernels=kernels,
                   device_ops=[[n, v] for n, v in per_name.most_common(TOP)],
                   idle_gaps=_idle_by_next_op(kernels, w0, w1))


def _idle_by_next_op(kernels, w0, w1) -> list:
    """The device's idle gaps inside [w0, w1], summed by the device
    operation that ended each ('before <op>', the work the device waited
    for; 'after the last op' for the gap that closes the window)."""
    idle = collections.Counter()
    end = w0
    for n, s, t in sorted(kernels, key=lambda k: k[1]) + \
            [('the window\'s end', w1, w1)]:
        if s > end:
            label = ('after the last op' if s == w1 and t == w1
                     else f'before {n}')
            idle[label[:160]] += (s - end) / 1e6
        end = max(end, t)
    return [[n, v] for n, v in idle.most_common(TOP)]
