"""Phase spans, the straggler watchdog and the profile-mode samplers —
PyTorch port of ``repro/obs/spans.py``.

Spans are host-timed phase windows (data, grad, precondition, apply, step).
The card runs asynchronously, so a span carries an optional fence: the
tensors produced inside it.  When a span with a fence closes on a machine
with a card, ``torch.cuda.synchronize()`` runs before the clock stops, so
the span holds the device time of its phase; this serializes phases that
could overlap, which is why span timing is behind the trainer's
``profile`` flag.  The
reference's HLO cost summaries (``hlo_costs``, ``compiled_fn_costs``) are
specific to XLA and are not ported; a ``profile`` record omits ``fns``,
and its one memory sample is the allocator's bytes in use.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Iterator, Optional

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


class SpanTracker:
    """Emits one ``span`` record per closed span, with nesting metadata
    (``depth``/``parent``) and a global emission order (``seq``)."""

    def __init__(self, recorder: Optional[events.Recorder] = None,
                 clock=time.perf_counter):
        self.recorder = recorder
        self.records: list[dict] = []
        self._clock = clock
        self._stack: list[str] = []
        self._seq = 0

    @contextlib.contextmanager
    def span(self, name: str, step: Optional[int] = None
             ) -> Iterator[SpanHandle]:
        handle = SpanHandle()
        parent = self._stack[-1] if self._stack else None
        depth = len(self._stack)
        self._stack.append(name)
        t0 = self._clock()
        try:
            yield handle
        finally:
            if handle._fence is not None and torch.cuda.is_available():
                torch.cuda.synchronize()
            ms = (self._clock() - t0) * 1e3
            self._stack.pop()
            rec = {'name': name, 'ms': round(ms, 4), 'seq': self._seq,
                   'depth': depth, 'parent': parent}
            if step is not None:
                rec['step'] = int(step)
            self._seq += 1
            self.records.append(rec)
            if self.recorder is not None:
                self.recorder.emit('span', **rec)


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
