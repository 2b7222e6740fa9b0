"""Phase spans, the straggler watchdog and the profile-mode samplers —
PyTorch port of ``repro/obs/spans.py``.

Spans are host-timed phase windows (data, grad, precondition, apply, step).
The card runs asynchronously, so a span carries an optional fence: the
tensors produced inside it.  When a span with a fence closes, each CUDA
device that holds one of the fence's tensors is synchronized before the
clock stops, so the span holds the device time of its phase; this
serializes phases that could overlap, which is why span timing is behind
the trainer's ``profile`` flag.

Profile mode also samples the live tensor bytes (``live_buffer_mb``), the
allocator's bytes in use, and a one-shot cost and blocking-collective
summary per phase function (``hlo_costs``, from the cost trace of
``launch/hlo_analysis.py``).
"""
from __future__ import annotations

import contextlib
import gc
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
            if handle._fence is not None:
                fence_devices(handle._fence)
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
