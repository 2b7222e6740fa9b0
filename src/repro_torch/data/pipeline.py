"""Background prefetch: make the next batches on the host while the card
runs a step — PyTorch port of ``repro/data/pipeline.py``.

``Prefetcher`` wraps any seekable stream (``batch_at(step)``) and keeps a
bounded queue filled from a worker thread.  It stays seekable: ``seek(step)``
drains the queue and restarts the worker, so a resumed run composes with
prefetching.  ``host_ms`` keeps the worker's host milliseconds per batch.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional


class Prefetcher:
    def __init__(self, stream: Any, depth: int = 2, start_step: int = 0):
        self.stream = stream
        self.depth = depth
        self.host_ms: list[float] = []
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_produce = start_step
        self._next_consume = start_step
        self._start()

    def _start(self):
        self._stop.clear()

        def worker():
            while not self._stop.is_set():
                step = self._next_produce
                t0 = time.perf_counter()
                batch = self.stream.batch_at(step)
                self.host_ms.append((time.perf_counter() - t0) * 1e3)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        self._next_produce = step + 1
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def batch_at(self, step: int):
        """Seekable interface; sequential access is served from the
        queue."""
        if step != self._next_consume:
            self.seek(step)
        s, batch = self._q.get()
        if s != step:
            raise RuntimeError(f'prefetcher served step {s} for {step}')
        self._next_consume = step + 1
        return batch

    def seek(self, step: int):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        while not self._q.empty():
            self._q.get_nowait()
        self._next_produce = step
        self._next_consume = step
        self._start()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
