"""Per-call-site logical exchange-byte accounting — PyTorch port of
``repro/comm/metrics.py``.

Every exchange primitive of ``comm/exchange.py`` records the logical
payload bytes ONE worker contributes to its collective per call (wire bits
× elements, plus the scale side channel), computed from shapes and codecs
as in the reference.  The reference records once per trace; the port runs
eagerly and records at every call, so a site's ``traces`` counts calls.
"Logical" means the payload handed to the collective, before any transport
factor (a ring all-reduce moves about twice the payload).
"""
from __future__ import annotations

import threading
from typing import Any, Optional

_LOCK = threading.Lock()
_SITES: dict[str, dict[str, Any]] = {}
_SCOPES: list['Scope'] = []


class Scope:
    """A run-scoped view of the counters (``push_scope``): while it is
    active every ``record`` lands here as well as in the process table."""

    def __init__(self) -> None:
        self.sites: dict[str, dict[str, Any]] = {}

    def snapshot(self) -> dict[str, dict[str, Any]]:
        with _LOCK:
            return {k: dict(v) for k, v in self.sites.items()}


def push_scope() -> Scope:
    """Activate a new scope (the caller pops it with ``pop_scope``)."""
    s = Scope()
    with _LOCK:
        _SCOPES.append(s)
    return s


def pop_scope(s: Scope) -> None:
    with _LOCK:
        if s in _SCOPES:
            _SCOPES.remove(s)


def record(site: str, *, bytes_per_call: int, codec: str, mode: str,
           extra: Optional[dict] = None) -> None:
    """Record one call of a site with the bytes one worker contributes."""
    with _LOCK:
        for table in [_SITES] + [s.sites for s in _SCOPES]:
            rec = table.setdefault(site, {'traces': 0})
            rec['traces'] += 1
            rec['bytes_per_call'] = int(bytes_per_call)
            rec['codec'] = codec
            rec['mode'] = mode
            if extra:
                rec.update(extra)


def snapshot() -> dict[str, dict[str, Any]]:
    """{site: {bytes_per_call, codec, mode, traces, ...}}, a copy."""
    with _LOCK:
        return {k: dict(v) for k, v in _SITES.items()}


def reset() -> None:
    with _LOCK:
        _SITES.clear()


def leaf_elements(leaf) -> int:
    """Element count of anything with a ``shape``."""
    n = 1
    for d in leaf.shape:
        n *= int(d)
    return n
