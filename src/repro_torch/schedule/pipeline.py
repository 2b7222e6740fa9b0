"""The double-buffered one-step-stale curvature pipeline — PyTorch port of
``repro/schedule/pipeline.py``.

``pipeline='onestep'`` (on ``schedule/runtime.py::RefreshRuntime``) makes
step t apply the statistics and refreshed inverses exchanged at step t−1
while step t's own exchange is in flight.  In the port the statistics mean
is issued with ``async_op=True`` at step t (``comm/exchange.py``) and waited
on at step t+1, when :func:`stage` hands it out, so the collective overlaps
the rest of step t and the forward and backward of step t+1.  The refresh
exchange is the same gated recompute as in sync mode; its consumer applies
the caches of an earlier refresh and stores the new ones.

One :class:`PipelineState` per pipelined site: ``inflight`` is the value
exchanged this step and applied next step (the reduced statistics; None
for a refresh site, whose buffer is the optimizer's own cache fields), and
``age`` the staleness it will have when applied.  The cold start is zeros
at age 0: the first step preconditions with zero statistics, as the
reference's does.

While a statistics mean is in flight, ``inflight`` holds its handle (a
:class:`Pending`), not a tensor tree.  :func:`stage` collects it at the next
step; :func:`settle` collects every handle of a state, and a state is
settled before it is read any other way (a checkpoint, a reshard, a
broadcast).  A handle is no tensor: copying or saving an unsettled state
raises rather than carrying a mean that has not arrived.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.comm import exchange


class PipelineState(NamedTuple):
    """One pipelined site's carried buffer and its staleness (a 0-d int32
    tensor).  ``inflight``: the reduced statistics, a :class:`Pending`
    while their mean is in flight, or None where the buffer is the cache
    fields."""
    inflight: Any
    age: torch.Tensor


class Pending:
    """The handle of a statistics mean still in flight (an issued
    ``exchange.InFlightPmean``); :meth:`collect` waits on it and returns
    the mean."""

    __slots__ = ('fl',)

    def __init__(self, fl: exchange.InFlightPmean):
        self.fl = fl

    def collect(self) -> Any:
        return exchange.collect_pmean_stats(self.fl)

    def __reduce__(self):
        raise TypeError('a statistics mean is still in flight: settle the '
                        'state first (schedule.pipeline.settle)')


def init_state(template: Any = None, device=None) -> PipelineState:
    """Cold slot: a zeros buffer shaped as ``template`` (no buffer for a
    refresh site) at age 0."""
    from repro_torch.core.transform import tree_device, tree_map
    buf = (tree_map(torch.zeros_like, template)
           if template is not None else None)
    if device is None:
        device = tree_device(template) if template is not None else 'cpu'
    return PipelineState(inflight=buf,
                         age=torch.zeros((), dtype=torch.int32,
                                         device=device))


def _arrived(inflight: Any) -> Any:
    return inflight.collect() if isinstance(inflight, Pending) else inflight


def map_pipes(tree: Any, fn) -> Any:
    """``tree`` rebuilt with ``fn`` applied to every PipelineState (dicts,
    lists, tuples and NamedTuples kept; anything else passed through)."""
    if isinstance(tree, PipelineState):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_pipes(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [map_pipes(v, fn) for v in tree]
        return type(tree)(*vals) if hasattr(tree, '_fields') \
            else tuple(vals)
    if isinstance(tree, list):
        return [map_pipes(v, fn) for v in tree]
    return tree


def settle(opt_state: Any) -> Any:
    """``opt_state`` with every statistics mean still in flight waited on
    and in place; a settled state is returned as it is (the same
    object)."""
    if not any(isinstance(p.inflight, Pending)
               for _, p in pipe_entries(opt_state)):
        return opt_state
    return map_pipes(opt_state, lambda p: p._replace(
        inflight=_arrived(p.inflight)))


def stage(pipe: PipelineState, fresh: Any) -> tuple[Any, PipelineState]:
    """Swap buffers at an every-step site: hand out what was exchanged last
    step (collected), put ``fresh`` in flight at age 1."""
    return _arrived(pipe.inflight), PipelineState(
        inflight=fresh, age=torch.ones_like(pipe.age))


def tick(pipe: PipelineState, refresh: bool) -> PipelineState:
    """Advance a refresh-site slot: age 1 when the gated recompute ran this
    step (``refresh``, the host decision), else one step older."""
    age = torch.ones_like(pipe.age) if refresh else pipe.age + 1
    return PipelineState(inflight=pipe.inflight, age=age)


def staged_pmean(tree: Any, pipe: Optional[PipelineState], codec=None,
                 site: Optional[str] = None
                 ) -> tuple[Any, Optional[PipelineState]]:
    """The staged statistics reduction every optimizer calls.

    ``pipe=None`` (sync): the mean over the data group in scope, applied
    now (the identity outside a scope).  Otherwise this step's mean is
    issued asynchronously and its handle put in flight by :func:`stage`,
    and last step's mean is applied."""
    if pipe is None:
        return exchange.pmean_stats(tree, codec=codec, site=site), None
    fl = exchange.issue_pmean_stats(tree, codec=codec, site=site,
                                    async_op=True)
    return stage(pipe, fl.tree if fl.kind == 'raw' else Pending(fl))


# ---------------------------------------------------------------------------
# Observability


def pipe_entries(opt_state: Any) -> list[tuple[str, PipelineState]]:
    """Every (site key, PipelineState) in an optimizer state; the key is
    the nearest enclosing str dict key ('stats' / 'refresh')."""
    found: list[tuple[str, PipelineState]] = []

    def walk(x, key=''):
        if isinstance(x, PipelineState):
            found.append((key, x))
            return
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, k if isinstance(k, str) else key)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v, key)

    walk(opt_state)
    return found


# Step-metric fields this module contributes; a trailing '/*' marks a
# per-site key family.
METRIC_FIELDS = {
    'pipeline_lag': ('int', 'steps of realized double-buffer staleness'),
    'pipeline_lag/*': ('int', 'per-site realized staleness'),
}


def pipeline_metrics(opt_state: Any) -> dict[str, torch.Tensor]:
    """{'pipeline_lag', 'pipeline_lag/<site>'}: the staleness (steps) of
    the buffer each site applies next; {} in sync mode."""
    entries = pipe_entries(opt_state)
    if not entries:
        return {}
    out = {'pipeline_lag': torch.stack([p.age for _, p in entries]).max()}
    for key in sorted({k for k, _ in entries if k}):
        out[f'pipeline_lag/{key}'] = torch.stack(
            [p.age for k2, p in entries if k2 == key]).max()
    return out
