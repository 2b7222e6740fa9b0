"""RefreshRuntime: the train-level refresh configuration — PyTorch port.

Counterpart of ``repro/schedule/runtime.py`` for one device and the
``'sync'`` pipeline.  :func:`sharded_refresh` keeps the reference's
single-worker structure (``recompute_single``); the worker-sharded
recomputation, its owned-slice exchange and the ``'onestep'`` pipeline need
several workers and are not ported.  :func:`schedule_metrics` and
:func:`ownership_event` are the trainer's view of the refresh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.core.bucketing import Bucket, BucketPlan
from repro_torch.core.transform import tree_map
from repro_torch.schedule import ownership
from repro_torch.schedule import policy as policy_mod


@dataclasses.dataclass(frozen=True)
class RefreshRuntime:
    """policy: the default policy for optimizers built without one (their
    ``interval`` kwarg wins when set ≠ 1).  shard_refresh: let the workers
    share the refresh (:func:`sharded_refresh`); one process recomputes
    everything either way.  pipeline: only ``'sync'`` — statistics are
    applied in the step that produced them."""

    policy: Optional[policy_mod.RefreshPolicy] = None
    shard_refresh: bool = True
    pipeline: str = 'sync'

    def __post_init__(self):
        if self.pipeline != 'sync':
            raise ValueError(f"pipeline {self.pipeline!r} is not ported; "
                             "only 'sync'")

    def resolve(self, local: Optional[policy_mod.RefreshPolicy],
                interval: int = 1) -> policy_mod.RefreshPolicy:
        if local is not None:
            return local
        if interval != 1:
            return policy_mod.every_k(interval)
        return self.policy if self.policy is not None \
            else policy_mod.every_k(1)


_DEFAULT = RefreshRuntime()


def from_extras(extras) -> RefreshRuntime:
    """The runtime threaded through ``Extras.sched``, else the default."""
    rt = getattr(extras, 'sched', None) if extras is not None else None
    return rt if rt is not None else _DEFAULT


def resolve_pipe(rt: RefreshRuntime, state_pipe):
    """The pipe an update threads this step: always None in sync mode; a
    state that carries pipeline buffers was built for another mode."""
    if state_pipe is not None:
        raise ValueError("pipeline='sync' but the optimizer state carries "
                         'pipeline buffers')
    return None


def sharded_refresh(plan: BucketPlan, refresh: bool,
                    item_fn: Callable[[Bucket, Any], Any],
                    args_b: Mapping[str, Any], old_b: Mapping[str, Any], *,
                    cost: Callable[[Bucket], float],
                    shard: bool = True) -> dict:
    """Recompute cached per-bucket values under a refresh decision.

    ``item_fn(bucket, row)`` recomputes one stack row of ``args_b[key]``
    (e.g. a damped-inverse pair); the rows are recomputed one at a time in
    stack order, as the reference's ``lax.map``, and stacked again.
    ``refresh`` is the decision on the host (``policy.on_host``): on a step
    that keeps the old values nothing is computed and ``old_b``'s values
    come back as they are, as the reference's ``lax.cond`` skips the
    recomputation.  ``cost`` weighs an item for the owner assignment of the
    multi-worker form and is unused by one worker.  Returns
    ``{bucket_key: values}`` shaped as ``old_b``.
    """
    del cost
    if shard:
        ownership.world_and_rank()   # raises for several workers
    if not refresh:
        return {b.key: old_b[b.key] for b in plan.buckets}
    out = {}
    for b in plan.buckets:
        args = args_b[b.key]
        rows = [item_fn(b, tree_map(lambda x, i=i: x[i], args))
                for i in range(len(b.paths))]
        out[b.key] = tree_map(lambda *xs: torch.stack(xs), *rows)
    return out


# ---------------------------------------------------------------------------
# Observability


def sched_states(opt_state: Any) -> list[policy_mod.SchedState]:
    """Every SchedState in an optimizer state tree, in walk order."""
    found: list[policy_mod.SchedState] = []

    def walk(x):
        if isinstance(x, policy_mod.SchedState):
            found.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(opt_state)
    return found


# Step-metric fields this module contributes, declared next to their
# producer so the telemetry schema (``obs/events.py``) follows the code
# that emits them: name -> (kind in {'int', 'num'}, unit).
METRIC_FIELDS = {
    'refreshes': ('int', 'cumulative refreshes'),
    'refresh_since': ('int', 'steps since last refresh'),
    'staleness': ('num', 'policy staleness proxy'),
}


def schedule_metrics(opt_state: Any) -> dict[str, torch.Tensor]:
    """{'refreshes', 'refresh_since', 'staleness'} over every scheduled
    transform in the state, as 0-d device tensors (nothing is read back);
    {} when nothing is scheduled."""
    sts = sched_states(opt_state)
    if not sts:
        return {}
    refreshes = sts[0].n_refresh
    for st in sts[1:]:
        refreshes = refreshes + st.n_refresh
    return {
        'refreshes': refreshes,
        'refresh_since': torch.stack([st.since for st in sts]).max(),
        'staleness': torch.stack([st.staleness for st in sts]).max(),
    }


def ownership_event(plan: Optional[BucketPlan]) -> Optional[dict]:
    """The ``refresh_ownership`` record body ({'world', 'owners'}) of a
    bucket plan in this process: at W = 1 every slice of each bucket is
    worker 0's, so ``owners`` is {bucket: [slices]}.  None when nothing is
    preconditioned.  ``world_and_rank`` raises for several workers, whose
    owner assignment is not ported."""
    if plan is None or not plan.buckets:
        return None
    ownership.world_and_rank()
    return {'world': 1,
            'owners': {b.key: [len(b.paths) * ownership.lead_size(b)]
                       for b in plan.buckets}}
