"""RefreshRuntime: the train-level refresh configuration — PyTorch port of
``repro/schedule/runtime.py``.

* Policy resolution: an optimizer's own ``policy=`` wins, then a legacy
  ``interval`` ≠ 1, then the runtime's default.
* :func:`sharded_refresh`: the gated recomputation.  The decision is a host
  bool (``policy.on_host``) computed from replicated state, so every worker
  takes the same branch.  One worker recomputes each stack row in order;
  under a data group of W > 1 (``comm/group.py``) each bucket's stack and
  leading dims flatten into slices, each worker computes only the slices
  it owns (``ownership.assign_slice_owners``) and zeros elsewhere, and the
  owned-slice all-gather (or the zero-padded sum, ``exchange='psum'``)
  rebuilds every slice on every worker.
* ``pipeline='onestep'``: the same recompute and exchange; the caller
  applies the caches of an earlier refresh and stores the new ones
  (``schedule/pipeline.py``).
* :func:`schedule_metrics` and :func:`ownership_event` are the trainer's
  view of the refresh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.comm import codec as exchange_codec
from repro_torch.comm import exchange, metrics
from repro_torch.comm import group as group_mod
from repro_torch.core.bucketing import Bucket, BucketPlan
from repro_torch.core.transform import tree_map
from repro_torch.schedule import ownership
from repro_torch.schedule import pipeline as pipeline_mod
from repro_torch.schedule import policy as policy_mod


@dataclasses.dataclass(frozen=True)
class RefreshRuntime:
    """policy: the default policy for optimizers built without one (their
    ``interval`` kwarg wins when set ≠ 1).  shard_refresh: let the workers
    share the refresh (:func:`sharded_refresh`); off, every worker
    recomputes everything.  pipeline: 'sync' (every exchange applied in
    the step that issued it) or 'onestep' (step t applies what step t−1
    exchanged; the optimizer state carries the pipeline buffers, so
    ``init_opt_state`` and the step must agree)."""

    policy: Optional[policy_mod.RefreshPolicy] = None
    shard_refresh: bool = True
    pipeline: str = 'sync'

    def __post_init__(self):
        if self.pipeline not in ('sync', 'onestep'):
            raise ValueError("pipeline must be 'sync' or 'onestep', "
                             f'got {self.pipeline!r}')

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
    """The pipe dict an update threads this step (None in sync mode); the
    mode is part of the state's structure, so a mismatch raises."""
    if rt.pipeline == 'onestep':
        if state_pipe is None:
            raise ValueError(
                "pipeline='onestep' but the optimizer state has no pipeline "
                'buffers: pass the same RefreshRuntime(pipeline=...) to '
                'init_opt_state and the train step')
        return state_pipe
    if state_pipe is not None:
        raise ValueError(
            "pipeline='sync' but the optimizer state carries pipeline "
            'buffers: pass the same RefreshRuntime(pipeline=...) to '
            'init_opt_state and the train step')
    return None


def init_pipe(rt: RefreshRuntime, device, stats=None,
              refresh: bool = True) -> Optional[dict]:
    """The optimizer's pipeline slots at init: None in sync mode; else a
    'stats' slot of zeros shaped as ``stats`` where the optimizer reduces
    statistics, and a 'refresh' slot where it caches refreshed values."""
    if rt.pipeline != 'onestep':
        return None
    pipe = {}
    if stats is not None:
        pipe['stats'] = pipeline_mod.init_state(stats, device)
    if refresh:
        pipe['refresh'] = pipeline_mod.init_state(device=device)
    return pipe


def _recompute_single(plan, item_fn, args_b, site):
    out = {}
    for b in plan.buckets:
        args = args_b[b.key]
        rows = [item_fn(b, tree_map(lambda x, i=i: x[i], args))
                for i in range(len(b.paths))]
        out[b.key] = tree_map(lambda *xs: torch.stack(xs), *rows)
    # nothing moves, but the site reports the stack's logical payload so
    # the breakdowns compare across worlds
    metrics.record(site, bytes_per_call=sum(
        exchange.tree_payload_bytes(v, exchange_codec.F32)
        for v in out.values()), codec='f32', mode='local')
    return out


def _recompute_sharded(plan, item_fn, args_b, old_b, cost, cfg, world,
                       rank, site):
    """W > 1: each worker computes the (row x lead) slices it owns, zeros
    elsewhere, then the exchange rebuilds every slice everywhere.  A slice's
    inverse runs on one (d, d) matrix where one worker batches a row's
    (lead, d, d), which can move the last float ulp; the two exchange modes
    share this compute and stay bit-identical to each other."""
    scope = group_mod.current()
    pods = None
    if (cfg.topology == 'pod' and cfg.exchange == 'gather'
            and scope.pods is not None and scope.pods[0] > 1
            and scope.pods[0] * scope.pods[1] == world):
        pods = scope.pods
    owners = (ownership.assign_pod_slice_owners(plan, cost, pods)
              if pods is not None
              else ownership.assign_slice_owners(plan, cost, world))
    out = {}
    for b in plan.buckets:
        nlead = len(b.shape) - 2
        n_slices = len(b.paths) * ownership.lead_size(b)

        def flat(x, nlead=nlead, n_slices=n_slices):
            return x.reshape((n_slices,) + tuple(x.shape[1 + nlead:]))

        fargs = tree_map(flat, args_b[b.key])
        fold = tree_map(flat, old_b[b.key])
        own = owners[b.key]
        slices = []
        for i in range(n_slices):
            if own[i] == rank:
                slices.append(item_fn(b, tree_map(lambda x, i=i: x[i],
                                                  fargs)))
            else:
                slices.append(tree_map(lambda x: torch.zeros(
                    x.shape[1:], dtype=x.dtype, device=x.device), fold))
        out[b.key] = tree_map(lambda *xs: torch.stack(xs), *slices)
    if cfg.exchange == 'psum':
        out = exchange.psum_tree(out)
        metrics.record(site, bytes_per_call=sum(
            exchange.tree_payload_bytes(v, exchange_codec.F32)
            for v in out.values()), codec='f32', mode='psum')
    else:
        out = exchange.allgather_owned_slices(
            plan, owners, world, rank, out, codec=cfg.codec, site=site,
            pods=pods)
    return {k: tree_map(lambda y, o: y.reshape(o.shape), out[k], old_b[k])
            for k in out}


def sharded_refresh(plan: BucketPlan, refresh: bool,
                    item_fn: Callable[[Bucket, Any], Any],
                    args_b: Mapping[str, Any], old_b: Mapping[str, Any], *,
                    cost: Callable[[Bucket], float],
                    shard: bool = True,
                    comm: Optional[exchange.ExchangeConfig] = None,
                    site: str = 'refresh',
                    pipe: Optional[pipeline_mod.PipelineState] = None):
    """Recompute cached per-bucket values under a refresh decision.

    ``item_fn(bucket, item)`` recomputes one item of ``args_b[key]`` (a
    damped-inverse pair, say) and broadcasts over leading dims: one worker
    hands it whole stack rows, a W > 1 data group one lead-flattened slice
    at a time.  ``refresh`` is the host decision (``policy.on_host``): a
    step that keeps the old values computes and exchanges nothing and
    returns ``old_b``'s values.  ``cost`` weighs a slice for the owner
    maps; ``shard=False`` makes every worker recompute everything.
    ``comm`` (``Extras.comm``): the refresh codec and 'gather' or 'psum'.
    ``site``: the byte counters' label.

    Returns ``{bucket_key: values}`` shaped as ``old_b`` when ``pipe`` is
    None; else ``(applied, fresh, new_pipe)``: ``applied`` is ``old_b``
    (what this step preconditions with), ``fresh`` what the caller stores.
    """
    world, rank = ownership.world_and_rank() if shard else (1, None)
    cfg = exchange.from_extras(None) if comm is None else comm
    if not refresh:
        fresh = {b.key: old_b[b.key] for b in plan.buckets}
    elif world == 1:
        fresh = _recompute_single(plan, item_fn, args_b, site)
    else:
        fresh = _recompute_sharded(plan, item_fn, args_b, old_b, cost, cfg,
                                   world, rank, site)
    if pipe is None:
        return fresh
    applied = {b.key: old_b[b.key] for b in plan.buckets}
    return applied, fresh, pipeline_mod.tick(pipe, refresh)


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


def ownership_event(plan: Optional[BucketPlan],
                    world: Optional[int] = None) -> Optional[dict]:
    """The ``refresh_ownership`` record body ({'world', 'owners'}) of a
    bucket plan over ``world`` workers (default: the data group in scope,
    else 1): per bucket, the slices each worker owns.  None when nothing is
    preconditioned."""
    if plan is None or not plan.buckets:
        return None
    if world is None:
        world = ownership.world_and_rank()[0]
    return {'world': int(world),
            'owners': ownership.describe_ownership(plan, int(world))}
