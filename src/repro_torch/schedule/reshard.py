"""Optimizer state across world sizes (elastic training) — PyTorch port of
``repro/schedule/reshard.py``.

A checkpoint written at W = 4 restores at W = 2 or W = 8 because the state
is world-agnostic: every leaf is the full logical tensor (rank 0 saves the
replicated values), refresh ownership is never stored (the maps of
``schedule/ownership.py`` are recomputed from (plan, W)), and the factor
bands of ``core/factor_sharded.py`` are cut at apply time.  What depends on
W is left here:

1. the elastic metadata block of every checkpoint (:func:`elastic_metadata`,
   checked by :func:`check_metadata`; ``docs/CHECKPOINT_FORMAT.md``);
2. the pipeline drain rule: on a resize the in-flight buffers of
   ``pipeline='onestep'`` go back to the cold start (zeros, age 0) under
   ``'drain'``, or pass through under ``'keep'``;
3. the ownership delta (:func:`ownership_delta`), which slices change
   owner, for the ``reshard`` record.

``train/trainer.py::Trainer.fit_elastic`` composes them.
"""
from __future__ import annotations

import hashlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.bucketing import BucketPlan, dtype_name
from repro_torch.core.transform import tree_map
from repro_torch.schedule import ownership
from repro_torch.schedule import pipeline as pipeline_mod

# key of the elastic block inside checkpoint metadata (manifest.json)
ELASTIC_KEY = 'elastic'

PIPELINE_RULES = ('drain', 'keep')


class ReshardError(ValueError):
    """A checkpoint cannot be resharded into this run's configuration."""


def plan_fingerprint(plan: Optional[BucketPlan]) -> str:
    """Digest of a bucket plan's structure (keys, shapes, dtype names,
    paths, stacking): the reference's string for the same plan.  '' when
    nothing is preconditioned."""
    if plan is None or not plan.buckets:
        return ''
    h = hashlib.sha256()
    for b in plan.buckets:
        h.update(repr((b.key, tuple(int(d) for d in b.shape),
                       dtype_name(b.dtype), b.paths,
                       bool(b.stacked))).encode())
    return h.hexdigest()[:16]


def elastic_metadata(world: int, plan: Optional[BucketPlan] = None,
                     pipeline: str = 'sync') -> dict:
    """The block a checkpoint's metadata carries under :data:`ELASTIC_KEY`."""
    return {'world': int(world),
            'pipeline': str(pipeline),
            'plan': plan_fingerprint(plan)}


def check_metadata(meta: Optional[dict], plan: Optional[BucketPlan] = None,
                   pipeline: str = 'sync') -> int:
    """Check a checkpoint's elastic block against this run and return the
    world that wrote it (0 for a checkpoint without the block).  A plan or
    pipeline-mode mismatch raises: the configuration changed, not W."""
    if not meta:
        return 0
    want = plan_fingerprint(plan)
    got = meta.get('plan', '')
    if got != want:
        raise ReshardError(
            f'checkpoint bucket plan {got!r} != this run {want!r}: the '
            'model/capture/factor configuration changed; elastic restore '
            'only reshards across world sizes (docs/CHECKPOINT_FORMAT.md)')
    ck_pipe = meta.get('pipeline', 'sync')
    if ck_pipe != pipeline:
        raise ReshardError(
            f'checkpoint pipeline mode {ck_pipe!r} != this run '
            f'{pipeline!r}: pipeline buffers are part of the state '
            'structure; restore with the same RefreshRuntime(pipeline=...)')
    return int(meta.get('world', 0))


def check_batch_divisible(batch: Any, world: int) -> None:
    """Every batch leaf's leading dim must split evenly over W workers."""
    items = batch.items() if isinstance(batch, dict) else enumerate(batch)
    for key, x in items:
        dim0 = int(x.shape[0]) if getattr(x, 'ndim', 0) else 0
        if dim0 % int(world):
            raise ReshardError(
                f'global batch dim {dim0} of {key!r} does not divide over '
                f'world={world}: elastic resizes must keep batch % W == 0 '
                '(docs/CHECKPOINT_FORMAT.md)')


def ownership_delta(plan: Optional[BucketPlan], world_from: int,
                    world_to: int, sides: str = 'both') -> dict:
    """``{'slices_total', 'slices_moved'}``: how many refresh slices change
    owner when the maps are re-run at the new W; {} without a plan."""
    if plan is None or not plan.buckets:
        return {}
    cost = ownership.inverse_cost(sides)
    a = ownership.assign_slice_owners(plan, cost, max(1, int(world_from)))
    b = ownership.assign_slice_owners(plan, cost, max(1, int(world_to)))
    total = moved = 0
    for key in a:
        total += int(a[key].size)
        moved += int(np.sum(a[key] != b[key]))
    return {'slices_total': total, 'slices_moved': moved}


map_pipeline_states = pipeline_mod.map_pipes


def _drain_one(pipe: pipeline_mod.PipelineState
               ) -> pipeline_mod.PipelineState:
    """One slot back to the cold start: zeros, age 0."""
    buf = (tree_map(torch.zeros_like, pipe.inflight)
           if pipe.inflight is not None else None)
    return pipeline_mod.PipelineState(inflight=buf,
                                      age=torch.zeros_like(pipe.age))


def reshard_state(opt_state: Any, *, world_from: int, world_to: int,
                  plan: Optional[BucketPlan] = None,
                  step: Optional[int] = None,
                  pipeline_rule: str = 'drain',
                  source: str = 'checkpoint') -> tuple[Any, dict]:
    """Reshard an optimizer state from ``world_from`` to ``world_to``
    workers: ``(opt_state, body of a reshard record)``.  The only change is
    the pipeline rule on a real resize; at the same W the state passes
    through untouched under either rule."""
    if pipeline_rule not in PIPELINE_RULES:
        raise ValueError(f'pipeline_rule must be one of {PIPELINE_RULES}, '
                         f'got {pipeline_rule!r}')
    world_from, world_to = int(world_from), int(world_to)
    resized = world_from != world_to
    n_pipes = len(pipeline_mod.pipe_entries(opt_state))
    pipes = 'none'
    if n_pipes:
        opt_state = pipeline_mod.settle(opt_state)
        if resized and pipeline_rule == 'drain':
            opt_state = map_pipeline_states(opt_state, _drain_one)
            pipes = 'drained'
        else:
            pipes = 'kept'
    body: dict[str, Any] = {'world_from': world_from, 'world_to': world_to,
                            'pipeline': pipes, 'source': str(source)}
    if step is not None:
        body['step'] = int(step)
    body.update(ownership_delta(plan, world_from, world_to))
    return opt_state, body
