"""Work ownership across data-parallel workers — PyTorch port of
``repro/schedule/ownership.py``.

Which worker recomputes which bucket item, deterministically at two
granularities: per stack row (:func:`assign_owners`, the LPT greedy, kept
as the simple reference) and per (row x lead-dim) slice
(:func:`assign_slice_owners`, what the refresh runtime shards at;
:func:`assign_pod_slice_owners` keeps every bucket inside one pod), so
refresh work scales 1/W.  Below one slice, :func:`factor_block` and
:func:`assign_subslice_owners` cut one oversized Kronecker factor into
contiguous row bands (``core/factor_sharded.py``).  The maps are numpy,
the same integers as the reference's, and pure functions of (plan, cost,
world) on every worker.  :func:`world_and_rank` reads the data group in
scope (``comm/group.py``): ``(1, None)`` outside one.
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np

from repro_torch.comm import group as group_mod
from repro_torch.core.bucketing import Bucket, BucketPlan


def inverse_cost(sides: str = 'both') -> Callable[[Bucket], float]:
    """Flop estimate for refreshing one item of a bucket: cubic in each
    factor dim, times the product of the leading (scan/expert) dims.
    sides: 'left' (input factor only) or 'both' (K-FAC, Shampoo)."""
    if sides not in ('left', 'both'):
        raise ValueError(f"sides must be 'left' or 'both', got {sides!r}")

    def cost(bucket: Bucket) -> float:
        d_in, d_out = bucket.shape[-2], bucket.shape[-1]
        c = float(d_in) ** 3
        if sides == 'both':
            c += float(d_out) ** 3
        return lead_size(bucket) * c

    return cost


def lead_size(bucket: Bucket) -> int:
    """Product of a bucket's leading (scan/expert-stack) dims: the number of
    factor pairs one stack row carries."""
    lead = 1
    for d in bucket.shape[:-2]:
        lead *= int(d)
    return lead


# ---------------------------------------------------------------------------
# Assignment (the same integer maps as the reference's)


@functools.lru_cache(maxsize=256)
def _assign_cached(plan: BucketPlan, costs: tuple, world: int,
                   counts: tuple) -> dict:
    owners = {b.key: np.zeros(n, np.int64)
              for b, n in zip(plan.buckets, counts)}
    if world > 1:
        items = [(costs[bi], b.key, i)
                 for bi, b in enumerate(plan.buckets)
                 for i in range(counts[bi])]
        # LPT greedy: biggest items first, each to the least-loaded
        # worker; ties broken by (key, item), so every host gets one map
        items.sort(key=lambda t: (-t[0], t[1], t[2]))
        loads = np.zeros(world, np.float64)
        for c, key, i in items:
            w = int(np.argmin(loads))
            owners[key][i] = w
            loads[w] += c
    return owners


def assign_owners(plan: BucketPlan, cost: Callable[[Bucket], float],
                  world: int) -> dict[str, np.ndarray]:
    """{bucket_key: (N,) owner ranks}, one per stack row (parameter path):
    the row-level map, kept as the reference the slice map is tested
    against."""
    costs = tuple(cost(b) for b in plan.buckets)
    counts = tuple(len(b.paths) for b in plan.buckets)
    return _assign_cached(plan, costs, world, counts)


@functools.lru_cache(maxsize=256)
def _assign_slices_cached(plan: BucketPlan, costs: tuple, world: int,
                          counts: tuple) -> dict:
    owners = {b.key: np.zeros(n, np.int64)
              for b, n in zip(plan.buckets, counts)}
    if world > 1:
        order = sorted(range(len(plan.buckets)),
                       key=lambda bi: (-costs[bi], plan.buckets[bi].key))
        loads = np.zeros(world, np.float64)
        for bi in order:
            key = plan.buckets[bi].key
            per = np.zeros(world, np.int64)
            for i in range(counts[bi]):
                # per-bucket balance first (counts differ by <= 1, which
                # keeps the padded all-gather smallest), the global cost
                # load as the tie-break; first-min ties keep it determinate
                cand = np.flatnonzero(per == per.min())
                w = int(cand[np.argmin(loads[cand])])
                owners[key][i] = w
                per[w] += 1
                loads[w] += costs[bi]
    return owners


def assign_slice_owners(plan: BucketPlan, cost: Callable[[Bucket], float],
                        world: int) -> dict[str, np.ndarray]:
    """{bucket_key: (N·lead,) owner ranks}: ownership per (row, lead-slice),
    row-major.  Within a bucket every slice costs ``cost(bucket)/lead``, so
    each bucket's slice count is balanced first (per-worker counts differ
    by at most one) and ties go to the least global load, buckets visited
    biggest slice first."""
    costs = tuple(cost(b) / lead_size(b) for b in plan.buckets)
    counts = tuple(len(b.paths) * lead_size(b) for b in plan.buckets)
    return _assign_slices_cached(plan, costs, world, counts)


@functools.lru_cache(maxsize=256)
def _assign_pod_cached(plan: BucketPlan, costs: tuple, pods: tuple,
                       counts: tuple) -> dict:
    n_pods, per_pod = pods
    owners = {b.key: np.zeros(n, np.int64)
              for b, n in zip(plan.buckets, counts)}
    if n_pods * per_pod > 1:
        # whole buckets LPT over pods (biggest total first, to the least
        # loaded pod), so a bucket's slice gather stays inside one pod
        order = sorted(range(len(plan.buckets)),
                       key=lambda bi: (-costs[bi] * counts[bi],
                                       plan.buckets[bi].key))
        pod_loads = np.zeros(n_pods, np.float64)
        for bi in order:
            key = plan.buckets[bi].key
            pod = int(np.argmin(pod_loads))
            pod_loads[pod] += costs[bi] * counts[bi]
            # inside the pod: slice counts balanced over its workers
            for i in range(counts[bi]):
                owners[key][i] = pod * per_pod + i % per_pod
    return owners


def assign_pod_slice_owners(plan: BucketPlan, cost: Callable[[Bucket], float],
                            pods: tuple[int, int]) -> dict[str, np.ndarray]:
    """Slice owners under ``(n_pods, per_pod)``: every bucket's slices are
    owned inside one pod (buckets balanced over pods by total cost, slices
    by count within the pod).  Ranks are ``pod * per_pod + local``."""
    costs = tuple(cost(b) / lead_size(b) for b in plan.buckets)
    counts = tuple(len(b.paths) * lead_size(b) for b in plan.buckets)
    return _assign_pod_cached(plan, costs, tuple(pods), counts)


def describe_ownership(plan: BucketPlan, world: int,
                       sides: str = 'both') -> dict[str, list[int]]:
    """{bucket_key: [slices owned by worker 0, 1, ...]} (trainer logs)."""
    owners = assign_slice_owners(plan, inverse_cost(sides), world)
    return {k: np.bincount(v, minlength=world).tolist()
            for k, v in owners.items()}


def factor_block(d: int, world: int) -> int:
    """Rows per worker of a (d, d) factor cut into contiguous row bands:
    ``ceil(d / world)``.  Worker ``w`` holds rows ``[w*B, (w+1)*B)`` of the
    factor zero-padded to ``(world*B, d)``."""
    return -(-int(d) // int(world))


def subslice_trips(bucket: Bucket, threshold: int) -> tuple[bool, bool]:
    """(in_side, out_side): which factor sides of ``bucket`` reach the
    ``shard_threshold`` (factor dim >= threshold)."""
    d_in, d_out = int(bucket.shape[-2]), int(bucket.shape[-1])
    return d_in >= int(threshold), d_out >= int(threshold)


def assign_subslice_owners(d: int, world: int) -> np.ndarray:
    """(world,) int64: row band ``b`` of a factor is worker ``b``'s, the
    uniform LPT map below slice granularity."""
    return np.arange(int(world), dtype=np.int64)


def describe_subslices(plan: BucketPlan, world: int,
                       threshold: int) -> dict[str, list[int]]:
    """{'<bucket_key>/<in|out>': [rows owned by worker 0, 1, ...]} for every
    tripped factor side (trainer logs)."""
    out: dict[str, list[int]] = {}
    for b in plan.buckets:
        trips = subslice_trips(b, threshold)
        for side, tripped, d in (('in', trips[0], int(b.shape[-2])),
                                 ('out', trips[1], int(b.shape[-1]))):
            if tripped:
                blk = factor_block(d, world)
                out[f'{b.key}/{side}'] = [
                    max(0, min(blk, d - w * blk)) for w in range(world)]
    return out


def world_and_rank():
    """(world, rank) of this process among the data workers in scope: W and
    its rank (a Python int) in the scope's group, or ``(1, None)`` outside
    any scope or with one worker (every band and slice is this worker's,
    and nothing needs an exchange)."""
    scope = group_mod.current()
    if scope is None or scope.world <= 1:
        return 1, None
    return scope.world, scope.rank
