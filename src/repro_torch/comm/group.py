"""The data-parallel group in scope — the port's counterpart of the mesh axes
that the reference finds bound inside ``shard_map``
(``repro/sharding/constraints.py::data_axes_in_scope``).

The reference's explicit-DP step runs its body under ``shard_map`` over the
``'data'`` axis (or the ``('pod', 'data')`` pair), and every exchange inside
reads the axes bound there.  The port has a process group instead: a
:class:`DataScope` holds it (and, for the two-stage ``topology='pod'``
exchange, this rank's intra-pod and cross-pod subgroups), and
:func:`in_scope` makes it the scope of the code it wraps
(``train/step.py::make_dp_step`` and ``train/compression.py`` enter it).
Outside any scope every exchange is the identity and
``schedule/ownership.py::world_and_rank`` is ``(1, None)``, even with a
process group initialized, as ``make_train_step`` outside ``shard_map`` has
no bound axes in the reference.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterator, Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataScope:
    """A data-parallel group and this process's place in it.

    group: the ``torch.distributed`` group of the W data workers (None: the
      default group).  world, rank: W and this process's rank in the group.
    pods: ``(n_pods, per_pod)`` when the workers form pods, rank
      ``pod * per_pod + local`` (row-major, as the reference's
      ``('pod', 'data')`` axes); pod_group: the ranks of this rank's pod;
      cross_group: the ranks with this rank's local index in every pod.
    """
    group: Any
    world: int
    rank: int
    pods: Optional[tuple[int, int]] = None
    pod_group: Any = None
    cross_group: Any = None


_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    'repro_torch_data_scope', default=None)


def scope_of(group: Any = None) -> DataScope:
    """The scope of ``group`` (None: the default group) for this process,
    which must belong to it."""
    if isinstance(group, DataScope):
        return group
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError('this process is not a member of the group')
    return DataScope(group=group, world=int(world), rank=int(rank))


def pod_scope(pods: tuple[int, int]) -> DataScope:
    """A scope over the first ``n_pods * per_pod`` ranks of the default
    group cut into pods.  Collective: every rank of the default group calls
    it at the same point (each subgroup is made by all of them, in one
    order), members or not; a rank outside the pods gets None."""
    n_pods, per_pod = (int(p) for p in pods)
    world = n_pods * per_pod
    if world > dist.get_world_size():
        raise ValueError(f'{n_pods} pods of {per_pod} need {world} ranks, '
                         f'the group has {dist.get_world_size()}')
    rank = dist.get_rank()
    whole = (None if world == dist.get_world_size()
             else dist.new_group(ranks=list(range(world))))
    pod_groups = [dist.new_group(ranks=[p * per_pod + i
                                        for i in range(per_pod)])
                  for p in range(n_pods)]
    cross_groups = [dist.new_group(ranks=[p * per_pod + i
                                          for p in range(n_pods)])
                    for i in range(per_pod)]
    if rank >= world:
        return None
    return DataScope(group=whole, world=world, rank=rank,
                     pods=(n_pods, per_pod),
                     pod_group=pod_groups[rank // per_pod],
                     cross_group=cross_groups[rank % per_pod])


@contextlib.contextmanager
def in_scope(scope: Any) -> Iterator[DataScope]:
    """Run the wrapped code with ``scope`` (a DataScope, or a group made
    into one by :func:`scope_of`) as the data group in scope."""
    scope = scope_of(scope)
    token = _CURRENT.set(scope)
    try:
        yield scope
    finally:
        _CURRENT.reset(token)


def current() -> Optional[DataScope]:
    """The data group in scope, or None outside every scope."""
    return _CURRENT.get()


def data_axes_in_scope() -> tuple[str, ...]:
    """The reference's mesh axes the data group in scope stands for:
    ``('pod', 'data')`` for a pod scope, ``('data',)`` for any other, ()
    outside every scope."""
    sc = current()
    if sc is None:
        return ()
    return ('pod', 'data') if sc.pods is not None else ('data',)
