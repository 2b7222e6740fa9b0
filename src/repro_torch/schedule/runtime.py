"""RefreshRuntime: the train-level refresh configuration — PyTorch port.

Counterpart of ``repro/schedule/runtime.py`` for one device and the
``'sync'`` pipeline.  The reference's worker-sharded refresh, owned-slice
exchange and ``'onestep'`` pipeline need a mesh and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.schedule import policy as policy_mod


@dataclasses.dataclass(frozen=True)
class RefreshRuntime:
    """policy: the default policy for optimizers built without one (their
    ``interval`` kwarg wins when set ≠ 1).  pipeline: only ``'sync'`` —
    statistics are applied in the step that produced them."""

    policy: Optional[policy_mod.RefreshPolicy] = None
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
