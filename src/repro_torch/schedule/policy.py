"""Refresh policies: when the applied curvature snapshot is renewed.

Counterpart of ``repro/schedule/policy.py``, with the ``every_k`` policy that
Eva uses.  Every decision is a device tensor: ``refresh`` is a 0-d bool, and
the counters advance by ``torch.where`` without waiting on the card.  A
refresh that skips work (K-FAC's inverses, Shampoo's roots) reads the flag
on the host once a step through :func:`on_host`, which reads nothing for a
policy that refreshes on every step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.transform import scalar


class SchedState(NamedTuple):
    """Refresh bookkeeping carried inside optimizer state.

    count: int32 steps observed; since: int32 steps since the last refresh;
    n_refresh: int32 refreshes; staleness: f32 last staleness proxy;
    snapshot: unused by ``every_k`` (None).
    """

    count: torch.Tensor
    since: torch.Tensor
    n_refresh: torch.Tensor
    staleness: torch.Tensor
    snapshot: Any = None


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """``decide(state, stats) -> (refresh, staleness)``, both 0-d tensors.
    ``always``: every decision is True (``every_k(1)``)."""

    name: str
    decide: Callable[[SchedState, Any], tuple[torch.Tensor, torch.Tensor]]
    wants_snapshot: bool = False
    always: bool = False


def init_state(policy: RefreshPolicy, stats_template: Any,
               device) -> SchedState:
    if policy.wants_snapshot:
        raise NotImplementedError('snapshot policies are not ported yet')
    z = scalar(0, device, torch.int32)
    return SchedState(count=z, since=z, n_refresh=z,
                      staleness=scalar(0.0, device))


def commit(policy: RefreshPolicy, state: SchedState, stats: Any,
           refresh: torch.Tensor, staleness: torch.Tensor) -> SchedState:
    """Advance the counters after a decided step."""
    del policy, stats
    return SchedState(
        count=state.count + 1,
        since=torch.where(refresh, torch.zeros_like(state.since),
                          state.since + 1),
        n_refresh=state.n_refresh + refresh.to(torch.int32),
        staleness=staleness.to(torch.float32),
        snapshot=state.snapshot)


def every_k(k: int = 1) -> RefreshPolicy:
    """Refresh every ``k`` steps (step 0 always refreshes)."""
    if k < 1:
        raise ValueError(f'every_k needs k >= 1, got {k}')

    def decide(state: SchedState, stats):
        del stats
        return (state.count % k) == 0, state.since.to(torch.float32)

    return RefreshPolicy(name=f'every_k({k})', decide=decide, always=k == 1)


def on_host(policy: RefreshPolicy, refresh: torch.Tensor) -> bool:
    """The decision ``refresh`` as a host bool, to skip the work of a step
    that keeps the old values.  Reading it waits for the card (one sync);
    a policy that always refreshes needs no read."""
    return policy.always or bool(refresh)


def resolve(policy: Optional[RefreshPolicy], interval: int = 1
            ) -> RefreshPolicy:
    """An explicit policy wins; otherwise ``every_k(interval)``."""
    return policy if policy is not None else every_k(interval)
