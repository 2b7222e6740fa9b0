"""Refresh policies: when the applied curvature snapshot is renewed.

Counterpart of ``repro/schedule/policy.py``: ``every_k``, ``warmup_then_k``
and ``adaptive`` (with its ``drift`` proxy), and ``named_policy``.  Every
decision is a device tensor: ``refresh`` is a 0-d bool, and the counters and
the snapshot advance by ``torch.where`` without waiting on the card.  A
refresh that skips work (K-FAC's and FOOF's inverses, Shampoo's roots) reads
the flag on the host once a step through :func:`on_host`, which reads
nothing for ``every_k(1)``, the one policy that refreshes on every step.
Under ``adaptive`` that read waits for the drift reduction of the step's
statistics, so the host sees the card drain once a step there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core.transform import scalar, tree_leaves, tree_map

F32 = torch.float32


class SchedState(NamedTuple):
    """Refresh bookkeeping carried inside optimizer state.

    count: int32 steps observed; since: int32 steps since the last refresh;
    n_refresh: int32 refreshes; staleness: f32 last staleness proxy;
    snapshot: the stats tree at the last refresh (f32) for a policy that
    ``wants_snapshot`` (``adaptive``), else None.
    """

    count: torch.Tensor
    since: torch.Tensor
    n_refresh: torch.Tensor
    staleness: torch.Tensor
    snapshot: Any = None


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """``decide(state, stats) -> (refresh, staleness)``, both 0-d tensors.
    ``wants_snapshot``: :func:`commit` keeps the stats of the last refresh
    for it.  ``always``: every decision is True (``every_k(1)``)."""

    name: str
    decide: Callable[[SchedState, Any], tuple[torch.Tensor, torch.Tensor]]
    wants_snapshot: bool = False
    always: bool = False


def init_state(policy: RefreshPolicy, stats_template: Any,
               device) -> SchedState:
    """Zeroed counters; an f32 zero snapshot shaped as ``stats_template``
    only when the policy wants one."""
    snap = None
    if policy.wants_snapshot and stats_template is not None:
        snap = tree_map(lambda x: torch.zeros(x.shape, dtype=F32,
                                              device=x.device),
                        stats_template)
    z = scalar(0, device, torch.int32)
    return SchedState(count=z, since=z, n_refresh=z,
                      staleness=scalar(0.0, device), snapshot=snap)


def commit(policy: RefreshPolicy, state: SchedState, stats: Any,
           refresh: torch.Tensor, staleness: torch.Tensor) -> SchedState:
    """Advance the counters after a decided step; the snapshot takes the
    fresh stats where the step refreshed."""
    snap = state.snapshot
    if policy.wants_snapshot and snap is not None:
        snap = tree_map(lambda s, f: torch.where(refresh, f.to(s.dtype), s),
                        snap, stats)
    return SchedState(
        count=state.count + 1,
        since=torch.where(refresh, torch.zeros_like(state.since),
                          state.since + 1),
        n_refresh=state.n_refresh + refresh.to(torch.int32),
        staleness=staleness.to(F32),
        snapshot=snap)


# ---------------------------------------------------------------------------
# Policies


def every_k(k: int = 1) -> RefreshPolicy:
    """Refresh every ``k`` steps (step 0 always refreshes)."""
    if k < 1:
        raise ValueError(f'every_k needs k >= 1, got {k}')

    def decide(state: SchedState, stats):
        del stats
        return (state.count % k) == 0, state.since.to(F32)

    return RefreshPolicy(name=f'every_k({k})', decide=decide, always=k == 1)


def warmup_then_k(warmup: int, k: int) -> RefreshPolicy:
    """Refresh every step for the first ``warmup`` steps, then every
    ``k``."""
    if warmup < 0 or k < 1:
        raise ValueError(f'warmup_then_k needs warmup >= 0, k >= 1; '
                         f'got ({warmup}, {k})')

    def decide(state: SchedState, stats):
        del stats
        in_warmup = state.count < warmup
        periodic = ((state.count - warmup) % k) == 0
        return in_warmup | periodic, state.since.to(F32)

    return RefreshPolicy(name=f'warmup_then_k({warmup},{k})', decide=decide)


def drift(snapshot: Any, stats: Any) -> torch.Tensor:
    """‖stats − snapshot‖ / (‖snapshot‖ + ε) over all leaves, in f32: each
    sum of squares added to an f32 zero in the reference's leaf order."""
    def sq(t):
        leaves = tree_leaves(t)
        total = torch.zeros((), dtype=F32, device=leaves[0].device)
        for x in leaves:
            total = total + x.to(F32).square().sum()
        return total

    diff = tree_map(lambda s, f: f.to(F32) - s.to(F32), snapshot, stats)
    return torch.sqrt(sq(diff)) / (torch.sqrt(sq(snapshot)) + 1e-12)


def adaptive(threshold: float = 0.05,
             max_interval: Optional[int] = None) -> RefreshPolicy:
    """Refresh when the stats' relative drift since the last refresh
    exceeds ``threshold``; always at step 0, and at least every
    ``max_interval`` steps when given."""
    if threshold <= 0:
        raise ValueError(f'adaptive needs threshold > 0, got {threshold}')

    def decide(state: SchedState, stats):
        if state.snapshot is None:
            raise ValueError(
                'adaptive policy found no drift snapshot in SchedState: the '
                'optimizer state was initialized under a different policy.  '
                'Pass the same policy (or the same Extras.sched runtime) to '
                'init and update.')
        d = drift(state.snapshot, stats)
        first = state.count == 0
        refresh = first | (d > threshold)
        if max_interval is not None:
            refresh = refresh | (state.since >= (max_interval - 1))
        # step 0 drifts from the zero snapshot: not logged as staleness
        return refresh, torch.where(first, torch.zeros_like(d), d)

    return RefreshPolicy(name=f'adaptive({threshold})', decide=decide,
                         wants_snapshot=True)


_NAMED: dict[str, Callable[..., RefreshPolicy]] = {
    'every_k': every_k,
    'warmup_then_k': warmup_then_k,
    'adaptive': adaptive,
}


def named_policy(name: str, **kwargs) -> RefreshPolicy:
    """``named_policy('every_k', k=5)``: a policy by its registry name."""
    if name not in _NAMED:
        raise KeyError(f'unknown policy {name!r}; have {sorted(_NAMED)}')
    return _NAMED[name](**kwargs)


def on_host(policy: RefreshPolicy, refresh: torch.Tensor) -> bool:
    """The decision ``refresh`` as a host bool, to skip the work of a step
    that keeps the old values.  Reading it waits for the card (one sync);
    a policy that always refreshes needs no read.  A fake decision (the
    cost trace, ``launch/hlo_analysis.py``) has no value: the trace takes
    the refresh, whose work the reference's one-program analysis counts
    too."""
    if policy.always or isinstance(refresh, FakeTensor):
        return True
    return bool(refresh)


def resolve(policy: Optional[RefreshPolicy], interval: int = 1
            ) -> RefreshPolicy:
    """An explicit policy wins; otherwise ``every_k(interval)``."""
    return policy if policy is not None else every_k(interval)
