"""Curvature refresh runtime (paper Fig. 6, §3.3), as in ``repro.schedule``:
``policy`` (when a refresh fires), ``ownership`` (which worker recomputes a
slice), ``pipeline`` (the one-step-stale exchange), ``runtime`` (the
façade the optimizers and the step talk to) and ``reshard`` (elastic
resizes)."""
from repro_torch.schedule.policy import (SchedState, RefreshPolicy, adaptive,
                                         every_k, init_state, commit,
                                         named_policy, warmup_then_k)
from repro_torch.schedule.ownership import (assign_owners,
                                            describe_ownership,
                                            inverse_cost, world_and_rank)
from repro_torch.schedule.pipeline import (PipelineState, pipe_entries,
                                           pipeline_metrics, staged_pmean)
from repro_torch.schedule.runtime import (RefreshRuntime, from_extras,
                                          ownership_event, resolve_pipe,
                                          sched_states, schedule_metrics,
                                          sharded_refresh)
from repro_torch.schedule.reshard import (ELASTIC_KEY, ReshardError,
                                          check_metadata, elastic_metadata,
                                          ownership_delta, plan_fingerprint,
                                          reshard_state)

__all__ = [
    'SchedState', 'RefreshPolicy', 'every_k', 'warmup_then_k', 'adaptive',
    'named_policy', 'init_state', 'commit',
    'assign_owners', 'describe_ownership', 'inverse_cost', 'world_and_rank',
    'PipelineState', 'pipe_entries', 'pipeline_metrics', 'staged_pmean',
    'RefreshRuntime', 'from_extras', 'ownership_event', 'resolve_pipe',
    'sched_states', 'schedule_metrics', 'sharded_refresh',
    'ELASTIC_KEY', 'ReshardError', 'check_metadata', 'elastic_metadata',
    'ownership_delta', 'plan_fingerprint', 'reshard_state',
]
