"""FOOF baseline (paper Eq. 6): right-side K-FAC, C = I ⊗ AAᵀ — PyTorch port
of ``repro/core/foof.py``.

The AAᵀ EMA and the cached damped inverses live bucket-stacked.  The
inverses are recomputed through ``schedule.runtime.sharded_refresh`` (input
factor only, so its cost model is ``inverse_cost('left')``) when the refresh
policy fires, decided on the host once a step, and skipped otherwise, as
K-FAC's are; they are applied with one batched product per stacked bucket
(``precondition_tree``'s ``foof_cached``).  The fresh AAᵀ is reduced over
the data group in scope (``pipeline.staged_pmean``, the ``Extras.comm``
stats codec).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import bucketing
from repro_torch.core import kv as kvlib
from repro_torch.core import precondition as pre
from repro_torch.core.clipping import Epilogue, fused_tail, kl_normalize
from repro_torch.comm import exchange as comm_exchange
from repro_torch.core.eva import _extract, _stats_plan, _zeros_like_spec
from repro_torch.core.transform import (Extras, GradientTransformation,
                                        add_decayed_weights, chain, ema_trace,
                                        scale_by_schedule, tree_device)
from repro_torch.schedule import ownership
from repro_torch.schedule import pipeline as pipemod
from repro_torch.schedule import policy as schedpol
from repro_torch.schedule import runtime as schedrt


class FoofState(NamedTuple):
    running: kvlib.RunningStats
    a_inv: dict
    sched: schedpol.SchedState
    # 'onestep': {'stats': PipelineState (the reduced AAᵀ in flight),
    # 'refresh': PipelineState (age only: a_inv is the buffer)}
    pipe: Any = None


def foof_preconditioner(gamma: float = 0.03, kf_decay: float = 0.95,
                        interval: int = 1,
                        policy: Optional[schedpol.RefreshPolicy] = None
                        ) -> GradientTransformation:
    fields = ('a_outer',)

    def init(params, extras: Optional[Extras] = None):
        if extras is None or extras.stats is None:
            raise ValueError('foof_preconditioner.init needs example stats')
        flat = kvlib.flatten_params(params)
        plan = _stats_plan(flat, extras.stats, extras)
        zeros = bucketing.gather_tree(
            plan, _zeros_like_spec(_extract(extras.stats, fields)))
        run = kvlib.init_running(zeros)
        a_inv = {k: torch.zeros_like(st.a_outer)
                 for k, st in run.stats.items()}
        rt = schedrt.from_extras(extras)
        pol = rt.resolve(policy, interval)
        dev = tree_device(params)
        return FoofState(running=run, a_inv=a_inv,
                         sched=schedpol.init_state(pol, run.stats, dev),
                         pipe=schedrt.init_pipe(rt, dev, zeros))

    def update(updates, state: FoofState, params=None,
               extras: Optional[Extras] = None):
        del params
        rt = schedrt.from_extras(extras)
        comm = comm_exchange.from_extras(extras)
        pol = rt.resolve(policy, interval)
        pipe = schedrt.resolve_pipe(rt, state.pipe)
        flat = kvlib.flatten_params(updates)
        fresh_flat = _extract(extras.stats, fields)
        plan = _stats_plan(flat, fresh_flat, extras)
        fresh, pipe_stats = pipemod.staged_pmean(
            bucketing.gather_tree(plan, fresh_flat),
            None if pipe is None else pipe['stats'],
            codec=comm.stats, site='stats/foof')
        stats, running = kvlib.update_running(state.running, fresh, kf_decay)

        refresh, staleness = pol.decide(state.sched, stats)
        staged = schedrt.sharded_refresh(
            plan, schedpol.on_host(pol, refresh),
            lambda b, m: pre._damped_inv(m, gamma),
            {k: st.a_outer for k, st in stats.items()}, dict(state.a_inv),
            cost=ownership.inverse_cost('left'), shard=rt.shard_refresh,
            comm=comm, site='refresh/foof',
            pipe=None if pipe is None else pipe['refresh'])
        if pipe is None:
            used = a_inv = staged
            new_pipe = None
        else:
            used, a_inv, pipe_ref = staged
            new_pipe = {'stats': pipe_stats, 'refresh': pipe_ref}
        sched = schedpol.commit(pol, state.sched, stats, refresh, staleness)

        ops = {k: kvlib.LayerStats(a_outer=v) for k, v in used.items()}
        out = pre.precondition_tree(flat, ops, 'foof_cached', gamma,
                                    plan=plan)
        return out, FoofState(running=running, a_inv=a_inv, sched=sched,
                              pipe=new_pipe)

    return GradientTransformation(init, update)


def foof(lr=0.1, gamma: float = 0.03, kf_decay: float = 0.95,
         interval: int = 1, momentum: float = 0.9, weight_decay: float = 0.0,
         policy: Optional[schedpol.RefreshPolicy] = None,
         fused: bool = False) -> GradientTransformation:
    """FOOF as evaluated in the paper.  ``fused=True`` runs the KL normalize
    and EMA momentum tail as one ``clipping.fused_tail``; the math is the
    same."""
    parts = []
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(foof_preconditioner(gamma, kf_decay, interval, policy=policy))
    if fused:
        parts.append(fused_tail(Epilogue(kind='kl_normalize',
                                         momentum=momentum)))
    else:
        parts.append(kl_normalize())
        parts.append(ema_trace(momentum))
    parts.append(scale_by_schedule(lr if callable(lr) else (lambda _: lr)))
    return chain(*parts)


CAPTURE = kvlib.FOOF_CAPTURE
