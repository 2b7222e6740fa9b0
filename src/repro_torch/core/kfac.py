"""K-FAC baseline (paper Eq. 5) through the refresh runtime — PyTorch port
of ``repro/core/kfac.py``.

The Kronecker factors A = E[a aᵀ] and B = E[z̃ z̃ᵀ] are EMA'd every step; the
damped inverses (π-split damping) are recomputed when the refresh policy
fires and cached, bucket-stacked.  With ``Extras.factor`` tripping a
bucket (``core/factor_sharded``), its oversized side is applied matrix-free
from the live EMA through the ``matvec_cols`` kernel instead of being
inverted.  The fresh factors are reduced over the data group in scope
(``pipeline.staged_pmean`` with the ``Extras.comm`` stats codec, the one
statistics exchange worth compressing: O(d²) a layer), and the refresh is
shared among its workers (``schedule/runtime.py::sharded_refresh``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import bucketing
from repro_torch.core import factor_sharded as fsh
from repro_torch.core import kv as kvlib
from repro_torch.core import precondition as pre
from repro_torch.core.clipping import Epilogue, fused_tail, kl_clip_trace
from repro_torch.comm import exchange as comm_exchange
from repro_torch.core.eva import _extract, _stats_plan, _zeros_like_spec
from repro_torch.core.transform import (Extras, GradientTransformation,
                                        add_decayed_weights, chain, ema_trace,
                                        scale_by_schedule, tree_device)
from repro_torch.schedule import ownership
from repro_torch.schedule import pipeline as pipemod
from repro_torch.schedule import policy as schedpol
from repro_torch.schedule import runtime as schedrt

class KfacState(NamedTuple):
    running: kvlib.RunningStats
    a_inv: dict
    b_inv: dict
    sched: schedpol.SchedState
    # 'onestep': {'stats': PipelineState (the reduced factors in flight),
    # 'refresh': PipelineState (age only: a_inv / b_inv are the buffer)}
    pipe: Any = None
    # sharded-factor head buckets (Extras.factor tripped): cached dense-side
    # operators + frozen dampings.  None on the all-dense legacy path.
    head: Any = None


def kfac_preconditioner(gamma: float = 0.03, kf_decay: float = 0.95,
                        interval: int = 1,
                        policy: Optional[schedpol.RefreshPolicy] = None
                        ) -> GradientTransformation:
    fields = ('a_outer', 'b_outer')

    def init(params, extras: Optional[Extras] = None):
        if extras is None or extras.stats is None:
            raise ValueError('kfac_preconditioner.init needs example stats')
        flat = kvlib.flatten_params(params)
        plan = _stats_plan(flat, extras.stats, extras)
        zeros = bucketing.gather_tree(
            plan, _zeros_like_spec(_extract(extras.stats, fields)))
        run = kvlib.init_running(zeros)
        fcfg = fsh.from_extras(extras)
        _, head_pol = fsh.split_plan(plan, fcfg)
        a_inv = {k: torch.zeros_like(st.a_outer)
                 for k, st in run.stats.items() if k not in head_pol}
        b_inv = {k: torch.zeros_like(st.b_outer)
                 for k, st in run.stats.items() if k not in head_pol}
        head = fsh.init_head(
            {k: (run.stats[k].a_outer, run.stats[k].b_outer)
             for k in head_pol}, head_pol, fcfg, plan)
        rt = schedrt.from_extras(extras)
        pol = rt.resolve(policy, interval)
        dev = tree_device(params)
        return KfacState(running=run, a_inv=a_inv, b_inv=b_inv,
                         sched=schedpol.init_state(pol, run.stats, dev),
                         pipe=schedrt.init_pipe(rt, dev, zeros), head=head)

    def update(updates, state: KfacState, params=None,
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
            codec=comm.stats, site='stats/kfac')
        stats, running = kvlib.update_running(state.running, fresh, kf_decay)

        def one(b, args):
            del b
            ao, bo = args
            gamma_r, gamma_q = pre.kfac_pi_damping(ao, bo, gamma)
            return pre._damped_inv(ao, gamma_r), pre._damped_inv(bo, gamma_q)

        fcfg = fsh.from_extras(extras)
        dense_plan, head_pol = fsh.split_plan(plan, fcfg)
        refresh, staleness = pol.decide(state.sched, stats)
        # the dense sides are recomputed only on a refresh step, decided on
        # the host once for the step
        do_refresh = schedpol.on_host(pol, refresh)
        staged = schedrt.sharded_refresh(
            dense_plan, do_refresh, one,
            {k: (st.a_outer, st.b_outer) for k, st in stats.items()
             if k not in head_pol},
            {k: (state.a_inv[k], state.b_inv[k]) for k in state.a_inv},
            cost=ownership.inverse_cost('both'), shard=rt.shard_refresh,
            comm=comm, site='refresh/kfac',
            pipe=None if pipe is None else pipe['refresh'])
        if pipe is None:
            used = new = staged
            new_pipe = None
        else:
            used, new, pipe_ref = staged
            new_pipe = {'stats': pipe_stats, 'refresh': pipe_ref}
        a_inv = {k: v[0] for k, v in new.items()}
        b_inv = {k: v[1] for k, v in new.items()}
        # the small dense side of a head bucket is recomputed under the same
        # gate; the oversized side is applied matrix-free from the live EMA
        head_factors = {k: (stats[k].a_outer, stats[k].b_outer)
                        for k in head_pol}
        head = fsh.refresh_head(do_refresh, head_factors, state.head, head_pol,
                                gamma, method='kfac')
        sched = schedpol.commit(pol, state.sched, stats, refresh, staleness)

        ops = {k: kvlib.LayerStats(a_outer=v[0], b_outer=v[1])
               for k, v in used.items()}
        out = pre.precondition_tree(flat, ops, 'kfac_cached', gamma,
                                    plan=dense_plan)
        if head_pol:
            out = fsh.apply_tree(out, plan, head_pol, head, head_factors,
                                 power=1.0, cfg=fcfg, site='factor/kfac')
        return out, KfacState(
            running=running, a_inv=a_inv, b_inv=b_inv, sched=sched,
            pipe=new_pipe, head=head)

    return GradientTransformation(init, update)


def kfac(lr=0.1, gamma: float = 0.03, kf_decay: float = 0.95,
         interval: int = 1, kl_kappa: Optional[float] = 1e-3,
         momentum: float = 0.9, weight_decay: float = 0.0,
         policy: Optional[schedpol.RefreshPolicy] = None,
         fused: bool = False) -> GradientTransformation:
    """K-FAC as evaluated in the paper.  ``fused=True`` runs the trust
    region + momentum tail as one ``clipping.fused_tail``; the math is the
    same.  The factor-sharded solve's kernel impl comes with
    ``Extras.factor`` (``FactorShardConfig.impl``)."""
    parts = []
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(kfac_preconditioner(gamma, kf_decay, interval, policy=policy))
    if kl_kappa is not None and fused:
        parts.append(fused_tail(Epilogue(kind='kl_clip', kappa=kl_kappa,
                                         lr=lr, momentum=momentum)))
    elif kl_kappa is not None:
        # momentum lives inside the trust region (clipping.kl_clip_trace)
        parts.append(kl_clip_trace(kl_kappa, lr, momentum))
    else:
        parts.append(ema_trace(momentum))
    parts.append(scale_by_schedule(lr if callable(lr) else (lambda _: lr)))
    return chain(*parts)


CAPTURE = kvlib.KFAC_CAPTURE
