"""Shampoo baseline (paper Eq. 8, k=2) with a refresh interval and grafting
— PyTorch port of ``repro/core/shampoo.py``.

The statistics accumulate Adagrad-style (M_in += G Gᵀ, M_out += Gᵀ G from
an ε·I start); the inverse 4th roots (M + γI)^{-1/4} are recomputed through
``torch.linalg.eigh`` when the refresh policy fires and cached,
bucket-stacked.  Grafting to the gradient magnitude follows the paper's
§4.2.  With ``Extras.factor`` tripping a bucket (``core/factor_sharded``),
its oversized side is applied matrix-free by the binomial series through
the ``matvec_cols`` kernel instead of being eigendecomposed.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.comm import exchange as comm_exchange
from repro_torch.core import bucketing
from repro_torch.core import factor_sharded as fsh
from repro_torch.core import kv as kvlib
from repro_torch.core import precondition as pre
from repro_torch.core.clipping import (Epilogue, fused_tail,
                                       graft_to_grad_magnitude)
from repro_torch.core.eva_s import default_precon_predicate
from repro_torch.core.transform import (Extras, GradientTransformation,
                                        add_decayed_weights, chain, ema_trace,
                                        scale_by_schedule, tree_device)
from repro_torch.schedule import ownership
from repro_torch.schedule import policy as schedpol
from repro_torch.schedule import runtime as schedrt

F32 = torch.float32


class ShampooState(NamedTuple):
    m_in: dict    # {bucket: (N, ..., d_in, d_in)}
    m_out: dict   # {bucket: (N, ..., d_out, d_out)}
    p_in: dict    # cached (M + γI)^{-1/4}
    p_out: dict
    sched: schedpol.SchedState
    # 'onestep': {'refresh': PipelineState (age only: p_in / p_out are the
    # buffer)}.  The accumulators come from the local gradients (already
    # reduced), so only the refresh exchange is staged.
    pipe: Any = None
    # sharded-factor head buckets (Extras.factor tripped): cached dense-side
    # roots + frozen dampings.  None on the all-dense legacy path.
    head: Any = None


def _eps_eye(eps: float, lead: tuple, d: int, device) -> torch.Tensor:
    eye = torch.eye(d, dtype=F32, device=device)
    return (eps * eye).expand(lead + (d, d)).contiguous()


def shampoo_preconditioner(gamma: float = 1e-4, eps_init: float = 1e-6,
                           interval: int = 1,
                           policy: Optional[schedpol.RefreshPolicy] = None,
                           predicate=default_precon_predicate
                           ) -> GradientTransformation:

    def init(params, extras: Optional[Extras] = None):
        flat = kvlib.flatten_params(params)
        plan = bucketing.build_plan(flat, predicate)
        dev = tree_device(params)
        m_in, m_out = {}, {}
        for b in plan.buckets:
            lead = (len(b.paths),) + tuple(b.shape[:-2])
            m_in[b.key] = _eps_eye(eps_init, lead, b.shape[-2], dev)
            m_out[b.key] = _eps_eye(eps_init, lead, b.shape[-1], dev)
        rt = schedrt.from_extras(extras)
        pol = rt.resolve(policy, interval)
        fcfg = fsh.from_extras(extras)
        _, head_pol = fsh.split_plan(plan, fcfg)
        head = fsh.init_head({k: (m_in[k], m_out[k]) for k in head_pol},
                             head_pol, fcfg, plan)
        return ShampooState(
            m_in=m_in, m_out=m_out,
            p_in={k: torch.zeros_like(v) for k, v in m_in.items()
                  if k not in head_pol},
            p_out={k: torch.zeros_like(v) for k, v in m_out.items()
                   if k not in head_pol},
            sched=schedpol.init_state(pol, {'m_in': m_in, 'm_out': m_out},
                                      dev),
            pipe=schedrt.init_pipe(rt, dev), head=head)

    def update(updates, state: ShampooState, params=None,
               extras: Optional[Extras] = None):
        del params
        rt = schedrt.from_extras(extras)
        pol = rt.resolve(policy, interval)
        pipe = schedrt.resolve_pipe(rt, state.pipe)
        flat = kvlib.flatten_params(updates)
        plan = bucketing.build_plan(flat, predicate)
        g_b = bucketing.gather(plan, {p: flat[p] for p in plan.paths})
        m_in, m_out = {}, {}
        for b in plan.buckets:
            g = g_b[b.key].to(F32)
            m_in[b.key] = state.m_in[b.key] + g @ g.transpose(-1, -2)
            m_out[b.key] = state.m_out[b.key] + g.transpose(-1, -2) @ g

        accum = {'m_in': m_in, 'm_out': m_out}
        refresh, staleness = pol.decide(state.sched, accum)

        def one(b, args):
            del b
            mi, mo = args
            return (pre._inv_proot_psd(mi, gamma, 0.25),
                    pre._inv_proot_psd(mo, gamma, 0.25))

        fcfg = fsh.from_extras(extras)
        dense_plan, head_pol = fsh.split_plan(plan, fcfg)
        # the dense sides are recomputed only on a refresh step, decided on
        # the host once for the step
        do_refresh = schedpol.on_host(pol, refresh)
        staged = schedrt.sharded_refresh(
            dense_plan, do_refresh, one,
            {k: (m_in[k], m_out[k]) for k in m_in if k not in head_pol},
            {k: (state.p_in[k], state.p_out[k]) for k in state.p_in},
            cost=ownership.inverse_cost('both'), shard=rt.shard_refresh,
            comm=comm_exchange.from_extras(extras), site='refresh/shampoo',
            pipe=None if pipe is None else pipe['refresh'])
        if pipe is None:
            used = new = staged
            new_pipe = None
        else:
            used, new, pipe_ref = staged
            new_pipe = {'refresh': pipe_ref}
        p_in = {k: v[0] for k, v in new.items()}
        p_out = {k: v[1] for k, v in new.items()}
        # head buckets skip the root refresh: the oversized side is applied
        # matrix-free (binomial series for the −1/4 root) from the live
        # accumulator in factor_sharded
        head_factors = {k: (m_in[k], m_out[k]) for k in head_pol}
        head = fsh.refresh_head(do_refresh, head_factors, state.head, head_pol,
                                gamma, method='shampoo')
        sched = schedpol.commit(pol, state.sched, accum, refresh, staleness)

        ops = {k: kvlib.LayerStats(a_outer=v[0], b_outer=v[1])
               for k, v in used.items()}
        out = pre.precondition_tree(flat, ops, 'shampoo_cached', gamma,
                                    plan=dense_plan)
        if head_pol:
            out = fsh.apply_tree(out, plan, head_pol, head, head_factors,
                                 power=0.25, cfg=fcfg, site='factor/shampoo')
        return out, ShampooState(
            m_in=m_in, m_out=m_out, p_in=p_in, p_out=p_out, sched=sched,
            pipe=new_pipe, head=head)

    return GradientTransformation(init, update)


def shampoo(lr=0.1, gamma: float = 1e-4, interval: int = 1,
            momentum: float = 0.9, weight_decay: float = 0.0,
            graft: bool = True,
            policy: Optional[schedpol.RefreshPolicy] = None,
            fused: bool = False) -> GradientTransformation:
    """Shampoo as evaluated in the paper: precondition → graft to the SGD
    magnitude → EMA momentum → −lr.  ``fused=True`` runs graft + momentum
    as one ``clipping.fused_tail``; the math is the same."""
    parts = []
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(shampoo_preconditioner(gamma, interval=interval,
                                        policy=policy))
    if graft and fused:
        parts.append(fused_tail(Epilogue(kind='graft', momentum=momentum)))
    else:
        if graft:
            parts.append(graft_to_grad_magnitude())
        parts.append(ema_trace(momentum))
    parts.append(scale_by_schedule(lr if callable(lr) else (lambda _: lr)))
    return chain(*parts)


CAPTURE = kvlib.NO_CAPTURE
