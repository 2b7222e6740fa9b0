"""Train-step factory: loss → (grads, tap-grads) → KV stats → optimizer.

PyTorch port of ``compute_grads_and_stats``, ``make_train_step``,
``make_dp_step``, ``make_phased_step``, ``init_opt_state`` and
``stats_plan_of`` in ``repro/train/step.py``.  The step runs eagerly and
returns new parameters and state without touching its inputs.  Nothing in it
reads a value back to the host, so a step only queues work on the card; the
caller syncs when it reads a metric.

The entry points take ``device=`` (default ``'cuda'``); without a card they
raise unless the caller passes ``device='cpu'``.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Optional

import torch

from repro_torch.comm import exchange
from repro_torch.comm import group as group_mod
from repro_torch.core import bucketing
from repro_torch.core import factor_sharded as fsh
from repro_torch.core import kv as kvlib
from repro_torch.core.transform import (Extras, GradientTransformation,
                                        apply_updates, tree_map)
from repro_torch.device import resolve_device
from repro_torch.obs import spans as obs_spans
from repro_torch.schedule import pipeline as pipemod
from repro_torch.schedule import runtime as schedrt

F32 = torch.float32


def _plan_for_stats(params_or_grads, stats
                    ) -> Optional[bucketing.BucketPlan]:
    """The bucket plan over the captured (= preconditioned) paths."""
    if stats is None:
        return None
    flat = kvlib.flatten_params(params_or_grads)
    return bucketing.build_plan({p: flat[p] for p in stats if p in flat})


def taps_caller(taps_fn: Optional[Callable]) -> Callable:
    """Normalize a taps factory to ``(params, batch) -> taps``: a
    ``taps_fn(params, batch)`` (two or more parameters) sizes the taps from
    the batch it is handed; a one-parameter ``taps_fn(params)`` closes over
    its batch size.  None gives ``None`` (the default taps)."""
    if taps_fn is None:
        return lambda params, batch: None
    try:
        n_args = len(inspect.signature(taps_fn).parameters)
    except (TypeError, ValueError):
        n_args = 1
    if n_args >= 2:
        return taps_fn
    return lambda params, batch: taps_fn(params)


def _default_taps(model, params, batch, capture: kvlib.CaptureConfig):
    """The taps when the caller gives no ``taps_fn``.  A model with
    ``make_taps`` (the simple MLPs) gets them sized from the batch it is
    handed, where the reference raises and asks for a ``taps_fn``; any
    other model gets (d_out,) vector taps, and a full-tap capture
    (``b='outer'``) without a ``taps_fn`` raises, as in the reference."""
    if not capture.needs_taps:
        return None
    dev = next(iter(params.values())).device
    if hasattr(model, 'make_taps'):
        rows = next(iter(batch.values())).shape[0]
        return model.make_taps(rows, capture, device=dev)
    if capture.b == 'outer':
        raise ValueError("capture.b='outer' needs full z-shaped taps: pass "
                         'taps_fn (see kv.make_full_taps)')
    return kvlib.make_vector_taps(params, set(model.precon_paths()) &
                                  set(params))


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def _forward(model, params: dict, batch: dict,
             capture: kvlib.CaptureConfig, taps: Optional[dict]):
    """``model.loss_fn`` on differentiable copies of the parameters and the
    taps: (loss, aux, leaves, taps)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    if taps is None:
        taps = _default_taps(model, params, batch, capture)
    if taps is not None:
        taps = {k: t.detach().requires_grad_(True) for k, t in taps.items()}
    loss, aux = model.loss_fn(leaves, taps, batch, capture)
    return loss, aux, leaves, taps


def _backward(loss, aux, leaves: dict, taps: Optional[dict],
              capture: kvlib.CaptureConfig):
    """(loss, grads, stats) from ``_forward``'s output: one backward pass
    for the weight and the tap gradients, then the statistics."""
    inputs = list(leaves.values()) + (list(taps.values()) if taps else [])
    # a leaf the loss does not read (a VLM's token table) gets zeros, as
    # JAX's gradient gives
    got = torch.autograd.grad(loss, inputs, allow_unused=True,
                              materialize_grads=True)
    grads = dict(zip(leaves, got[:len(leaves)]))
    tap_grads = dict(zip(taps, got[len(leaves):])) if taps else None
    stats = None
    if capture.active:
        with obs_spans.span('capture'):
            stats = kvlib.finalize_stats(aux['stats'], tap_grads, capture,
                                         n_tokens=aux['n_tokens'])
    return loss.detach(), grads, stats


def compute_grads_and_stats(model, params: dict, batch: dict,
                            capture: kvlib.CaptureConfig,
                            taps: Optional[dict] = None):
    """(loss, grads, stats): one forward and backward of ``model.loss_fn``.

    b̄ (or, with full taps, the per-token cotangent behind B) is the
    gradient of each zero tap, taken by the same backward pass as the
    weight gradients.  ``taps`` overrides the default taps."""
    return _backward(*_forward(model, params, batch, capture, taps), capture)


def _step_metrics(loss, grads, new_state) -> dict:
    """The loss, the gradient norm, the refresh counters
    (``schedule_metrics``), the pipeline's staleness in 'onestep' mode
    (``pipeline_metrics``) and, when a factor is sharded,
    ``factor_sharded.step_metrics``; all 0-d device tensors."""
    grad_norm = torch.sqrt(sum((g.to(F32) ** 2).sum()
                               for _, g in sorted(grads.items())))
    metrics = {'loss': loss, 'grad_norm': grad_norm}
    metrics.update(schedrt.schedule_metrics(new_state))
    metrics.update(pipemod.pipeline_metrics(new_state))
    metrics.update(fsh.step_metrics(new_state))
    return metrics


# The phases of a step, each under its span (``obs/spans.py``; recorded only
# while tracing is on): 'forward' (the batch's move, the taps, the loss and
# the statistics' forward half, each capture under a 'capture' span),
# 'backward' (the gradients and ``finalize_stats`` under a 'capture' span),
# 'update' (the optimizer), 'step_metrics' and 'apply'.  They tile a step.


def _grad_phase(model, capture: kvlib.CaptureConfig, make_taps: Callable,
                dev: torch.device, rows: Optional[Callable] = None,
                reduce: Optional[Callable] = None) -> Callable:
    """``grad_fn(params, batch) -> (loss, grads, stats)``: the batch moved
    to ``dev`` and cut to ``rows(batch)``, its taps and the forward pass,
    then the backward pass and ``reduce(loss, grads, stats)``."""
    def grad_fn(params, batch):
        with obs_spans.span('forward'):
            batch = _to_device(batch, dev)
            if rows is not None:
                batch = rows(batch)
            fwd = _forward(model, params, batch, capture,
                           make_taps(params, batch))
        with obs_spans.span('backward'):
            out = _backward(*fwd, capture)
            return out if reduce is None else reduce(*out)

    return grad_fn


def _update_phase(opt: GradientTransformation, **extras) -> Callable:
    """``update_fn(grads, stats, loss, opt_state, params) -> (updates,
    new_state, metrics)``; ``extras`` are ``Extras``' ``sched``, ``comm``,
    ``factor`` and ``kernel``."""
    def update_fn(grads, stats, loss, opt_state, params):
        with obs_spans.span('update'):
            updates, new_state = opt.update(
                grads, opt_state, params=params,
                extras=Extras(stats=stats, loss=loss,
                              plan=_plan_for_stats(grads, stats), **extras))
        with obs_spans.span('step_metrics'):
            metrics = _step_metrics(loss, grads, new_state)
        return updates, new_state, metrics

    return update_fn


def _apply_phase(params, updates):
    with obs_spans.span('apply'):
        return apply_updates(params, updates)


def _sum_tree(acc, tree):
    return tree if acc is None else tree_map(lambda a, x: a + x, acc, tree)


def _microbatched(grad_fn: Callable, n: int) -> Callable:
    """``grad_fn`` over ``n`` microbatches, the batch split on dim 0, as the
    reference's scan: the gradients summed in f32, the statistics and the
    losses summed, each divided by ``n`` (the sums in the 'backward'
    span)."""
    def acc_fn(params, batch):
        parts = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        g_sum = s_sum = l_sum = None
        for i in range(n):
            loss, grads, stats = grad_fn(params,
                                         {k: v[i] for k, v in parts.items()})
            with obs_spans.span('backward'):
                g_sum = _sum_tree(g_sum, tree_map(lambda g: g.to(F32), grads))
                if stats is not None:
                    s_sum = _sum_tree(s_sum, tree_map(lambda s: s.to(F32),
                                                      stats))
                l_sum = loss.to(F32) if l_sum is None else l_sum + loss
                if i == n - 1:
                    inv = 1.0 / n
                    return (l_sum * inv, tree_map(lambda g: g * inv, g_sum),
                            tree_map(lambda s: s * inv, s_sum))

    return acc_fn


def make_train_step(model, opt: GradientTransformation,
                    capture: kvlib.CaptureConfig,
                    taps_fn: Optional[Callable] = None,
                    microbatches: int = 1,
                    sched: Optional[schedrt.RefreshRuntime] = None,
                    comm: Optional[Any] = None,
                    factor: Optional[Any] = None,
                    kernel: Optional[Any] = None,
                    device='cuda') -> Callable:
    """Build ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``: the composition of ``make_phased_step``'s phases.

    ``taps_fn(params)`` or ``taps_fn(params, batch)`` makes the taps (see
    :func:`taps_caller`; full taps for K-FAC).  ``microbatches > 1`` splits
    the batch on dim 0 and accumulates: grads summed in f32, KV stats
    summed, both (and the loss) divided by the count, as the reference's
    scan.  ``sched`` is the refresh runtime, ``comm`` the
    ``comm.exchange.ExchangeConfig`` (the codecs of the statistics and
    refresh exchanges under a data group in scope) and ``factor`` the
    ``core.factor_sharded.FactorShardConfig`` (None keeps every factor
    dense) and ``kernel`` the ``kernels.dispatch.KernelConfig`` (None leaves
    the optimizers on their own ``kernel_impl``), all threaded through
    ``Extras``.  The metrics hold the loss,
    the gradient norm, the refresh counters of ``schedule_metrics`` (when a
    transform is scheduled) and, when a factor is sharded,
    ``factor_sharded.step_metrics``.
    """
    grad_fn, update_fn, apply_fn = make_phased_step(
        model, opt, capture, taps_fn, sched=sched, comm=comm, factor=factor,
        kernel=kernel, device=device)
    if microbatches > 1:
        grad_fn = _microbatched(grad_fn, microbatches)

    def train_step(params, opt_state, batch):
        loss, grads, stats = grad_fn(params, batch)
        updates, new_state, metrics = update_fn(grads, stats, loss,
                                                opt_state, params)
        return apply_fn(params, updates), new_state, metrics

    return train_step


def _local_rows(batch: dict, world: int, rank: int) -> dict:
    """This worker's shard of the global batch: rows ``[rank·B/W,
    (rank+1)·B/W)`` of every leaf (the reference's ``P('data')``)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f'batch dim {v.shape[0]} of {k!r} does not '
                             f'divide over {world} workers')
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def make_dp_step(model, opt: GradientTransformation,
                 capture: kvlib.CaptureConfig, group: Any = None,
                 taps_fn: Optional[Callable] = None,
                 sched: Optional[schedrt.RefreshRuntime] = None,
                 comm: Optional[Any] = None,
                 factor: Optional[Any] = None,
                 kernel: Optional[Any] = None,
                 device='cuda') -> Callable:
    """The explicit data-parallel step over ``group`` (a
    ``torch.distributed`` group, a ``comm.group.DataScope`` — a pod scope
    too — or None for the default group): the engine of
    ``Trainer.fit_elastic``.  Call it in every member with the same global
    batch; each takes its own rows.

    Parameters and optimizer state are replicated.  The loss is
    mean-reduced, the gradients and the KV statistics mean-all-reduced in
    f32 (sites ``grads/dp`` and ``stats/dp``, in the 'backward' span); the
    optimizer runs with the
    group in scope, so the worker-sharded refresh, the owned-slice exchange
    and the factor bands see W workers (the optimizer's own mean of the
    already identical statistics is a further exact, idempotent exchange,
    as in the reference).  At W = 1 every exchange sums one value and
    divides by 1, so the trajectory is ``make_train_step``'s bit for bit.
    The same metrics as ``make_train_step``."""
    dev = resolve_device(device)
    sched = sched if sched is not None else schedrt.RefreshRuntime()
    scope = group_mod.scope_of(group)

    def mean_over_group(loss, grads, stats):
        loss = exchange.allreduce_mean_tree(loss, codec='f32')[0]
        grads, _, _ = exchange.allreduce_mean_tree(
            grads, codec='f32', site='grads/dp')
        if stats is not None:
            stats, _, _ = exchange.allreduce_mean_tree(
                stats, codec='f32', site='stats/dp')
        return loss, grads, stats

    grad_fn = _grad_phase(
        model, capture, taps_caller(taps_fn), dev,
        rows=lambda b: _local_rows(b, scope.world, scope.rank),
        reduce=mean_over_group)
    update_fn = _update_phase(opt, sched=sched, comm=comm, factor=factor,
                              kernel=kernel)

    def dp_step(params, opt_state, batch):
        with group_mod.in_scope(scope):
            loss, grads, stats = grad_fn(params, batch)
            updates, new_state, metrics = update_fn(grads, stats, loss,
                                                    opt_state, params)
            return _apply_phase(params, updates), new_state, metrics

    return dp_step


def make_phased_step(model, opt: GradientTransformation,
                     capture: kvlib.CaptureConfig,
                     taps_fn: Optional[Callable] = None,
                     sched: Optional[schedrt.RefreshRuntime] = None,
                     comm: Optional[Any] = None,
                     factor: Optional[Any] = None,
                     kernel: Optional[Any] = None,
                     device='cuda') -> tuple[Callable, Callable, Callable]:
    """The train step cut at its phase boundaries, for span timing:
    ``grad_fn(params, batch) -> (loss, grads, stats)``,
    ``update_fn(grads, stats, loss, opt_state, params) -> (updates,
    new_state, metrics)`` and ``apply_fn(params, updates) -> new_params``.
    Their composition is ``make_train_step(microbatches=1)``."""
    dev = resolve_device(device)
    sched = sched if sched is not None else schedrt.RefreshRuntime()
    return (_grad_phase(model, capture, taps_caller(taps_fn), dev),
            _update_phase(opt, sched=sched, comm=comm, factor=factor,
                          kernel=kernel),
            _apply_phase)


def init_opt_state(model, opt: GradientTransformation,
                   capture: kvlib.CaptureConfig, params: dict, batch: dict,
                   taps_fn: Optional[Callable] = None,
                   sched: Optional[schedrt.RefreshRuntime] = None,
                   comm: Optional[Any] = None,
                   factor: Optional[Any] = None,
                   kernel: Optional[Any] = None,
                   device='cuda'):
    """Materialized optimizer state.  The stats' shapes come from one
    forward/backward pass on ``batch``; the state holds zeros of them.
    ``taps_fn``, ``sched``, ``comm``, ``factor`` and ``kernel`` must be the
    train step's."""
    dev = resolve_device(device)
    sched = sched if sched is not None else schedrt.RefreshRuntime()
    if not capture.active:
        return opt.init(params, Extras(sched=sched, comm=comm,
                                       factor=factor, kernel=kernel))
    batch = _to_device(batch, dev)
    _, _, stats = compute_grads_and_stats(
        model, params, batch, capture, taps_caller(taps_fn)(params, batch))
    zero_stats = tree_map(torch.zeros_like, stats)
    return opt.init(params, Extras(stats=zero_stats,
                                   plan=_plan_for_stats(params, zero_stats),
                                   sched=sched, comm=comm, factor=factor,
                              kernel=kernel))


def stats_plan_of(model, capture: kvlib.CaptureConfig, params: dict,
                  batch: dict, taps_fn: Optional[Callable] = None,
                  device='cuda') -> Optional[bucketing.BucketPlan]:
    """The bucket plan over the preconditioned paths (the trainer's
    ownership record is keyed by it).  Where the reference traces the step
    under ``jax.eval_shape``, this runs one forward and backward pass on the
    real ``batch`` and keeps only the captured paths; no state is made."""
    if not capture.active:
        return None
    dev = resolve_device(device)
    batch = _to_device(batch, dev)
    _, _, stats = compute_grads_and_stats(
        model, params, batch, capture, taps_caller(taps_fn)(params, batch))
    return _plan_for_stats(params, stats)


def abstract_opt_state(model, opt: GradientTransformation,
                       capture: kvlib.CaptureConfig, params_abstract,
                       batch_specs, taps_fn: Optional[Callable] = None,
                       sched: Optional[schedrt.RefreshRuntime] = None,
                       comm: Optional[Any] = None,
                       factor: Optional[Any] = None,
                       kernel: Optional[Any] = None):
    """The optimizer state as meta tensors (shape and dtype, the dry run's
    stand-ins): ``init_opt_state`` run under ``FakeTensorMode`` on fake
    copies of the meta (or real) ``params_abstract`` and ``batch_specs``,
    on the CPU's plain path; nothing is computed or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import fake_copies
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    params, batch = fake_copies((params_abstract, batch_specs), mode, 'cpu')
    with mode:
        state = init_opt_state(model, opt, capture, params, batch, taps_fn,
                               sched=sched, comm=comm, factor=factor,
                               kernel=kernel, device='cpu')
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device='meta')
                    if isinstance(t, torch.Tensor) else t, state)
