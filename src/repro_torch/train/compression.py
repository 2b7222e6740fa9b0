"""Error-feedback compressed gradient exchange for the explicit-DP step —
PyTorch port of ``repro/train/compression.py``.

The gradient all-reduce and the KV statistics reduction both go through
``comm/exchange.py``; this module picks their codecs and threads the
error-feedback residual.  The default is the int8 symmetric max-scale codec
with carried error feedback (8x less gradient traffic than f32), beside
Eva's sublinear f32 KV all-reduce.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.comm import exchange
from repro_torch.comm import group as group_mod
from repro_torch.comm.codec import get_codec
from repro_torch.core import kv as kvlib
from repro_torch.core.transform import Extras, apply_updates, tree_map
from repro_torch.device import resolve_device
from repro_torch.schedule import pipeline as pipemod
from repro_torch.train.step import (_local_rows, _plan_for_stats, _to_device,
                                    compute_grads_and_stats, taps_caller)


def quantize_allreduce(g: torch.Tensor, err: torch.Tensor, group: Any = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean all-reduce of ``g`` over ``group`` with int8 error feedback:
    ``(mean, new local residual)``.  The reference's op sequence: the global
    MAX scale, int8 quantization, an exact int32 sum, the shared-scale
    dequantization."""
    mean, new_err, _ = exchange.allreduce_mean_leaf(
        g, err, codec='int8', scope=group_mod.scope_of(group))
    return mean, new_err


def make_dp_train_step(model, opt, capture: kvlib.CaptureConfig,
                       group: Any = None, compress: bool = True,
                       taps_fn=None,
                       comm: Optional[exchange.ExchangeConfig] = None,
                       sched=None, device='cuda'):
    """The explicit data-parallel step over ``group`` (as ``make_dp_step``)
    with codec'd exchanges: the gradients through ``comm.grads`` (int8 with
    error feedback by default; ``compress=False`` is f32) and the KV
    statistics through ``comm.stats`` (f32 by default).  The same config
    threads to the optimizer through ``Extras.comm`` with the stats codec
    set to f32, since the statistics were just reduced and a lossy codec
    must quantize once.  The metrics carry ``comm_saturation``, the int8
    overflow share (0 under the global max scale).

    Returns ``(step_fn, init_err)``: ``step_fn(params, opt_state, err,
    batch) -> (params, opt_state, err, metrics)`` with the global batch,
    and ``init_err(params)`` the zero residual."""
    if comm is not None:
        if not compress and get_codec(comm.grads).name != 'f32':
            raise ValueError(
                'conflicting arguments: compress=False but comm.grads='
                f"{comm.grads!r}; pass ExchangeConfig(grads='f32') (or drop "
                'compress=False) to say which you mean')
        cfg = comm
    else:
        cfg = exchange.ExchangeConfig(grads='int8' if compress else 'f32')
    dev = resolve_device(device)
    make_taps = taps_caller(taps_fn)
    scope = group_mod.scope_of(group)
    inner = dataclasses.replace(cfg, stats='f32')

    def step_fn(params, opt_state, err, batch):
        with group_mod.in_scope(scope):
            local = _local_rows(_to_device(batch, dev), scope.world,
                                scope.rank)
            loss, grads, stats = compute_grads_and_stats(
                model, params, local, capture, make_taps(params, local))
            loss = exchange.allreduce_mean_tree(loss, codec='f32')[0]
            grads, new_err, info = exchange.allreduce_mean_tree(
                grads, err, codec=cfg.grads, site='grads/dp')
            new_err = new_err if new_err is not None else err
            stats, _, _ = exchange.allreduce_mean_tree(
                stats, codec=cfg.stats, site='stats/dp')
            updates, new_opt = opt.update(
                grads, opt_state, params=params,
                extras=Extras(stats=stats, loss=loss,
                              plan=_plan_for_stats(grads, stats),
                              comm=inner, sched=sched))
            new_params = apply_updates(params, updates)
            metrics = {'loss': loss, 'comm_saturation': info['saturation']}
            metrics.update(pipemod.pipeline_metrics(new_opt))
            return new_params, new_opt, new_err, metrics

    def init_error(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    return step_fn, init_error
