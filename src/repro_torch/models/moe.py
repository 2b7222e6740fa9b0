"""Mixture-of-Experts with sort-based capacity dispatch — PyTorch port of
``repro/models/moe.py``.

Each token's top-k expert assignments are sorted by expert id, positioned
within their expert's segment, and scattered into a dense ``(E, C, D)``
buffer (capacity ``C = ceil(T·k·cf / E)``, rounded up to a multiple of 8);
assignments past an expert's capacity drop.  The expert FFNs are one batched
matmul over the expert axis.

Eva for MoE: each expert weight gets a per-expert tap ``(E, d_out)`` and
masked per-expert input means (``kv.fwd_stats_masked``), so the rank-one
preconditioner treats each expert as an item of its own.  The router is an
ordinary preconditioned linear.

Dispatch is group-local: tokens are routed within their data shard's group
(G = the product of the mesh's 'pod' and 'data' axes, 1 without a mesh;
per-group capacity), so the dispatch and combine gathers stay on the shard
and only the (E, G, C, D) slot tensor moves from token-major (G over the
data axes) to expert-major (E over 'model'): an all-to-all of slot volume.
The ``constrain`` calls lay those tensors out on a DeviceMesh and are the
identity without one.  At G = 1 the ops are the single-group ones.

On plain tensors (one device, CPU or CUDA) the dispatch and combine gathers
are ``gather_rows``: an ``index_select`` whose backward gathers through the
inverse map, over the filled slots and the assignments that fit alone.  The
advanced-index gather's own backward (``index_put`` with accumulate) sorts
every index and piles each empty slot's zero gradient onto token 0, and
each dropped assignment's onto its expert's last slot.  A DTensor keeps the
advanced-index gathers, which DTensor lays out on the mesh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import kv as kvlib
from repro_torch.models.layers import linear, linear_spec
from repro_torch.models.module import ParamSpec
from repro_torch.obs import spans as obs_spans
from repro_torch.sharding.constraints import _current_mesh, constrain

F32 = torch.float32


def moe_spec(d: int, d_ff: int, n_experts: int, dtype=torch.float32) -> dict:
    def w(shape, axes):
        return {'w': ParamSpec(shape, dtype, init='scaled', axes=axes)}
    return {
        'router': linear_spec(d, n_experts, False, dtype, ('embed', None)),
        'gate': w((n_experts, d, d_ff), ('expert', 'embed', 'mlp')),
        'up': w((n_experts, d, d_ff), ('expert', 'embed', 'mlp')),
        'down': w((n_experts, d_ff, d), ('expert', 'mlp', 'embed')),
    }


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k * factor / n_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _expert_linear(w, x, *, wpath: str, col, taps, capture, mask):
    """x: (E, G, C, d_in) @ w: (E, d_in, d_out) with per-expert stats and
    taps; mask: (E, G, C) slot validity."""
    e, g, c = x.shape[:3]
    xf = x.reshape(e, g * c, x.shape[-1])
    if capture is not None and capture.a is not None:
        with obs_spans.span('capture'):
            col[wpath] = kvlib.fwd_stats_masked(xf, mask.reshape(e, g * c),
                                                capture)
    y = torch.bmm(xf, w)
    if taps is not None and wpath in taps:
        y = y + taps[wpath][:, None, :].to(y.dtype)
    return y.reshape(e, g, c, y.shape[-1])


def _n_data_shards() -> int:
    """Product of the 'pod' and 'data' axes of the mesh in scope (1
    outside a mesh, and inside a data group in scope)."""
    from repro_torch.sharding import compat
    shape = compat.mesh_shape(_current_mesh())
    n = 1
    for a in ('pod', 'data'):
        n *= shape.get(a, 1)
    return n


def route(flat_e: torch.Tensor, n_experts: int, top_k: int, cap: int):
    """Slot assignment from the (..., T·k) expert ids, token-major, one
    group per leading index (none for 1-D ids).

    Returns ``(slot_token (..., E, C), slot_mask (..., E, C) f32,
    flat_slot (..., T·k), ok (..., T·k) bool)``: the token in each slot,
    whether the slot holds one, each assignment's slot in its group's
    flattened (E·C) buffer, and whether the assignment fit.  An assignment
    past its expert's capacity is written to column ``cap``, which is
    sliced off.  Fixed-shape integer ops only, so the tables trace on fake
    tensors and lay out on a DeviceMesh."""
    lead = flat_e.shape[:-1]
    n = flat_e.shape[-1]
    flat_e = flat_e.long().reshape(-1, n)
    g = flat_e.shape[0]
    dev = flat_e.device
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros(g, n_experts, dtype=torch.long, device=dev) \
        .scatter_add(1, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, -1) - counts
    ranks = torch.arange(n, device=dev).expand(g, n)
    inv_rank = torch.zeros_like(flat_e).scatter(1, sort_idx, ranks)
    pos = inv_rank - seg_start.gather(1, flat_e)
    ok = pos < cap
    safe_pos = torch.where(ok, pos, cap)
    cell = flat_e * (cap + 1) + safe_pos
    slot_token = torch.zeros(g, n_experts * (cap + 1), dtype=torch.long,
                             device=dev).scatter(1, cell, ranks // top_k)
    slot_mask = torch.zeros(g, n_experts * (cap + 1), dtype=F32,
                            device=dev).scatter(1, cell, ok.to(F32))
    slot_token = slot_token.reshape(g, n_experts, cap + 1)[..., :cap]
    slot_mask = slot_mask.reshape(g, n_experts, cap + 1)[..., :cap]
    flat_slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
    return (slot_token.reshape(lead + (n_experts, cap)),
            slot_mask.reshape(lead + (n_experts, cap)),
            flat_slot.reshape(lead + (n,)), ok.reshape(lead + (n,)))


class GatherRows(torch.autograd.Function):
    """``src.index_select(0, index)`` (rows of ``src`` (rows, D)) whose
    backward is a gather: ``inv`` (rows, fan) lists, for each source row,
    the output rows that read it, and ``valid`` (rows, fan) bool marks
    those whose gradient counts.  Source row r's gradient is the sum over
    j of output row ``inv[r, j]`` where ``valid[r, j]``, in f32, rounded
    once; a row ``valid`` leaves out adds nothing, non-finite or not.  No
    atomics, no sort, no scatter.

    The backward is the adjoint of the gather on the rows ``valid`` marks,
    so every output row it leaves out must be zeroed downstream (an empty
    slot by the slot mask, a dropped assignment by its zero gate
    weight)."""

    @staticmethod
    def forward(ctx, src, index, inv, valid):
        ctx.save_for_backward(inv, valid)
        return src.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        inv, valid = ctx.saved_tensors
        rows, fan = inv.shape
        g = grad.index_select(0, inv.reshape(-1)).reshape(rows, fan, -1)
        g = torch.where(valid.unsqueeze(-1), g, 0)
        if fan == 1:
            return g.squeeze(1), None, None, None
        return g.sum(1, dtype=F32).to(grad.dtype), None, None, None


gather_rows = GatherRows.apply


def gather_tables(slot_token, slot_mask, flat_slot, ok, top_k: int):
    """``gather_rows``' tables from ``route``'s (G leading), the group
    folded into the row index: token g·T_l + t, and row (e·G + g)·C + c of
    the (E, G, C) slot buffer.

    Returns ``(slot_src (E·G·C,), a_row (T, k), ok (T, k), assign
    (E·G·C, 1), filled (E·G·C, 1))``: each slot's token; each assignment's
    slot row (a dropped one's clamped, as ``flat_slot``) and whether it
    fit; each slot's assignment (built by one scatter, a dropped assignment
    sent to a spare row that is sliced off) and whether the slot holds
    one."""
    groups, n_experts, cap = slot_token.shape
    n_rows = n_experts * groups * cap
    dev = slot_token.device
    n = flat_slot.shape[-1]
    gi = torch.arange(groups, device=dev).unsqueeze(1)              # (G, 1)
    slot_src = (slot_token + (gi * (n // top_k)).unsqueeze(2)).movedim(0, 1)
    a_row = ((flat_slot // cap * groups + gi) * cap + flat_slot % cap) \
        .reshape(-1, top_k)
    ok = ok.reshape(-1, top_k)
    assign = torch.zeros(n_rows + 1, dtype=torch.long, device=dev).scatter(
        0, torch.where(ok, a_row, n_rows).reshape(-1),
        torch.arange(groups * n, device=dev)).narrow(0, 0, n_rows)
    filled = slot_mask.movedim(0, 1).reshape(n_rows, 1) > 0
    return slot_src.reshape(-1), a_row, ok, assign.unsqueeze(1), filled


def _plain(*ts) -> bool:
    """No tensor of ``ts`` is a DTensor: the gather-form path indexes
    local rows."""
    from torch.distributed.tensor import DTensor
    return not any(isinstance(t, DTensor) for t in ts)


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, norm_topk: bool = True,
              path: str = '', col=None, taps=None, capture=None,
              compute_dtype=None, aux_coef: float = 0.0):
    """x: (B, S, D) -> (y, aux_loss).  ``p`` is a flat dict holding
    ``f'{path}/router/w'``, ``f'{path}/gate/w'`` (E, D, d_ff) and the rest.
    Dropless up to capacity; overflow drops.  While tracing is on
    (``obs/spans.py``) the assignments and the dropped ones are counted,
    once a call, as ``moe.assignments/<path>`` and ``moe.dropped/<path>``,
    and each call that takes the gather-form path (plain tensors) as 1 in
    ``moe.gather_form/<path>``."""
    col = col if col is not None else {}
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    n_experts = p[f'{path}/gate/w'].shape[0]

    logits = linear(p, xt, path=f'{path}/router', col=col, taps=taps,
                    capture=capture, compute_dtype=compute_dtype)
    probs = torch.softmax(logits.to(F32), dim=-1)                  # (T, E)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)       # (T, k)
    if norm_topk:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # load-balancing auxiliary loss (Switch-style)
    if aux_coef:
        me = probs.mean(0)                                          # (E,)
        ce = F.one_hot(expert_ids[:, 0], n_experts).to(F32).mean(0)
        aux = aux_coef * n_experts * torch.sum(me * ce)
    else:
        aux = torch.zeros((), dtype=F32, device=x.device)

    # group-local sort-based dispatch: G groups of T_l tokens, per-group
    # capacity; only int index tables go through scatters
    groups = _n_data_shards()
    if t % groups or (t // groups) < top_k:
        groups = 1
    tg = t // groups
    cap = capacity(tg, top_k, n_experts, capacity_factor)
    slot_token, slot_mask, flat_slot, ok = route(
        expert_ids.reshape(groups, tg * top_k), n_experts, top_k, cap)
    xd = xt.to(compute_dtype) if compute_dtype is not None else xt
    plain = _plain(xd, expert_ids)
    tracker = obs_spans.tracing()
    if tracker is not None:
        tracker.count(f'moe.assignments/{path}', ok.numel())
        tracker.count(f'moe.dropped/{path}', (~ok).sum())
        if plain:
            tracker.count(f'moe.gather_form/{path}', 1)

    if plain:
        slot_src, a_row, ok, assign, filled = gather_tables(
            slot_token, slot_mask, flat_slot, ok, top_k)
        disp = gather_rows(xd, slot_src, a_row, ok) \
            .reshape(n_experts, groups, cap, d)
    else:
        xg = constrain(xd.reshape(groups, tg, d), 'data', None, None)
        if groups == 1:
            disp = xg[0][slot_token[0]][:, None]                   # (E,1,C,D)
        else:
            gi = torch.arange(groups, device=x.device)[:, None, None]
            disp = xg[gi, slot_token].movedim(0, 1)                # (E,G,C,D)
    slot_mask = slot_mask.movedim(0, 1)                            # (E,G,C)
    disp = disp * slot_mask[..., None].to(xd.dtype)
    disp = constrain(disp, 'model', 'data', None, None)

    # expert FFN (E: expert parallelism, G: data parallelism)
    def wd(name):
        w = p[f'{path}/{name}/w']
        return w.to(compute_dtype) if compute_dtype is not None else w
    kw = dict(col=col, taps=taps, capture=capture, mask=slot_mask)
    g = _expert_linear(wd('gate'), disp, wpath=f'{path}/gate/w', **kw)
    u = _expert_linear(wd('up'), disp, wpath=f'{path}/up/w', **kw)
    h = F.silu(g) * u
    out_e = _expert_linear(wd('down'), h, wpath=f'{path}/down/w', **kw)
    out_e = constrain(out_e, 'model', 'data', None, None)

    # combine: gather each assignment's slot in its group, weighted top-k
    # sum in f32, all group-local
    w_tk = (gate_vals * ok.reshape(t, top_k)).to(F32)
    if plain:
        y_tk = gather_rows(out_e.reshape(-1, d), a_row.reshape(-1), assign,
                           filled)
    else:
        out_g = out_e.movedim(1, 0).reshape(groups, n_experts * cap, d)
        out_g = constrain(out_g, 'data', None, None)
        if groups == 1:
            y_tk = out_g[0][flat_slot[0]]
        else:
            y_tk = out_g[torch.arange(groups, device=x.device)[:, None],
                         flat_slot]
    y = torch.einsum('tkd,tk->td', y_tk.reshape(t, top_k, d).to(F32), w_tk)
    y = constrain(y.reshape(groups, tg, d), 'data', None, None)
    return y.reshape(b, s, d).to(x.dtype), aux
