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

On one device the reference routes in one group (its ``_n_data_shards()``
is 1 outside a mesh, and ``constrain`` is the identity), so the group axis
is not carried here; the group-local dispatch of expert parallelism waits
for a ``('data', 'model')`` layout (ROADMAP.md §1 item 13).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import kv as kvlib
from repro_torch.models.layers import linear, linear_spec
from repro_torch.models.module import ParamSpec

F32 = torch.float32


def moe_spec(d: int, d_ff: int, n_experts: int, dtype=torch.float32) -> dict:
    def w(shape):
        return {'w': ParamSpec(shape, dtype, init='scaled')}
    return {
        'router': linear_spec(d, n_experts, False, dtype),
        'gate': w((n_experts, d, d_ff)),
        'up': w((n_experts, d, d_ff)),
        'down': w((n_experts, d_ff, d)),
    }


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k * factor / n_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _expert_linear(w, x, *, wpath: str, col, taps, capture, mask):
    """x: (E, C, d_in) @ w: (E, d_in, d_out) with per-expert stats and
    taps; mask: (E, C) slot validity."""
    if capture is not None and capture.a is not None:
        col[wpath] = kvlib.fwd_stats_masked(x, mask, capture)
    y = torch.bmm(x, w)
    if taps is not None and wpath in taps:
        y = y + taps[wpath][:, None, :].to(y.dtype)
    return y


def route(flat_e: torch.Tensor, n_experts: int, top_k: int, cap: int):
    """Slot assignment from the (T·k,) expert ids, token-major.

    Returns ``(slot_token (E, C), slot_mask (E, C) f32, flat_slot (T·k,),
    ok (T·k,) bool)``: the token in each slot, whether the slot holds one,
    each assignment's slot in the flattened (E·C) buffer, and whether the
    assignment fit.  An assignment past its expert's capacity is written to
    column ``cap``, which is sliced off."""
    n = flat_e.shape[0]
    dev = flat_e.device
    flat_e = flat_e.long()
    sort_idx = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=n_experts)
    seg_start = torch.cumsum(counts, 0) - counts
    inv_rank = torch.empty(n, dtype=torch.long, device=dev)
    inv_rank[sort_idx] = torch.arange(n, device=dev)
    pos = inv_rank - seg_start[flat_e]
    ok = pos < cap
    safe_pos = torch.where(ok, pos, cap)
    token = torch.arange(n, device=dev) // top_k
    cell = flat_e * (cap + 1) + safe_pos
    slot_token = torch.zeros(n_experts * (cap + 1), dtype=torch.long,
                             device=dev).index_put((cell,), token)
    slot_mask = torch.zeros(n_experts * (cap + 1), dtype=F32,
                            device=dev).index_put((cell,), ok.to(F32))
    slot_token = slot_token.reshape(n_experts, cap + 1)[:, :cap]
    slot_mask = slot_mask.reshape(n_experts, cap + 1)[:, :cap]
    flat_slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
    return slot_token, slot_mask, flat_slot, ok


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, norm_topk: bool = True,
              path: str = '', col=None, taps=None, capture=None,
              compute_dtype=None, aux_coef: float = 0.0):
    """x: (B, S, D) -> (y, aux_loss).  ``p`` is a flat dict holding
    ``f'{path}/router/w'``, ``f'{path}/gate/w'`` (E, D, d_ff) and the rest.
    Dropless up to capacity; overflow drops."""
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

    cap = capacity(t, top_k, n_experts, capacity_factor)
    slot_token, slot_mask, flat_slot, ok = route(
        expert_ids.reshape(-1), n_experts, top_k, cap)

    xd = xt.to(compute_dtype) if compute_dtype is not None else xt
    disp = xd[slot_token] * slot_mask[..., None].to(xd.dtype)      # (E,C,D)

    def wd(name):
        w = p[f'{path}/{name}/w']
        return w.to(compute_dtype) if compute_dtype is not None else w
    kw = dict(col=col, taps=taps, capture=capture, mask=slot_mask)
    g = _expert_linear(wd('gate'), disp, wpath=f'{path}/gate/w', **kw)
    u = _expert_linear(wd('up'), disp, wpath=f'{path}/up/w', **kw)
    h = F.silu(g) * u
    out_e = _expert_linear(wd('down'), h, wpath=f'{path}/down/w', **kw)

    # combine: gather each assignment's slot, weighted top-k sum in f32
    w_tk = (gate_vals * ok.reshape(t, top_k)).to(F32)
    y_tk = out_e.reshape(n_experts * cap, d)[flat_slot].reshape(t, top_k, d)
    y = torch.einsum('tkd,tk->td', y_tk.to(F32), w_tk)
    return y.reshape(b, s, d).to(x.dtype), aux
