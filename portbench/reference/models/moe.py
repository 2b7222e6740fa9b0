"""Decoder-only transformer with top-k routed experts (family ``moe``):
RMSNorm, GQA attention with RoPE, a routed SwiGLU expert layer that drops
assignments past each expert's capacity, an untied head, mean next-token
cross-entropy plus the Switch-style load-balancing loss of every layer."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import (F32, Tape, capacity, cross_entropy,
                                        expert_linear, linear, rmsnorm, rope,
                                        run_layers, stack_tapes)

_REQUIRED = {'qkv_bias': False, 'n_shared_experts': 0, 'norm': 'rms',
             'tie_embeddings': False}


def _check(cfg: dict) -> None:
    for k, v in _REQUIRED.items():
        if cfg.get(k, v) != v:
            raise ValueError(f'the moe reference has no {k}={cfg[k]!r}')
    if not cfg.get('n_experts'):
        raise ValueError('the moe reference needs n_experts > 0')


def param_specs(cfg: dict) -> dict:
    """{path: (shape, dtype name, init, arg)} (``harness/weights.py``), the
    weights drawn as Qwen3 initialises them: every linear and the embedding
    N(0, 0.02²) (``initializer_range``), the norms 1."""
    _check(cfg)
    n, d, h, kv = cfg['n_layers'], cfg['d_model'], cfg['n_heads'], \
        cfg['n_kv_heads']
    dh, f, e, v = cfg['head_dim'], cfg['d_ff'], cfg['n_experts'], \
        cfg['vocab']
    pd = cfg['param_dtype']

    def w(*shape):
        return (shape, pd, 'normal', 0.02)
    return {
        'embed/table': w(v, d),
        'blocks/norm1/scale': ((n, d), pd, 'ones', None),
        'blocks/attn/q/w': w(n, d, h * dh),
        'blocks/attn/k/w': w(n, d, kv * dh),
        'blocks/attn/v/w': w(n, d, kv * dh),
        'blocks/attn/o/w': w(n, h * dh, d),
        'blocks/norm2/scale': ((n, d), pd, 'ones', None),
        'blocks/moe/router/w': w(n, d, e),
        'blocks/moe/gate/w': w(n, e, d, f),
        'blocks/moe/up/w': w(n, e, d, f),
        'blocks/moe/down/w': w(n, e, f, d),
        'norm_f/scale': ((d,), pd, 'ones', None),
        'lm_head/w': w(d, v),
    }


def precon_paths(cfg: dict) -> list:
    """The weights Eva preconditions: every linear but the embedding."""
    return sorted(['blocks/attn/q/w', 'blocks/attn/k/w', 'blocks/attn/v/w',
                   'blocks/attn/o/w', 'blocks/moe/router/w',
                   'blocks/moe/gate/w', 'blocks/moe/up/w',
                   'blocks/moe/down/w', 'lm_head/w'])


def _attention(cfg, p, tape, x):
    b, s, _ = x.shape
    h, kv, dh = cfg['n_heads'], cfg['n_kv_heads'], cfg['head_dim']
    q = linear(x, p['attn/q/w'], 'attn/q/w', tape).reshape(b, s, h, dh)
    k = linear(x, p['attn/k/w'], 'attn/k/w', tape).reshape(b, s, kv, dh)
    v = linear(x, p['attn/v/w'], 'attn/v/w', tape).reshape(b, s, kv, dh)
    q, k = tape.r(rope(q, cfg['rope_theta'])), tape.r(rope(k,
                                                           cfg['rope_theta']))
    qg = q.reshape(b, s, kv, h // kv, dh)
    scores = torch.einsum('bqkgd,bskd->bkgqs', qg, k) / math.sqrt(dh)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float('-inf')), dim=-1)
    out = tape.r(torch.einsum('bkgqs,bskd->bqkgd', w, v).reshape(b, s,
                                                                  h * dh))
    return linear(out, p['attn/o/w'], 'attn/o/w', tape)


def _experts(cfg, p, tape, x):
    """(y, aux): each token's top-k experts, renormalised gates, slots
    given in token order up to the capacity, the rest dropped."""
    b, s, d = x.shape
    t, e, k = b * s, cfg['n_experts'], cfg['top_k']
    xt = x.reshape(t, d)
    probs = torch.softmax(linear(xt, p['moe/router/w'], 'moe/router/w',
                                 tape), dim=-1)
    gate, ids = probs.topk(k, dim=-1)
    if cfg['norm_topk']:
        gate = gate / gate.sum(-1, keepdim=True)
    top1 = F.one_hot(ids[:, 0], e).to(F32)
    aux = cfg['moe_aux_coef'] * e * (probs.mean(0) * top1.mean(0)).sum()

    cap = capacity(t, k, e, cfg['capacity_factor'])
    flat = ids.reshape(-1)                               # token-major
    onehot = F.one_hot(flat, e)
    # each assignment's place among the earlier ones to the same expert
    pos = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
    ok = pos < cap
    slot = flat * cap + torch.clamp(pos, max=cap - 1)
    kept = ok.nonzero()[:, 0]
    token = torch.arange(t * k, device=x.device) // k
    buf = torch.zeros((e * cap, d), dtype=F32, device=x.device).index_copy(
        0, slot[kept], xt[token[kept]])
    mask = torch.zeros(e * cap, dtype=F32, device=x.device).index_fill(
        0, slot[kept], 1.0).reshape(e, cap)
    xe = buf.reshape(e, cap, d)
    g = expert_linear(xe, p['moe/gate/w'], mask, 'moe/gate/w', tape)
    u = expert_linear(xe, p['moe/up/w'], mask, 'moe/up/w', tape)
    out = expert_linear(tape.r(F.silu(g) * u), p['moe/down/w'], mask,
                        'moe/down/w', tape)
    weight = gate.reshape(-1) * ok.to(F32)
    y = (out.reshape(e * cap, d)[slot] * weight[:, None]).reshape(t, k, d)
    return tape.r(y.sum(1).reshape(b, s, d)), aux


def _block(cfg, p, tape, x):
    r = tape.r
    x = r(x + _attention(cfg, p, tape, r(rmsnorm(x, p['norm1/scale']))))
    y, aux = _experts(cfg, p, tape, r(rmsnorm(x, p['norm2/scale'])))
    return r(x + y), aux


def loss(cfg: dict, params: dict, batch: dict, taps, quant=None):
    """(loss, ā, counts, tokens): ā and counts keyed by the weights'
    paths, stacked over the layers."""
    tokens = batch['tokens'].long()
    b, s = tokens.shape
    head = Tape(taps, quant)
    x = head.r(F.embedding(tokens, params['embed/table']))
    x, aux, tapes = run_layers(lambda p, tape, h: _block(cfg, p, tape, h),
                               x, cfg['n_layers'], params, taps, quant)
    a, count = stack_tapes(tapes)
    logits = linear(head.r(rmsnorm(x, params['norm_f/scale'])),
                    params['lm_head/w'], 'lm_head/w', head)
    a.update(head.a)
    return cross_entropy(logits, batch['labels']) + aux, a, count, b * s


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one forward and backward: 6 x the matmul weights a
    token passes through (attention, the router, its top-k experts, the
    head) x tokens, plus the causal attention products (QKᵀ and PV over
    the lower triangle, forward and backward: 3 x 2 x 2 x S²/2 x heads x
    head_dim a sequence and layer).  Recomputation is not counted."""
    d, h, kv, dh = cfg['d_model'], cfg['n_heads'], cfg['n_kv_heads'], \
        cfg['head_dim']
    per_layer = (d * h * dh + 2 * d * kv * dh + h * dh * d
                 + d * cfg['n_experts'] + cfg['top_k'] * 3 * d * cfg['d_ff'])
    weights = cfg['n_layers'] * per_layer + d * cfg['vocab']
    tokens = batch * seq
    attn = cfg['n_layers'] * batch * 3 * 2 * 2 * (seq * seq / 2) * h * dh
    return 6.0 * weights * tokens + attn
