"""GQA attention — PyTorch port of ``repro/models/attention.py``: the naive
and chunked (online-softmax) paths, flash (``models/flash.py``) and the
KV-cache decode.  KV heads are never repeated: queries are grouped ``(B, S,
KV, G, Dh)`` and contracted against the un-repeated K/V.

``_shard_heads`` lays q, k and v out with the heads over the model axis
(the identity without a mesh in scope).  A cache passed in is never
written: each write returns a new cache tensor (``index_copy`` out of
place), as ``lax.dynamic_update_slice`` does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import apply_rope, linear, linear_spec
from repro_torch.sharding.constraints import constrain

F32 = torch.float32
NEG_INF = -1e30


def _shard_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh): batch -> data axes, heads -> model when divisible,
    head_dim never sharded (a sharded contraction dim would all-reduce
    every attention score tile)."""
    return constrain(x, 'data', None, 'model', None)


def attention_spec(d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype=torch.float32,
                   qkv_bias: bool = False) -> dict:
    return {
        'q': linear_spec(d_model, n_heads * head_dim, qkv_bias, dtype,
                         ('embed', 'heads')),
        'k': linear_spec(d_model, n_kv_heads * head_dim, qkv_bias, dtype,
                         ('embed', 'kv_heads')),
        'v': linear_spec(d_model, n_kv_heads * head_dim, qkv_bias, dtype,
                         ('embed', 'kv_heads')),
        'o': linear_spec(n_heads * head_dim, d_model, False, dtype,
                         ('heads', 'embed')),
    }


# ---------------------------------------------------------------------------
# Core attends (q: (B,Sq,H,Dh), k/v: (B,Sk,KV,Dh))


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    b, s, h, dh = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, dh)


def attend_naive(q, k, v, *, causal: bool, q_positions=None,
                 k_positions=None) -> torch.Tensor:
    b, sq, h, dh = q.shape
    qg = _group(q, k.shape[2])
    scale = 1.0 / math.sqrt(dh)
    scores = torch.einsum('bqkgd,bskd->bkgqs', qg.to(F32), k.to(F32)) * scale
    if causal:
        qp = q_positions if q_positions is not None else \
            torch.arange(sq, device=q.device)
        kp = k_positions if k_positions is not None else \
            torch.arange(k.shape[1], device=q.device)
        mask = qp[:, None] >= kp[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum('bkgqs,bskd->bqkgd', w, v.to(F32))
    return out.reshape(b, sq, h, dh).to(q.dtype)


def attend_chunked(q, k, v, *, causal: bool, q_chunk: int = 512,
                   k_chunk: int = 1024) -> torch.Tensor:
    """Flash-style: a loop over query chunks, and inside it over key chunks
    with an online softmax.  Causal masking is applied per (q_chunk ×
    k_chunk) tile; fully masked tiles still compute, as in the reference."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, sk)
    nq, nk = sq // q_chunk, sk // k_chunk
    if sq % q_chunk or sk % k_chunk:
        raise ValueError(f'chunks ({q_chunk}, {k_chunk}) do not divide the '
                         f'lengths ({sq}, {sk})')
    scale = 1.0 / math.sqrt(dh)
    qg = _group(q, kvh).reshape(b, nq, q_chunk, kvh, g, dh).to(F32)
    kc = k.reshape(b, nk, k_chunk, kvh, dh).to(F32)
    vc = v.reshape(b, nk, k_chunk, kvh, dh).to(F32)
    outs = []
    for qi in range(nq):
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, dtype=F32,
                       device=q.device)
        l = torch.zeros((b, kvh, g, q_chunk), dtype=F32, device=q.device)
        acc = torch.zeros((b, kvh, g, q_chunk, dh), dtype=F32,
                          device=q.device)
        for ki in range(nk):
            s = torch.einsum('bqkgd,bskd->bkgqs', qg[:, qi], kc[:, ki]) * scale
            if causal:
                qp = qi * q_chunk + torch.arange(q_chunk, device=q.device)
                kp = ki * k_chunk + torch.arange(k_chunk, device=q.device)
                s = torch.where(qp[:, None] >= kp[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                'bkgqs,bskd->bkgqd', p, vc[:, ki])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (b,kvh,g,qc,dh)
        outs.append(out.movedim(3, 1))                    # (b,qc,kvh,g,dh)
    return torch.stack(outs, 1).reshape(b, sq, h, dh).to(q.dtype)


def attend_decode(q, cache_k, cache_v, pos) -> torch.Tensor:
    """Single-token decode: q (B,1,H,Dh) against the full cache, masked to
    positions <= pos.  O(S) — the sub-quadratic decode path."""
    b, _, h, dh = q.shape
    qg = _group(q, cache_k.shape[2])
    scale = 1.0 / math.sqrt(dh)
    s = torch.einsum('bqkgd,bskd->bkgqs', qg.to(F32), cache_k.to(F32)) * scale
    valid = torch.arange(cache_k.shape[1], device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum('bkgqs,bskd->bqkgd', w, cache_v.to(F32))
    return out.reshape(b, 1, h, dh).to(q.dtype)


def attend(q, k, v, *, causal: bool, impl: str = 'naive',
           q_chunk: int = 512, k_chunk: int = 1024) -> torch.Tensor:
    if impl == 'flash':
        return flash_attention(q, k, v, causal, q_chunk, k_chunk)
    if impl == 'chunked':
        return attend_chunked(q, k, v, causal=causal, q_chunk=q_chunk,
                              k_chunk=k_chunk)
    return attend_naive(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# Full attention block (projections + rope + attend)


def _cache_write(buf: torch.Tensor, new: torch.Tensor, start) -> torch.Tensor:
    """``buf`` with ``new`` written along the sequence dim from ``start``
    (an int or a 0-d tensor), out of place.  ``start`` is clamped so the
    write fits, as ``lax.dynamic_update_slice`` clamps it."""
    s = new.shape[1]
    start = torch.clamp(torch.as_tensor(start, device=buf.device),
                        0, buf.shape[1] - s)
    idx = start.long() + torch.arange(s, device=buf.device)
    return buf.index_copy(1, idx, new.to(buf.dtype))


def _full_positions(b: int, pos, device) -> torch.Tensor:
    """(b, 1) positions all equal to ``pos`` (an int or a 0-d tensor)."""
    return torch.as_tensor(pos, device=device).reshape(1, 1).expand(b, 1)


def attention_block(p, x, *, n_heads: int, n_kv_heads: int, head_dim: int,
                    positions, causal: bool = True, rope: bool = True,
                    rope_theta: float = 10000.0, impl: str = 'naive',
                    q_chunk: int = 512, k_chunk: int = 1024,
                    kv_x: Optional[torch.Tensor] = None,
                    is_cross: bool = False, cache: Optional[dict] = None,
                    cache_pos=None, cross_prefill: bool = False,
                    path: str = '', col=None, taps=None, capture=None,
                    compute_dtype=None):
    """Returns (out, new_cache).  ``p`` is a flat dict holding
    ``f'{path}/q/w'`` and the rest.  ``is_cross`` marks cross-attention (K/V
    from ``kv_x`` at train/prefill, from ``cache`` at decode);
    ``cross_prefill`` computes cross K/V from ``kv_x`` and writes the
    cache."""
    b = x.shape[0]
    kw = dict(col=col if col is not None else {}, taps=taps, capture=capture,
              compute_dtype=compute_dtype)
    q = linear(p, x, path=f'{path}/q', **kw)
    q = q.reshape(b, x.shape[1], n_heads, head_dim)
    if rope:
        q = apply_rope(q, positions, rope_theta)
    q = _shard_heads(q)

    if is_cross:
        if cache is not None and not cross_prefill:
            # decode: read-only cached encoder keys/values
            out = attend_naive(q, cache['k'], cache['v'], causal=False)
            new_cache = cache
        else:
            if kv_x is None:
                raise ValueError('cross-attention needs kv_x at '
                                 'train/prefill')
            k = linear(p, kv_x, path=f'{path}/k', **kw)
            v = linear(p, kv_x, path=f'{path}/v', **kw)
            k = _shard_heads(k.reshape(b, kv_x.shape[1], n_kv_heads,
                                       head_dim))
            v = _shard_heads(v.reshape(b, kv_x.shape[1], n_kv_heads,
                                       head_dim))
            new_cache = None
            if cache is not None:  # cross prefill: populate the cache
                new_cache = {'k': _cache_write(cache['k'], k, 0),
                             'v': _cache_write(cache['v'], v, 0)}
            out = attend_naive(q, k, v, causal=False)
    else:
        k = linear(p, x, path=f'{path}/k', **kw)
        v = linear(p, x, path=f'{path}/v', **kw)
        k = _shard_heads(k.reshape(b, x.shape[1], n_kv_heads, head_dim))
        v = _shard_heads(v.reshape(b, x.shape[1], n_kv_heads, head_dim))
        decode = cache is not None and q.shape[1] == 1
        if rope:
            k_pos = _full_positions(b, cache_pos, x.device) if decode \
                else positions
            k = apply_rope(k, k_pos, rope_theta)
        new_cache = None
        if cache is not None:
            start = cache_pos if decode else 0
            new_cache = {'k': _cache_write(cache['k'], k, start),
                         'v': _cache_write(cache['v'], v, start)}
        if decode:
            out = attend_decode(q, new_cache['k'], new_cache['v'], cache_pos)
        else:
            out = attend(q, k, v, causal=causal, impl=impl, q_chunk=q_chunk,
                         k_chunk=k_chunk)

    out = out.reshape(b, x.shape[1], n_heads * head_dim)
    y = linear(p, out, path=f'{path}/o', **kw)
    return y, new_cache
