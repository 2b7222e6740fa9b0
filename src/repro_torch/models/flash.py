"""Flash attention with a hand-written backward — PyTorch port of
``repro/models/flash.py`` (plain JAX with a custom VJP there).

A ``torch.autograd.Function``:

  forward : an online softmax over K/V chunks for each Q chunk, saving only
            (q, k, v, out, lse) — O(S·d), never the S×S probabilities;
  backward: recomputes each probability tile exactly from the saved LSE and
            accumulates dQ over the K/V chunks, dK and dV over the Q chunks
            (the flash-attention-2 split).

GQA is native: queries are grouped (B, S, KV, G, Dh) and K/V are never
repeated.  Causal masking is applied per tile; fully masked tiles still
compute, as in the reference.  Plain PyTorch, not a hand kernel.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32
NEG_INF = -1e30


def _chunks(sq: int, sk: int, q_chunk: int, k_chunk: int):
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, sk)
    if sq % q_chunk or sk % k_chunk:
        raise ValueError(f'flash chunks ({q_chunk}, {k_chunk}) do not divide '
                         f'the lengths ({sq}, {sk})')
    return q_chunk, k_chunk


def _scores(q_blk, k_blk, scale, causal, q0, k0):
    """(b, qc, kvh, g, dh) x (b, kc, kvh, dh) -> (b, kvh, g, qc, kc) f32,
    causal-masked for a tile whose first positions are (q0, k0)."""
    s = torch.einsum('bqkgd,bskd->bkgqs', q_blk, k_blk) * scale
    if causal:
        qp = q0 + torch.arange(q_blk.shape[1], device=s.device)
        kp = k0 + torch.arange(k_blk.shape[1], device=s.device)
        s = torch.where(qp[:, None] >= kp[None, :], s, NEG_INF)
    return s


def _flash_fwd(q, k, v, causal, q_chunk, k_chunk):
    """(out (B,S,H,Dh) in q's dtype, lse (B,KV,G,S) f32)."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q_chunk, k_chunk = _chunks(sq, sk, q_chunk, k_chunk)
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kvh, g, dh).to(F32)
    k32, v32 = k.to(F32), v.to(F32)
    outs, lses = [], []
    for q0 in range(0, sq, q_chunk):
        q_blk = qg[:, q0:q0 + q_chunk]
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, dtype=F32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, q_chunk, dh), dtype=F32,
                          device=q.device)
        for k0 in range(0, sk, k_chunk):
            s = _scores(q_blk, k32[:, k0:k0 + k_chunk], scale, causal, q0, k0)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                'bkgqs,bskd->bkgqd', p, v32[:, k0:k0 + k_chunk])
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).movedim(3, 1))   # (b,qc,kvh,g,dh)
        lses.append(m + torch.log(l))                     # (b,kvh,g,qc)
    out = torch.cat(outs, 1).reshape(b, sq, h, dh).to(q.dtype)
    return out, torch.cat(lses, -1)


def _flash_bwd(q, k, v, out, lse, dout, causal, q_chunk, k_chunk):
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q_chunk, k_chunk = _chunks(sq, sk, q_chunk, k_chunk)
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kvh, g, dh).to(F32)
    dog = dout.reshape(b, sq, kvh, g, dh).to(F32)
    og = out.reshape(b, sq, kvh, g, dh).to(F32)
    k32, v32 = k.to(F32), v.to(F32)
    delta = torch.einsum('bskgd,bskgd->bkgs', dog, og)    # rowsum(dO ⊙ O)

    def tiles(q0, k0):
        """(p, ds) of the tile at (q0, k0)."""
        sl_q, sl_k = slice(q0, q0 + q_chunk), slice(k0, k0 + k_chunk)
        s = _scores(qg[:, sl_q], k32[:, sl_k], scale, causal, q0, k0)
        p = torch.exp(s - lse[..., sl_q, None])           # (b,kvh,g,qc,kc)
        dp = torch.einsum('bqkgd,bskd->bkgqs', dog[:, sl_q], v32[:, sl_k])
        return p, p * (dp - delta[..., sl_q, None])

    # dQ: for each q chunk, accumulate over the kv chunks
    dqs = []
    for q0 in range(0, sq, q_chunk):
        dq = torch.zeros((b, q_chunk, kvh, g, dh), dtype=F32, device=q.device)
        for k0 in range(0, sk, k_chunk):
            _, ds = tiles(q0, k0)
            dq = dq + torch.einsum('bkgqs,bskd->bqkgd', ds,
                                   k32[:, k0:k0 + k_chunk]) * scale
        dqs.append(dq)
    dq = torch.cat(dqs, 1).reshape(b, sq, h, dh).to(q.dtype)

    # dK, dV: for each kv chunk, accumulate over the q chunks
    dks, dvs = [], []
    for k0 in range(0, sk, k_chunk):
        dk = torch.zeros((b, k_chunk, kvh, dh), dtype=F32, device=q.device)
        dv = torch.zeros_like(dk)
        for q0 in range(0, sq, q_chunk):
            p, ds = tiles(q0, k0)
            dv = dv + torch.einsum('bkgqs,bqkgd->bskd', p,
                                   dog[:, q0:q0 + q_chunk])
            dk = dk + torch.einsum('bkgqs,bqkgd->bskd', ds,
                                   qg[:, q0:q0 + q_chunk]) * scale
        dks.append(dk)
        dvs.append(dv)
    return (dq, torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype))


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, k_chunk):
        out, lse = _flash_fwd(q, k, v, causal, q_chunk, k_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.flash_args = (causal, q_chunk, k_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.flash_args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, q_chunk: int = 512,
                    k_chunk: int = 1024) -> torch.Tensor:
    """q: (B,S,H,Dh); k/v: (B,S,KV,Dh) -> (B,S,H,Dh)."""
    return _FlashAttention.apply(q, k, v, causal, q_chunk, k_chunk)
