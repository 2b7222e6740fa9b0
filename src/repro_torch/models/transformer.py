"""Decoder-only transformer LM of the dense, MoE and VLM families — PyTorch
port of ``repro/models/transformer.py``.

Layer-stacked parameters (``'blocks/attn/q/w'`` is ``(n_layers, d_in,
d_out)``), capture-aware linears everywhere, three entry points:

  * ``loss_fn``     — next-token CE (+ MoE aux), returns the KV-capture stats
  * ``prefill_fn``  — populate a KV cache, return last-position logits
  * ``decode_fn``   — one token in, logits + updated cache out

The reference's ``lax.scan`` over the stack is a Python loop here: each
stacked leaf, tap and cache is taken apart once with ``torch.unbind``, and
each path's per-layer stats are stacked back, so the stats (and the
optimizer state built from them) have the reference's shapes: ``a_mean``
``(n_layers, d_in)``, ``count`` ``(n_layers,)``.  ``remat`` checkpoints each
block (``torch.utils.checkpoint``): ``'full'`` saves nothing inside it,
``'dots'`` saves only the outputs of its matmuls without batch dims
(``aten.mm`` / ``aten.addmm``), as ``dots_with_no_batch_dims_saveable``; the
attention einsums are recomputed.  remat changes memory, never numbers.

VLM archs (``input_is_embeds``) take precomputed frontend embeddings for
train/prefill and fall back to the token table for decode.  MoE blocks
(``n_experts > 0``) route through ``models/moe.py`` and add their
load-balancing aux, summed over the layers, to the loss.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.core import kv as kvlib
from repro_torch.device import resolve_device
from repro_torch.models import module as M
from repro_torch.models.attention import (_full_positions, attention_block,
                                          attention_spec)
from repro_torch.models.layers import (embed, embed_spec, linear, linear_spec,
                                       make_norm, mlp, mlp_spec)
from repro_torch.models.moe import moe_apply, moe_spec
from repro_torch.obs import spans as obs_spans
from repro_torch.sharding.constraints import shard_activations

F32 = torch.float32
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of the matmuls without batch dims, recompute the
    rest (the reference's ``dots_with_no_batch_dims_saveable``)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXT = {
    'full': ckpt.noop_context_fn,
    'dots': functools.partial(ckpt.create_selective_checkpoint_contexts,
                              _dots_policy),
}


def remat_call(remat: str, fn, x: torch.Tensor, col: dict):
    """``fn(x, sink)`` under a checkpoint of kind ``remat`` ('full' or
    'dots').  Autograd's recompute runs ``fn`` again with the same capture,
    so that the matmuls it saved line up with the forward's; the first call
    records its stats into ``col``, the recompute's go to a dict that is
    dropped.  The recompute runs under a 'recompute' span."""
    calls = []

    def run(x):
        if calls:
            with obs_spans.span('recompute'):
                return fn(x, {})
        calls.append(None)
        return fn(x, col)

    return ckpt.checkpoint(run, x, use_reentrant=False,
                           context_fn=_REMAT_CONTEXT[remat])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in f32 without materializing one-hots."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _unstack(tree: Optional[dict], n: int) -> list:
    """A flat dict of stacked leaves -> ``n`` per-layer dicts (``[None] *
    n`` for None), each leaf taken apart once."""
    if not tree:
        return [None] * n
    parts = {k: torch.unbind(v, 0) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _stack_stats(cols: list[dict]) -> dict:
    """Per-layer ``{path: LayerStats}`` -> one ``LayerStats`` per path with
    each field stacked over the layers."""
    return {path: kvlib.LayerStats(*(
        None if fields[0] is None else torch.stack(fields)
        for fields in zip(*(c[path] for c in cols))))
        for path in cols[0]}


class TransformerLM:
    """Families: dense, moe, vlm."""

    def __init__(self, cfg: ArchConfig):
        if cfg.remat not in ('none', 'full', 'dots'):
            raise ValueError(f'remat {cfg.remat!r}; have none, full, dots')
        self.cfg = cfg

    # -- specs ------------------------------------------------------------

    def block_spec(self) -> dict:
        cfg = self.cfg
        norm_spec, _ = make_norm(cfg.norm)
        spec = {
            'norm1': norm_spec(cfg.d_model, cfg.pdtype),
            'attn': attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.pdtype, cfg.qkv_bias),
            'norm2': norm_spec(cfg.d_model, cfg.pdtype),
        }
        if cfg.n_experts:
            spec['moe'] = moe_spec(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                   cfg.pdtype)
            if cfg.n_shared_experts:
                spec['shared_mlp'] = mlp_spec(
                    cfg.d_model, cfg.d_ff * cfg.n_shared_experts, cfg.pdtype)
        else:
            spec['mlp'] = mlp_spec(cfg.d_model, cfg.d_ff, cfg.pdtype)
        return spec

    def param_specs(self) -> dict:
        cfg = self.cfg
        norm_spec, _ = make_norm(cfg.norm)
        specs = {
            'embed': embed_spec(cfg.vocab, cfg.d_model, cfg.pdtype),
            'blocks': M.stack_specs(self.block_spec(), cfg.n_layers),
            'norm_f': norm_spec(cfg.d_model, cfg.pdtype),
        }
        if not cfg.tie_embeddings:
            specs['lm_head'] = linear_spec(cfg.d_model, cfg.vocab,
                                           dtype=cfg.pdtype,
                                           axes=('embed', 'vocab'))
        return specs

    def precon_paths(self) -> set[str]:
        cfg = self.cfg
        paths = {f'blocks/attn/{s}/w' for s in ('q', 'k', 'v', 'o')}
        if cfg.n_experts:
            paths |= {f'blocks/moe/{s}/w'
                      for s in ('router', 'gate', 'up', 'down')}
            if cfg.n_shared_experts:
                paths |= {f'blocks/shared_mlp/{s}/w'
                          for s in ('gate', 'up', 'down')}
        else:
            paths |= {f'blocks/mlp/{s}/w' for s in ('gate', 'up', 'down')}
        if not cfg.tie_embeddings:
            paths.add('lm_head/w')
        return paths

    # -- block ------------------------------------------------------------

    def _block(self, p, x, *, positions, col, taps, capture, cache=None,
               cache_pos=None):
        """One block on its flat per-layer dict ``p`` ('attn/q/w', ...):
        (x, new cache, MoE aux)."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        kw = dict(col=col, taps=taps, capture=capture,
                  compute_dtype=cfg.cdtype)
        h = norm(M.subtree(p, 'norm1'), x)
        att, new_cache = attention_block(
            p, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, positions=positions, causal=True,
            rope=True, rope_theta=cfg.rope_theta, impl=cfg.attn_impl,
            q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, cache=cache,
            cache_pos=cache_pos, path='attn', **kw)
        x = x + att
        h2 = norm(M.subtree(p, 'norm2'), x)
        if cfg.n_experts:
            ff, aux = moe_apply(p, h2, top_k=cfg.top_k,
                                capacity_factor=cfg.capacity_factor,
                                norm_topk=cfg.norm_topk, path='moe',
                                aux_coef=cfg.moe_aux_coef, **kw)
            if cfg.n_shared_experts:
                ff = ff + mlp(p, h2, path='shared_mlp', **kw)
        else:
            ff = mlp(p, h2, path='mlp', **kw)
            aux = torch.zeros((), dtype=F32, device=x.device)
        return x + ff, new_cache, aux

    def _remat_block(self, p, x, *, positions, col, taps, capture):
        """``_block`` under a checkpoint: (x, MoE aux)."""
        def run(x, sink):
            y, _, aux = self._block(p, x, positions=positions, col=sink,
                                    taps=taps, capture=capture)
            return y, aux
        return remat_call(self.cfg.remat, run, x, col)

    # -- forward (train / prefill share the layer loop) -------------------

    def _forward(self, params, x, positions, *, taps=None, capture=None,
                 cache=None, cache_pos=None):
        n = self.cfg.n_layers
        layers = _unstack(M.subtree(params, 'blocks'), n)
        layer_taps = _unstack(M.subtree(taps, 'blocks'), n)
        layer_caches = _unstack((cache or {}).get('blocks'), n)
        remat = (self.cfg.remat != 'none' and cache is None
                 and torch.is_grad_enabled())
        cols, new_caches, auxs = [], [], []
        for p, bt, bc in zip(layers, layer_taps, layer_caches):
            x = shard_activations(x)
            bcol: dict = {}
            if remat:
                x, aux = self._remat_block(p, x, positions=positions,
                                           col=bcol, taps=bt, capture=capture)
            else:
                x, bc, aux = self._block(p, x, positions=positions, col=bcol,
                                         taps=bt, capture=capture, cache=bc,
                                         cache_pos=cache_pos)
            cols.append(bcol)
            new_caches.append(bc)
            auxs.append(aux)
        new_cache = None
        if cache is not None:
            new_cache = dict(cache)
            new_cache['blocks'] = {k: torch.stack([c[k] for c in new_caches])
                                   for k in new_caches[0]}
        return (x, M.add_prefix(_stack_stats(cols), 'blocks'),
                torch.stack(auxs).sum(), new_cache)

    def _logits(self, params, x, col, taps, capture):
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        x = norm(M.subtree(params, 'norm_f'), x)
        if cfg.tie_embeddings:
            table = params['embed/table']
            return x.to(cfg.cdtype) @ table.T.to(cfg.cdtype)
        return linear(params, x, path='lm_head', col=col, taps=taps,
                      capture=capture, compute_dtype=cfg.cdtype)

    def _embed_in(self, params, batch):
        cfg = self.cfg
        if cfg.input_is_embeds and 'embeds' in batch:
            return batch['embeds'].to(cfg.cdtype)
        return embed(M.subtree(params, 'embed'), batch['tokens'], cfg.cdtype)

    # -- entry points -------------------------------------------------------

    def loss_fn(self, params, taps, batch,
                capture: Optional[kvlib.CaptureConfig]):
        x = self._embed_in(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, col, aux, _ = self._forward(params, x, positions, taps=taps,
                                       capture=capture)
        logits = self._logits(params, x, col, taps, capture)
        loss = cross_entropy(logits, batch['labels']) + aux
        return loss, {'stats': col, 'n_tokens': b * s}

    def init_cache(self, batch_size: int, max_seq: int, device='cuda',
                   abstract: bool = False):
        """Zero caches; ``abstract``: meta tensors (shapes and dtypes, the
        dry run's stand-ins) whatever ``device``."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        dev = torch.device('meta') if abstract else resolve_device(device)
        dt = torch_dtype(cfg.cache_dtype)
        return {'blocks': {'k': torch.zeros(shape, dtype=dt, device=dev),
                           'v': torch.zeros(shape, dtype=dt, device=dev)}}

    @torch.no_grad()
    def prefill_fn(self, params, batch):
        x = self._embed_in(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        cache = self.init_cache(b, s, device=x.device)
        x, col, _, cache = self._forward(params, x, positions, cache=cache)
        logits = self._logits(params, x[:, -1:, :], col, None, None)
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_fn(self, params, cache, tokens, pos):
        """tokens: (B,) int; pos: the write position (an int or a 0-d
        tensor)."""
        x = embed(M.subtree(params, 'embed'), tokens[:, None], self.cfg.cdtype)
        positions = _full_positions(tokens.shape[0], pos, x.device)
        x, col, _, new_cache = self._forward(params, x, positions,
                                             cache=cache, cache_pos=pos)
        logits = self._logits(params, x, col, None, None)
        return logits[:, 0], new_cache
