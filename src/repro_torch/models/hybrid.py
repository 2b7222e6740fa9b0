"""Jamba-style hybrid: attention and Mamba mixers interleaved, with MoE
every few layers — PyTorch port of ``repro/models/hybrid.py``.

Layer ``i`` has an attention mixer iff ``i % attn_period == attn_offset``
(Jamba: one attention in 8 layers) and an MoE FFN iff ``i % expert_period
== expert_offset`` (Jamba: every other layer); the other FFNs are dense.
The layers run as super-blocks of ``attn_period`` sublayers, stacked over
``n_layers / attn_period`` (``'blocks/sub_<i>/...'``), so each sublayer
kind is fixed inside a super-block and the two kinds of cache sit side by
side.

The mixer is the port's Mamba-2 SSD block, as in the reference (Jamba's
own is Mamba-1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.core import kv as kvlib
from repro_torch.device import resolve_device
from repro_torch.models import module as M
from repro_torch.models.attention import (_full_positions, attention_block,
                                          attention_spec)
from repro_torch.models.layers import (embed, embed_spec, linear, linear_spec,
                                       make_norm, mlp, mlp_spec)
from repro_torch.models.mamba_lm import stack_caches, unstack_cache
from repro_torch.models.moe import moe_apply, moe_spec
from repro_torch.models.ssm import mamba_block, mamba_spec, ssm_dims
from repro_torch.models.transformer import (_stack_stats, _unstack,
                                            cross_entropy, remat_call)
from repro_torch.sharding.constraints import shard_activations

F32 = torch.float32


class JambaLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.attn_period <= 0 or cfg.n_layers % cfg.attn_period:
            raise ValueError(f'n_layers {cfg.n_layers} is not a whole number '
                             f'of attn_period {cfg.attn_period} layers')
        if cfg.remat not in ('none', 'full', 'dots'):
            raise ValueError(f'remat {cfg.remat!r}; have none, full, dots')
        self.cfg = cfg
        self.n_super = cfg.n_layers // cfg.attn_period

    def _sub_is_attn(self, i: int) -> bool:
        return i % self.cfg.attn_period == self.cfg.attn_offset

    def _sub_is_moe(self, i: int) -> bool:
        cfg = self.cfg
        return cfg.expert_period > 0 and \
            i % cfg.expert_period == cfg.expert_offset

    def sub_spec(self, i: int) -> dict:
        cfg = self.cfg
        norm_spec, _ = make_norm(cfg.norm)
        spec = {'norm1': norm_spec(cfg.d_model, cfg.pdtype),
                'norm2': norm_spec(cfg.d_model, cfg.pdtype)}
        if self._sub_is_attn(i):
            spec['attn'] = attention_spec(cfg.d_model, cfg.n_heads,
                                          cfg.n_kv_heads, cfg.head_dim,
                                          cfg.pdtype, cfg.qkv_bias)
        else:
            spec['mixer'] = mamba_spec(cfg.d_model, expand=cfg.ssm_expand,
                                       headdim=cfg.ssm_headdim,
                                       d_state=cfg.ssm_state,
                                       d_conv=cfg.ssm_conv, dtype=cfg.pdtype)
        if self._sub_is_moe(i):
            spec['moe'] = moe_spec(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                   cfg.pdtype)
        else:
            spec['mlp'] = mlp_spec(cfg.d_model, cfg.d_ff, cfg.pdtype)
        return spec

    def param_specs(self) -> dict:
        cfg = self.cfg
        norm_spec, _ = make_norm(cfg.norm)
        super_spec = {f'sub_{i}': self.sub_spec(i)
                      for i in range(cfg.attn_period)}
        specs = {
            'embed': embed_spec(cfg.vocab, cfg.d_model, cfg.pdtype),
            'blocks': M.stack_specs(super_spec, self.n_super),
            'norm_f': norm_spec(cfg.d_model, cfg.pdtype),
        }
        if not cfg.tie_embeddings:
            specs['lm_head'] = linear_spec(cfg.d_model, cfg.vocab,
                                           dtype=cfg.pdtype,
                                           axes=('embed', 'vocab'))
        return specs

    def precon_paths(self) -> set[str]:
        cfg = self.cfg
        paths = set()
        for i in range(cfg.attn_period):
            base = f'blocks/sub_{i}'
            if self._sub_is_attn(i):
                paths |= {f'{base}/attn/{s}/w' for s in ('q', 'k', 'v', 'o')}
            else:
                paths |= {f'{base}/mixer/in_proj/w',
                          f'{base}/mixer/out_proj/w'}
            if self._sub_is_moe(i):
                paths |= {f'{base}/moe/{s}/w'
                          for s in ('router', 'gate', 'up', 'down')}
            else:
                paths |= {f'{base}/mlp/{s}/w' for s in ('gate', 'up', 'down')}
        if not cfg.tie_embeddings:
            paths.add('lm_head/w')
        return paths

    # -- sublayer and super-block -------------------------------------------

    def _sublayer(self, i, p, x, *, positions, col, taps, capture,
                  cache=None, cache_pos=None, prefill: bool = False):
        """Sublayer ``i`` on its flat dict ``p``: (x, new cache, aux)."""
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        kw = dict(col=col, taps=taps, capture=capture,
                  compute_dtype=cfg.cdtype)
        h = norm(M.subtree(p, 'norm1'), x)
        if self._sub_is_attn(i):
            out, new_cache = attention_block(
                p, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, positions=positions, causal=True,
                rope=True, rope_theta=cfg.rope_theta, impl=cfg.attn_impl,
                q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, cache=cache,
                cache_pos=cache_pos, path='attn', **kw)
        else:
            # prefill: ignore the preallocated (zero) cache, emit a fresh one
            out, new_cache = mamba_block(
                p, h, headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                d_conv=cfg.ssm_conv, chunk=cfg.ssm_chunk,
                cache=None if prefill else cache, return_cache=prefill,
                path='mixer', **kw)
        x = x + out
        h2 = norm(M.subtree(p, 'norm2'), x)
        if self._sub_is_moe(i):
            ff, aux = moe_apply(p, h2, top_k=cfg.top_k,
                                capacity_factor=cfg.capacity_factor,
                                norm_topk=cfg.norm_topk, path='moe',
                                aux_coef=cfg.moe_aux_coef, **kw)
        else:
            ff = mlp(p, h2, path='mlp', **kw)
            aux = torch.zeros((), dtype=F32, device=x.device)
        return x + ff, new_cache, aux

    def _super_block(self, p, x, *, positions, col, taps, capture,
                     cache=None, cache_pos=None, prefill=False):
        """The ``attn_period`` sublayers: (x, {'sub_<i>': cache}, aux)."""
        caches, aux = {}, torch.zeros((), dtype=F32, device=x.device)
        for i in range(self.cfg.attn_period):
            sub = f'sub_{i}'
            sub_col: dict = {}
            x, nc, a = self._sublayer(
                i, M.subtree(p, sub), x, positions=positions, col=sub_col,
                taps=M.subtree(taps, sub), capture=capture,
                cache=cache.get(sub) if cache else None,
                cache_pos=cache_pos, prefill=prefill)
            col.update(M.add_prefix(sub_col, sub))
            if nc is not None:
                caches[sub] = nc
            aux = aux + a
        return x, caches, aux

    def _forward(self, params, x, positions, *, taps=None, capture=None,
                 cache=None, cache_pos=None, prefill: bool = False):
        n = self.n_super
        blocks = _unstack(M.subtree(params, 'blocks'), n)
        block_taps = _unstack(M.subtree(taps, 'blocks'), n)
        block_caches = [None] * n if cache is None else \
            unstack_cache(cache['blocks'], n)
        remat = (self.cfg.remat != 'none' and cache is None
                 and torch.is_grad_enabled())
        cols, new_caches, auxs = [], [], []
        for p, bt, bc in zip(blocks, block_taps, block_caches):
            x = shard_activations(x)
            bcol: dict = {}
            if remat:
                def run(h, sink, p=p, bt=bt):
                    y, _, a = self._super_block(p, h, positions=positions,
                                                col=sink, taps=bt,
                                                capture=capture)
                    return y, a
                x, aux = remat_call(self.cfg.remat, run, x, bcol)
            else:
                x, bc, aux = self._super_block(
                    p, x, positions=positions, col=bcol, taps=bt,
                    capture=capture, cache=bc, cache_pos=cache_pos,
                    prefill=prefill)
            cols.append(bcol)
            new_caches.append(bc)
            auxs.append(aux)
        new_cache = None if cache is None else \
            {'blocks': stack_caches(new_caches)}
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

    # -- entry points ---------------------------------------------------------

    def loss_fn(self, params, taps, batch,
                capture: Optional[kvlib.CaptureConfig]):
        x = embed(M.subtree(params, 'embed'), batch['tokens'],
                  self.cfg.cdtype)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, col, aux, _ = self._forward(params, x, positions, taps=taps,
                                       capture=capture)
        logits = self._logits(params, x, col, taps, capture)
        return cross_entropy(logits, batch['labels']) + aux, \
            {'stats': col, 'n_tokens': b * s}

    def init_cache(self, batch_size: int, max_seq: int, device='cuda',
                   abstract: bool = False):
        """Zero caches; ``abstract``: meta tensors (shapes and dtypes, the
        dry run's stand-ins) whatever ``device``."""
        cfg = self.cfg
        _, nheads, conv_ch = ssm_dims(cfg.d_model, cfg.ssm_expand,
                                      cfg.ssm_headdim, cfg.ssm_state,
                                      cfg.ssm_conv)
        dev = torch.device('meta') if abstract else resolve_device(device)
        cdt = torch_dtype(cfg.cache_dtype)
        n, b = self.n_super, batch_size

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=dev)
        blocks = {}
        for i in range(cfg.attn_period):
            if self._sub_is_attn(i):
                shape = (n, b, max_seq, cfg.n_kv_heads, cfg.head_dim)
                blocks[f'sub_{i}'] = {'k': zeros(shape, cdt),
                                      'v': zeros(shape, cdt)}
            else:
                blocks[f'sub_{i}'] = {
                    'conv': zeros((n, b, cfg.ssm_conv - 1, conv_ch), cdt),
                    'ssm': zeros((n, b, nheads, cfg.ssm_state,
                                  cfg.ssm_headdim), torch.float32)}
        return {'blocks': blocks}

    @torch.no_grad()
    def prefill_fn(self, params, batch):
        """Attention sublayers write into a preallocated cache; Mamba
        sublayers build theirs from the forward."""
        x = embed(M.subtree(params, 'embed'), batch['tokens'],
                  self.cfg.cdtype)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        cache = self.init_cache(b, s, device=x.device)
        x, col, _, new_cache = self._forward(params, x, positions,
                                             cache=cache, prefill=True)
        logits = self._logits(params, x[:, -1:, :], col, None, None)
        return logits[:, 0], new_cache

    @torch.no_grad()
    def decode_fn(self, params, cache, tokens, pos):
        x = embed(M.subtree(params, 'embed'), tokens[:, None],
                  self.cfg.cdtype)
        positions = _full_positions(tokens.shape[0], pos, x.device)
        x, col, _, new_cache = self._forward(params, x, positions,
                                             cache=cache, cache_pos=pos)
        logits = self._logits(params, x, col, None, None)
        return logits[:, 0], new_cache
