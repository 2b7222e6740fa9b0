"""Whisper-style encoder-decoder backbone (the ``encdec`` family) — PyTorch
port of ``repro/models/encdec.py``.

The conv audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model).  Sinusoidal positions,
LayerNorm, GELU MLPs, biases on QKV; the decoder adds causal
self-attention and cross-attention to the encoder's output, and decode
serves from a self cache and a cross cache.  ``dec_len = seq_len //
dec_ratio``.  Both stacks attend naively (``attention_block``'s default),
as the reference's do.
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
from repro_torch.models.layers import (embed, embed_spec, gelu_mlp,
                                       gelu_mlp_spec, linear, linear_spec,
                                       make_norm, sinusoidal_positions)
from repro_torch.models.mamba_lm import stack_caches, unstack_cache
from repro_torch.models.transformer import (_stack_stats, _unstack,
                                            cross_entropy, remat_call)
from repro_torch.sharding.constraints import shard_activations


class EncDecLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.remat not in ('none', 'full', 'dots'):
            raise ValueError(f'remat {cfg.remat!r}; have none, full, dots')
        self.cfg = cfg
        self.n_enc = cfg.n_enc_layers or cfg.n_layers
        self.n_dec = cfg.n_dec_layers or cfg.n_layers

    # -- specs --------------------------------------------------------------

    def _enc_block_spec(self) -> dict:
        cfg = self.cfg
        norm_spec, _ = make_norm(cfg.norm)
        return {
            'norm1': norm_spec(cfg.d_model, cfg.pdtype),
            'attn': attention_spec(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, cfg.pdtype, cfg.qkv_bias),
            'norm2': norm_spec(cfg.d_model, cfg.pdtype),
            'mlp': gelu_mlp_spec(cfg.d_model, cfg.d_ff, cfg.pdtype),
        }

    def _dec_block_spec(self) -> dict:
        cfg = self.cfg
        norm_spec, _ = make_norm(cfg.norm)
        spec = dict(self._enc_block_spec())
        spec['norm_x'] = norm_spec(cfg.d_model, cfg.pdtype)
        spec['xattn'] = attention_spec(cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim,
                                       cfg.pdtype, cfg.qkv_bias)
        return spec

    def param_specs(self) -> dict:
        cfg = self.cfg
        norm_spec, _ = make_norm(cfg.norm)
        return {
            'embed': embed_spec(cfg.vocab, cfg.d_model, cfg.pdtype),
            'enc_blocks': M.stack_specs(self._enc_block_spec(), self.n_enc),
            'enc_norm_f': norm_spec(cfg.d_model, cfg.pdtype),
            'dec_blocks': M.stack_specs(self._dec_block_spec(), self.n_dec),
            'dec_norm_f': norm_spec(cfg.d_model, cfg.pdtype),
            'lm_head': linear_spec(cfg.d_model, cfg.vocab, dtype=cfg.pdtype,
                                   axes=('embed', 'vocab')),
        }

    def precon_paths(self) -> set[str]:
        paths = set()
        for stack, subs in (('enc_blocks', ('attn',)),
                            ('dec_blocks', ('attn', 'xattn'))):
            for sub in subs:
                paths |= {f'{stack}/{sub}/{s}/w' for s in ('q', 'k', 'v', 'o')}
            paths |= {f'{stack}/mlp/fc1/w', f'{stack}/mlp/fc2/w'}
        paths.add('lm_head/w')
        return paths

    def _attn_kw(self):
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, rope=False)

    def _loop(self, stack: str, n: int, params, x, taps, block, caches=None):
        """Run ``block(p, h, col, taps, cache) -> (h, new cache)`` over the
        ``n`` layers of ``stack``, under remat where it applies.  Returns
        (x, stacked stats under ``stack``, per-layer new caches)."""
        layers = _unstack(M.subtree(params, stack), n)
        layer_taps = _unstack(M.subtree(taps, stack), n)
        caches = caches or [None] * n
        remat = (self.cfg.remat != 'none' and caches[0] is None
                 and torch.is_grad_enabled())
        cols, new_caches = [], []
        for p, bt, bc in zip(layers, layer_taps, caches):
            x = shard_activations(x)
            bcol: dict = {}
            if remat:
                def run(h, sink, p=p, bt=bt):
                    return block(p, h, sink, bt, None)[0]
                x = remat_call(self.cfg.remat, run, x, bcol)
            else:
                x, bc = block(p, x, bcol, bt, bc)
            cols.append(bcol)
            new_caches.append(bc)
        return x, M.add_prefix(_stack_stats(cols), stack), new_caches

    # -- encoder ------------------------------------------------------------

    def _encode(self, params, embeds, *, taps=None, capture=None):
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        x = embeds.to(cfg.cdtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])

        def block(p, h, col, bt, _cache):
            kw = dict(col=col, taps=bt, capture=capture,
                      compute_dtype=cfg.cdtype)
            a, _ = attention_block(p, norm(M.subtree(p, 'norm1'), h),
                                   positions=positions, causal=False,
                                   path='attn', **self._attn_kw(), **kw)
            h = h + a
            h = h + gelu_mlp(p, norm(M.subtree(p, 'norm2'), h), path='mlp',
                             **kw)
            return h, None

        x, col, _ = self._loop('enc_blocks', self.n_enc, params, x, taps,
                               block)
        return norm(M.subtree(params, 'enc_norm_f'), x), col

    # -- decoder ------------------------------------------------------------

    def _decode_stack(self, params, x, enc_out, *, taps=None, capture=None,
                      cache=None, cache_pos=None, prefill: bool = False):
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        b, s = x.shape[:2]
        if cache_pos is not None and s == 1:
            positions = _full_positions(b, cache_pos, x.device)
            # decode: the table sized to the cache's max sequence length
            max_seq = cache['dec']['self']['k'].shape[2] \
                if cache is not None else 4096
            pe = sinusoidal_positions(max_seq, cfg.d_model, x.device)
            at = torch.clamp(torch.as_tensor(cache_pos, device=x.device),
                             0, max_seq - 1).reshape(1)
            x = x + pe.index_select(0, at.long())[None].to(x.dtype)
        else:
            positions = torch.arange(s, device=x.device).expand(b, s)
            x = x + sinusoidal_positions(s, cfg.d_model,
                                         x.device)[None].to(x.dtype)

        def block(p, h, col, bt, bc):
            kw = dict(col=col, taps=bt, capture=capture,
                      compute_dtype=cfg.cdtype)
            a, self_c = attention_block(
                p, norm(M.subtree(p, 'norm1'), h), positions=positions,
                causal=True, cache=bc['self'] if bc else None,
                cache_pos=cache_pos, path='attn', **self._attn_kw(), **kw)
            h = h + a
            # cross-attention: train/prefill K/V from enc_out (prefill
            # writes the cross cache); decode reads the cached cross K/V
            xa, cross_c = attention_block(
                p, norm(M.subtree(p, 'norm_x'), h), positions=positions,
                causal=False, kv_x=enc_out, is_cross=True,
                cache=bc['cross'] if bc else None, cross_prefill=prefill,
                path='xattn', **self._attn_kw(), **kw)
            h = h + xa
            h = h + gelu_mlp(p, norm(M.subtree(p, 'norm2'), h), path='mlp',
                             **kw)
            return h, ({'self': self_c, 'cross': cross_c} if bc else None)

        caches = None if cache is None else unstack_cache(cache['dec'],
                                                          self.n_dec)
        x, col, new_caches = self._loop('dec_blocks', self.n_dec, params, x,
                                        taps, block, caches)
        new_cache = None if cache is None else \
            {'dec': stack_caches(new_caches)}
        return norm(M.subtree(params, 'dec_norm_f'), x), col, new_cache

    # -- entry points ---------------------------------------------------------

    def loss_fn(self, params, taps, batch,
                capture: Optional[kvlib.CaptureConfig]):
        cfg = self.cfg
        enc_out, col_e = self._encode(params, batch['embeds'], taps=taps,
                                      capture=capture)
        x = embed(M.subtree(params, 'embed'), batch['tokens'], cfg.cdtype)
        b, s = x.shape[:2]
        x, col_d, _ = self._decode_stack(params, x, enc_out, taps=taps,
                                         capture=capture)
        col = {**col_e, **col_d}
        logits = linear(params, x, path='lm_head', col=col, taps=taps,
                        capture=capture, compute_dtype=cfg.cdtype)
        n = b * s + batch['embeds'].shape[0] * batch['embeds'].shape[1]
        return cross_entropy(logits, batch['labels']), \
            {'stats': col, 'n_tokens': n}

    def init_cache(self, batch_size: int, max_seq: int, device='cuda',
                   enc_len: Optional[int] = None, abstract: bool = False):
        """Zero caches; ``abstract``: meta tensors (shapes and dtypes, the
        dry run's stand-ins) whatever ``device``."""
        cfg = self.cfg
        enc_len = enc_len if enc_len is not None else max_seq * cfg.dec_ratio
        dev = torch.device('meta') if abstract else resolve_device(device)
        cdt = torch_dtype(cfg.cache_dtype)

        def kv(seq):
            shape = (self.n_dec, batch_size, seq, cfg.n_kv_heads,
                     cfg.head_dim)
            return {'k': torch.zeros(shape, dtype=cdt, device=dev),
                    'v': torch.zeros(shape, dtype=cdt, device=dev)}
        return {'dec': {'self': kv(max_seq), 'cross': kv(enc_len)}}

    @torch.no_grad()
    def prefill_fn(self, params, batch):
        """Encode, then the decoder's prefill over the prompt tokens."""
        cfg = self.cfg
        enc_out, _ = self._encode(params, batch['embeds'])
        x = embed(M.subtree(params, 'embed'), batch['tokens'], cfg.cdtype)
        b, s = x.shape[:2]
        cache = self.init_cache(b, s, device=x.device,
                                enc_len=enc_out.shape[1])
        x, col, new_cache = self._decode_stack(params, x, enc_out,
                                               cache=cache, prefill=True)
        logits = linear(params, x[:, -1:, :], path='lm_head', col=col,
                        compute_dtype=cfg.cdtype)
        return logits[:, 0], new_cache

    @torch.no_grad()
    def decode_fn(self, params, cache, tokens, pos):
        cfg = self.cfg
        x = embed(M.subtree(params, 'embed'), tokens[:, None], cfg.cdtype)
        x, col, new_cache = self._decode_stack(params, x, None, cache=cache,
                                               cache_pos=pos)
        logits = linear(params, x, path='lm_head', col=col,
                        compute_dtype=cfg.cdtype)
        return logits[:, 0], new_cache
