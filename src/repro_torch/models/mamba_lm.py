"""Mamba-2 LM (a pure SSM stack, the ``ssm`` family, attention-free) —
PyTorch port of ``repro/models/mamba_lm.py``.  The layer loop, the remat
per block and the stacked stats are ``models/transformer.py``'s."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.core import kv as kvlib
from repro_torch.device import resolve_device
from repro_torch.models import module as M
from repro_torch.models.layers import (embed, embed_spec, linear, linear_spec,
                                       make_norm)
from repro_torch.models.ssm import mamba_block, mamba_spec, ssm_dims
from repro_torch.models.transformer import (_stack_stats, _unstack,
                                            cross_entropy, remat_call)
from repro_torch.sharding.constraints import shard_activations


def stack_caches(caches: list[dict]) -> dict:
    """Per-layer caches (nested dicts of tensors) -> one cache with each
    leaf stacked over the layers."""
    flat = [kvlib.flatten_params(c) for c in caches]
    return kvlib.unflatten_params({k: torch.stack([c[k] for c in flat])
                                   for k in flat[0]})


def unstack_cache(cache: dict, n: int) -> list[dict]:
    """The inverse of :func:`stack_caches`: ``n`` per-layer caches."""
    return [kvlib.unflatten_params(c)
            for c in _unstack(kvlib.flatten_params(cache), n)]


class MambaLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.remat not in ('none', 'full', 'dots'):
            raise ValueError(f'remat {cfg.remat!r}; have none, full, dots')
        self.cfg = cfg

    def block_spec(self) -> dict:
        cfg = self.cfg
        norm_spec, _ = make_norm(cfg.norm)
        return {
            'norm': norm_spec(cfg.d_model, cfg.pdtype),
            'mixer': mamba_spec(cfg.d_model, expand=cfg.ssm_expand,
                                headdim=cfg.ssm_headdim,
                                d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
                                dtype=cfg.pdtype),
        }

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
        paths = {'blocks/mixer/in_proj/w', 'blocks/mixer/out_proj/w'}
        if not self.cfg.tie_embeddings:
            paths.add('lm_head/w')
        return paths

    def _block(self, p, h, *, col, taps, capture, cache=None,
               return_cache=False):
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        out, new_cache = mamba_block(
            p, norm(M.subtree(p, 'norm'), h), headdim=cfg.ssm_headdim,
            d_state=cfg.ssm_state, d_conv=cfg.ssm_conv, chunk=cfg.ssm_chunk,
            cache=cache, return_cache=return_cache, path='mixer', col=col,
            taps=taps, capture=capture, compute_dtype=cfg.cdtype)
        return h + out, new_cache

    def _forward(self, params, x, *, taps=None, capture=None, cache=None,
                 return_cache: bool = False):
        n = self.cfg.n_layers
        layers = _unstack(M.subtree(params, 'blocks'), n)
        layer_taps = _unstack(M.subtree(taps, 'blocks'), n)
        layer_caches = _unstack((cache or {}).get('blocks'), n)
        remat = (self.cfg.remat != 'none' and cache is None
                 and torch.is_grad_enabled())
        cols, new_caches = [], []
        for p, bt, bc in zip(layers, layer_taps, layer_caches):
            x = shard_activations(x)
            bcol: dict = {}
            if remat:
                def run(h, sink, p=p, bt=bt):
                    return self._block(p, h, col=sink, taps=bt,
                                       capture=capture)[0]
                x = remat_call(self.cfg.remat, run, x, bcol)
            else:
                x, bc = self._block(p, x, col=bcol, taps=bt, capture=capture,
                                    cache=bc, return_cache=return_cache)
            cols.append(bcol)
            new_caches.append(bc)
        new_cache = None
        if cache is not None or return_cache:
            new_cache = {'blocks': stack_caches(new_caches)}
        return x, M.add_prefix(_stack_stats(cols), 'blocks'), new_cache

    def _logits(self, params, x, col, taps, capture):
        cfg = self.cfg
        _, norm = make_norm(cfg.norm)
        x = norm(M.subtree(params, 'norm_f'), x)
        if cfg.tie_embeddings:
            table = params['embed/table']
            return x.to(cfg.cdtype) @ table.T.to(cfg.cdtype)
        return linear(params, x, path='lm_head', col=col, taps=taps,
                      capture=capture, compute_dtype=cfg.cdtype)

    def loss_fn(self, params, taps, batch,
                capture: Optional[kvlib.CaptureConfig]):
        x = embed(M.subtree(params, 'embed'), batch['tokens'],
                  self.cfg.cdtype)
        b, s = x.shape[:2]
        x, col, _ = self._forward(params, x, taps=taps, capture=capture)
        logits = self._logits(params, x, col, taps, capture)
        return cross_entropy(logits, batch['labels']), \
            {'stats': col, 'n_tokens': b * s}

    def init_cache(self, batch_size: int, max_seq: int, device='cuda',
                   abstract: bool = False):
        """Zero caches, O(1) in context length (``max_seq`` is not used);
        ``abstract``: meta tensors (the dry run's stand-ins) whatever
        ``device``."""
        cfg = self.cfg
        _, nheads, conv_ch = ssm_dims(cfg.d_model, cfg.ssm_expand,
                                      cfg.ssm_headdim, cfg.ssm_state,
                                      cfg.ssm_conv)
        dev = torch.device('meta') if abstract else resolve_device(device)
        n, b = cfg.n_layers, batch_size
        return {'blocks': {
            'conv': torch.zeros((n, b, cfg.ssm_conv - 1, conv_ch),
                                dtype=torch_dtype(cfg.cache_dtype),
                                device=dev),
            'ssm': torch.zeros((n, b, nheads, cfg.ssm_state,
                                cfg.ssm_headdim), dtype=torch.float32,
                               device=dev)}}

    @torch.no_grad()
    def prefill_fn(self, params, batch):
        """Chunked-SSD prefill; the decode cache is each layer's final
        state and conv tail."""
        x = embed(M.subtree(params, 'embed'), batch['tokens'],
                  self.cfg.cdtype)
        x, col, cache = self._forward(params, x, return_cache=True)
        logits = self._logits(params, x[:, -1:, :], col, None, None)
        return logits[:, 0], cache

    @torch.no_grad()
    def decode_fn(self, params, cache, tokens, pos):
        del pos  # state-space decode is position-free
        x = embed(M.subtree(params, 'embed'), tokens[:, None],
                  self.cfg.cdtype)
        x, col, new_cache = self._forward(params, x, cache=cache)
        logits = self._logits(params, x, col, None, None)
        return logits[:, 0], new_cache
