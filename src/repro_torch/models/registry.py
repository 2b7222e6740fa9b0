"""Model registry and per-cell input specs — PyTorch port of
``repro/models/registry.py``.

``build_model(cfg)`` maps a config family to its model class (duck-typed:
param_specs / precon_paths / loss_fn / prefill_fn / decode_fn /
init_cache).  The ``*_specs`` functions give meta-tensor stand-ins
(shape and dtype, no storage) for every model input of an (arch × shape)
cell, the reference's ShapeDtypeStructs, which the dry run lays out and
traces.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell, torch_dtype
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import JambaLM
from repro_torch.models.mamba_lm import MambaLM
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig):
    if cfg.family in ('dense', 'moe', 'vlm'):
        return TransformerLM(cfg)
    if cfg.family == 'ssm':
        return MambaLM(cfg)
    if cfg.family == 'hybrid':
        return JambaLM(cfg)
    if cfg.family == 'encdec':
        return EncDecLM(cfg)
    raise ValueError(f'unknown family {cfg.family!r}')


def _sds(shape, dtype) -> torch.Tensor:
    if not isinstance(dtype, torch.dtype):
        dtype = torch_dtype(dtype)
    return torch.empty(shape, dtype=dtype, device='meta')


def train_batch_specs(cfg: ArchConfig, shape: ShapeCell) -> dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == 'encdec':
        dec = s // cfg.dec_ratio
        return {'embeds': _sds((b, s, cfg.d_model), cfg.cdtype),
                'tokens': _sds((b, dec), torch.int32),
                'labels': _sds((b, dec), torch.int32)}
    if cfg.input_is_embeds:
        return {'embeds': _sds((b, s, cfg.d_model), cfg.cdtype),
                'labels': _sds((b, s), torch.int32)}
    return {'tokens': _sds((b, s), torch.int32),
            'labels': _sds((b, s), torch.int32)}


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeCell) -> dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == 'encdec':
        dec = s // cfg.dec_ratio
        return {'embeds': _sds((b, s, cfg.d_model), cfg.cdtype),
                'tokens': _sds((b, dec), torch.int32)}
    if cfg.input_is_embeds:
        return {'embeds': _sds((b, s, cfg.d_model), cfg.cdtype)}
    return {'tokens': _sds((b, s), torch.int32)}


def decode_specs(cfg: ArchConfig, shape: ShapeCell):
    """Returns (cache_specs, tokens_spec, pos_spec)."""
    b, s = shape.global_batch, shape.seq_len
    model = build_model(cfg)
    if cfg.family == 'encdec':
        cache = model.init_cache(b, s // cfg.dec_ratio, abstract=True,
                                 enc_len=s)
    else:
        cache = model.init_cache(b, s, abstract=True)
    return cache, _sds((b,), torch.int32), _sds((), torch.int32)
