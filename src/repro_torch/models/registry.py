"""Model registry — PyTorch port of ``build_model`` in
``repro/models/registry.py``: config family -> model class."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: ArchConfig):
    if cfg.family in ('dense', 'vlm'):
        return TransformerLM(cfg)
    if cfg.family in ('moe', 'ssm', 'hybrid', 'encdec'):
        raise NotImplementedError(
            f'family {cfg.family!r} is not ported yet: it waits in '
            'ROADMAP.md §1 item 11')
    raise ValueError(f'unknown family {cfg.family!r}')
