"""Model registry — PyTorch port of ``build_model`` in
``repro/models/registry.py``: config family -> model class (duck-typed:
param_specs / precon_paths / loss_fn / prefill_fn / decode_fn /
init_cache).  The reference's ``*_specs`` input stand-ins feed its dry run,
which is not ported."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
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
