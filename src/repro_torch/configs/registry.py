"""Demo configs — PyTorch port of ``demo_lm`` in
``repro/configs/registry.py``.  The ten assigned architectures
(``get_config`` / ``get_reduced``) are not ported yet."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig


def demo_lm(scale: str = 'small') -> ArchConfig:
    """Decoder-only demo LM.  'small' ~1.5M params trains in seconds on CPU;
    'base' ~10M; '100m' ~100M params (the end-to-end driver config)."""
    if scale == 'small':
        return ArchConfig(name='demo-small', family='dense', n_layers=2,
                          d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                          vocab=512)
    if scale == 'base':
        return ArchConfig(name='demo-base', family='dense', n_layers=4,
                          d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                          vocab=2048)
    if scale == '100m':
        return ArchConfig(name='demo-100m', family='dense', n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                          vocab=32768, remat='dots')
    raise KeyError(scale)
