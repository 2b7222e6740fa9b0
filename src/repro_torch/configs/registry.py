"""Arch-config registry — PyTorch port of ``repro/configs/registry.py``:
``get_config('<id>')`` / ``get_reduced('<id>')`` for the ten assigned
architectures (one module each beside this one, holding ``CONFIG`` and
``REDUCED``), and the demo configs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    'whisper-tiny': 'repro_torch.configs.whisper_tiny',
    'qwen3-moe-30b-a3b': 'repro_torch.configs.qwen3_moe_30b_a3b',
    'kimi-k2-1t-a32b': 'repro_torch.configs.kimi_k2_1t_a32b',
    'mamba2-780m': 'repro_torch.configs.mamba2_780m',
    'qwen2-0.5b': 'repro_torch.configs.qwen2_0_5b',
    'codeqwen1.5-7b': 'repro_torch.configs.codeqwen1_5_7b',
    'glm4-9b': 'repro_torch.configs.glm4_9b',
    'command-r-35b': 'repro_torch.configs.command_r_35b',
    'llava-next-34b': 'repro_torch.configs.llava_next_34b',
    'jamba-v0.1-52b': 'repro_torch.configs.jamba_v0_1_52b',
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f'unknown arch {arch_id!r}; have {sorted(_MODULES)}')
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return _module(arch_id).REDUCED



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
