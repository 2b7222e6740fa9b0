"""Optimizer registry: name -> (factory, CaptureConfig) — PyTorch port.

``make_optimizer('eva', lr=0.15)`` is the entry point, as in
``repro/core/registry.py``, with the reference's ten names and captures.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core import kv as kvlib
from repro_torch.core.eva import CAPTURE as _EVA_CAP
from repro_torch.core.eva import eva as _eva_fn
from repro_torch.core.eva_f import CAPTURE as _EVA_F_CAP
from repro_torch.core.eva_f import eva_f as _eva_f_fn
from repro_torch.core.eva_s import CAPTURE as _EVA_S_CAP
from repro_torch.core.eva_s import eva_s as _eva_s_fn
from repro_torch.core.firstorder import adagrad as _adagrad_fn
from repro_torch.core.firstorder import adamw as _adamw_fn
from repro_torch.core.firstorder import sgd as _sgd_fn
from repro_torch.core.foof import CAPTURE as _FOOF_CAP
from repro_torch.core.foof import foof as _foof_fn
from repro_torch.core.kfac import CAPTURE as _KFAC_CAP
from repro_torch.core.kfac import kfac as _kfac_fn
from repro_torch.core.mfac import mfac as _mfac_fn
from repro_torch.core.shampoo import shampoo as _shampoo_fn
from repro_torch.core.transform import GradientTransformation

_REGISTRY: dict[str, tuple[Any, kvlib.CaptureConfig]] = {
    'eva': (_eva_fn, _EVA_CAP),
    'eva_f': (_eva_f_fn, _EVA_F_CAP),
    'eva_s': (_eva_s_fn, _EVA_S_CAP),
    'kfac': (_kfac_fn, _KFAC_CAP),
    'foof': (_foof_fn, _FOOF_CAP),
    'shampoo': (_shampoo_fn, kvlib.NO_CAPTURE),
    'mfac': (_mfac_fn, kvlib.NO_CAPTURE),
    'sgd': (_sgd_fn, kvlib.NO_CAPTURE),
    'adagrad': (_adagrad_fn, kvlib.NO_CAPTURE),
    'adamw': (_adamw_fn, kvlib.NO_CAPTURE),
}


def optimizer_names() -> list[str]:
    return sorted(_REGISTRY)


def capture_for(name: str) -> kvlib.CaptureConfig:
    return _REGISTRY[name][1]


def make_optimizer(name: str, **kwargs
                   ) -> tuple[GradientTransformation, kvlib.CaptureConfig]:
    if name not in _REGISTRY:
        raise KeyError(f'unknown optimizer {name!r}; have {optimizer_names()}')
    factory, capture = _REGISTRY[name]
    return factory(**kwargs), capture
