"""Capture-aware linear layer — PyTorch port of ``linear_spec`` and
``linear`` in ``repro/models/layers.py``.

``y = x @ w + b + tap`` with w in the reference's (d_in, d_out) layout (not
``nn.Linear``'s).  With capture on, the layer records the mean of its input
(``kv.fwd_stats``) and adds the zero tap whose gradient is b̄.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import kv as kvlib
from repro_torch.models.module import ParamSpec


def linear_spec(d_in: int, d_out: int, bias: bool = False) -> dict:
    spec = {'w': ParamSpec((d_in, d_out), init='scaled')}
    if bias:
        spec['b'] = ParamSpec((d_out,), init='zeros')
    return spec


def linear(params: dict, x: torch.Tensor, *, path: str, col: dict,
           taps: Optional[dict] = None,
           capture: Optional[kvlib.CaptureConfig] = None) -> torch.Tensor:
    """y = x @ w (+ b) (+ tap).  ``params`` is the flat model dict."""
    wpath = f'{path}/w'
    if capture is not None and capture.a is not None:
        col[wpath] = kvlib.fwd_stats(x, capture)
    y = x @ params[wpath]
    bias = params.get(f'{path}/b')
    if bias is not None:
        y = y + bias.to(y.dtype)
    if taps is not None and wpath in taps:
        y = y + taps[wpath].to(y.dtype)
    return y
