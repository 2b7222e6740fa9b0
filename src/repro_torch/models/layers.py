"""Building-block layers — PyTorch port of ``repro/models/layers.py``:
capture-aware linear, norms, embedding, RoPE and the MLPs.

``linear`` computes ``y = x @ w + b + tap`` with w in the reference's
(d_in, d_out) layout (not ``nn.Linear``'s).  With capture on, it records the
statistics of its input (``kv.fwd_stats``) under the weight's path and adds
the zero tap whose gradient is b̄.  ``linear``, ``mlp`` and ``gelu_mlp`` read
their weights from a flat ``{path: tensor}`` dict under ``path``; the norms
and ``embed`` take their own entries (``{'scale': ...}``, ``{'table': ...}``),
as the reference's do.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import kv as kvlib
from repro_torch.models.module import ParamSpec
from repro_torch.obs import spans as obs_spans

F32 = torch.float32


# ---------------------------------------------------------------------------
# Linear


def linear_spec(d_in: int, d_out: int, bias: bool = False,
                dtype=torch.float32,
                axes: tuple[Optional[str], Optional[str]] = (None, None),
                bias_axis: Optional[str] = None) -> dict:
    spec = {'w': ParamSpec((d_in, d_out), dtype, init='scaled', axes=axes)}
    if bias:
        spec['b'] = ParamSpec((d_out,), dtype, init='zeros',
                              axes=(bias_axis if bias_axis is not None
                                    else axes[1],))
    return spec


def linear(params: dict, x: torch.Tensor, *, path: str, col: dict,
           taps: Optional[dict] = None,
           capture: Optional[kvlib.CaptureConfig] = None,
           compute_dtype=None) -> torch.Tensor:
    """y = x @ w (+ b) (+ tap).  ``params`` is a flat dict holding
    ``f'{path}/w'``; x: (..., d_in)."""
    wpath = f'{path}/w'
    w = params[wpath]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if capture is not None and capture.a is not None:
        with obs_spans.span('capture'):
            col[wpath] = kvlib.fwd_stats(x, capture)
    y = x @ w
    bias = params.get(f'{path}/b')
    if bias is not None:
        y = y + bias.to(y.dtype)
    if taps is not None and wpath in taps:
        y = y + taps[wpath].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms


def rmsnorm_spec(d: int, dtype=torch.float32) -> dict:
    return {'scale': ParamSpec((d,), dtype, init='ones', axes=('embed',))}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p['scale'].to(F32)).to(x.dtype)


def layernorm_spec(d: int, dtype=torch.float32) -> dict:
    return {'scale': ParamSpec((d,), dtype, init='ones', axes=('embed',)),
            'bias': ParamSpec((d,), dtype, init='zeros', axes=('embed',))}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(F32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p['scale'].to(F32) + p['bias'].to(F32)).to(x.dtype)


def make_norm(kind: str):
    if kind == 'rms':
        return rmsnorm_spec, rmsnorm
    if kind == 'layer':
        return layernorm_spec, layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Embedding


def embed_spec(vocab: int, d: int, dtype=torch.float32) -> dict:
    return {'table': ParamSpec((vocab, d), dtype, init='normal', scale=0.02,
                               axes=('vocab', 'embed'))}


def embed(p: dict, ids: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Rows of ``p['table']`` at ``ids``; the backward sums the rows of
    repeated ids."""
    t = p['table']
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return F.embedding(ids, t)


# ---------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (Dh/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(F32) * freqs                 # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=F32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=F32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq, d), dtype=F32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU), the dense FFN of the LMs, and the 2-layer GELU MLP


def mlp_spec(d: int, d_ff: int, dtype=torch.float32,
             bias: bool = False) -> dict:
    return {
        'gate': linear_spec(d, d_ff, bias, dtype, ('embed', 'mlp')),
        'up': linear_spec(d, d_ff, bias, dtype, ('embed', 'mlp')),
        'down': linear_spec(d_ff, d, bias, dtype, ('mlp', 'embed')),
    }


def mlp(p: dict, x: torch.Tensor, *, path: str, col: dict, taps=None,
        capture=None, compute_dtype=None) -> torch.Tensor:
    kw = dict(col=col, taps=taps, capture=capture, compute_dtype=compute_dtype)
    g = linear(p, x, path=f'{path}/gate', **kw)
    u = linear(p, x, path=f'{path}/up', **kw)
    return linear(p, F.silu(g) * u, path=f'{path}/down', **kw)


def gelu_mlp_spec(d: int, d_ff: int, dtype=torch.float32,
                  bias: bool = True) -> dict:
    """Whisper-style 2-layer GELU MLP."""
    return {
        'fc1': linear_spec(d, d_ff, bias, dtype, ('embed', 'mlp')),
        'fc2': linear_spec(d_ff, d, bias, dtype, ('mlp', 'embed')),
    }


def gelu_mlp(p: dict, x: torch.Tensor, *, path: str, col: dict, taps=None,
             capture=None, compute_dtype=None) -> torch.Tensor:
    """GELU in its tanh form, the reference's ``jax.nn.gelu`` default."""
    kw = dict(col=col, taps=taps, capture=capture, compute_dtype=compute_dtype)
    h = F.gelu(linear(p, x, path=f'{path}/fc1', **kw), approximate='tanh')
    return linear(p, h, path=f'{path}/fc2', **kw)
