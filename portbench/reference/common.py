"""Pieces the reference models share: norms, RoPE, the capture-aware linear,
the loss, and one forward and backward pass with Eva's statistics."""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
from torch.utils import checkpoint

F32 = torch.float32


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matmuls and convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, Dh) at positions 0..S-1, the halves
    of the head rotated against each other."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=F32, device=x.device)
                           / dh))
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :,
                                                                None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Tape:
    """What one layer's forward records: ``a[path]`` the mean of each
    preconditioned linear's input and ``count[path]`` the number of tokens
    behind a per-expert mean.  ``taps`` are that layer's zero taps.

    ``r`` rounds a value held in the configuration's compute dtype (a
    matmul's operands and output, the residual stream, a norm's output, an
    activation), and the gradient flowing back through it, with ``quant``:
    the identity for the reference itself, the control's lower precision
    otherwise (``lowp.py``)."""

    def __init__(self, taps: Optional[dict], quant: Optional[Callable]):
        self.taps = taps
        self.quant = quant
        self.a: dict = {}
        self.count: dict = {}

    def tap(self, path):
        return None if self.taps is None else self.taps.get(path)

    def r(self, x):
        return x if self.quant is None else self.quant(x)


def linear(x: torch.Tensor, w: torch.Tensor, path: str,
           tape: Tape) -> torch.Tensor:
    """x @ w (+ the zero tap of ``path``), recording the mean of x."""
    x = tape.r(x)
    if path not in tape.a:
        tape.a[path] = x.detach().reshape(-1, x.shape[-1]).mean(0)
    y = tape.r(x @ tape.r(w))
    tap = tape.tap(path)
    return y if tap is None else y + tap


def expert_linear(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                  path: str, tape: Tape) -> torch.Tensor:
    """x (E, C, d_in) @ w (E, d_in, d_out) expert by expert, with the mean
    of each expert's input over its valid slots (mask (E, C))."""
    x = tape.r(x)
    if path not in tape.a:
        cnt = mask.sum(1)
        tape.a[path] = (mask[..., None] * x.detach()).sum(1) / \
            torch.clamp(cnt, min=1.0)[:, None]
        tape.count[path] = cnt
    y = tape.r(torch.bmm(x, tape.r(w)))
    tap = tape.tap(path)
    return y if tap is None else y + tap[:, None, :]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean()


def run_layers(block: Callable, x: torch.Tensor, n_layers: int,
               params: dict, taps: Optional[dict], quant) -> tuple:
    """``block(layer_params, tape, x) -> (x, aux)`` over the layer stack,
    each layer under a checkpoint; the layer's leaves are the ``l``-th rows
    of the ``'blocks/...'`` leaves.  Returns (x, summed aux, tapes)."""
    tapes, aux_sum = [], torch.zeros((), dtype=F32, device=x.device)
    for layer in range(n_layers):
        p = {k[len('blocks/'):]: v[layer] for k, v in params.items()
             if k.startswith('blocks/')}
        t = None if taps is None else {k[len('blocks/'):]: v[layer]
                                       for k, v in taps.items()
                                       if k.startswith('blocks/')}
        tape = Tape(t, quant)
        tapes.append(tape)

        def body(h, p=p, tape=tape):
            return block(p, tape, h)
        if torch.is_grad_enabled():
            x, aux = checkpoint.checkpoint(body, x, use_reentrant=False)
        else:
            x, aux = body(x)
        aux_sum = aux_sum + aux
    return x, aux_sum, tapes


def stack_tapes(tapes: list) -> tuple[dict, dict]:
    """Per-layer tapes -> ({path: a stacked over layers}, {path: count
    stacked over layers}) under the leaves' own paths."""
    a = {f'blocks/{k}': torch.stack([t.a[k] for t in tapes])
         for k in tapes[0].a}
    count = {f'blocks/{k}': torch.stack([t.count[k] for t in tapes])
             for k in tapes[0].count}
    return a, count


def tap_shapes(specs: dict, precon: list) -> dict:
    """Each preconditioned weight (lead..., d_in, d_out) gets a tap
    (lead..., d_out)."""
    return {p: tuple(specs[p][0][:-2]) + (specs[p][0][-1],) for p in precon}


def grads_and_stats(model, cfg: dict, params: dict, batch: dict,
                    capture: bool, quant=None):
    """One forward and backward: (loss, grads, ā, b̄), all float32.

    b̄ is the gradient of the mean loss with respect to each zero tap: the
    sum over tokens of the loss's gradient at the layer's output.  Where the
    tokens behind a mean are counted per expert, b̄ is scaled by
    tokens / max(count, 1), as ā is a mean over that expert's slots."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    taps = None
    if capture:
        dev = next(iter(params.values())).device
        taps = {p: torch.zeros(s, dtype=F32, device=dev, requires_grad=True)
                for p, s in tap_shapes(model.param_specs(cfg),
                                       model.precon_paths(cfg)).items()}
    loss, a, count, n_tokens = model.loss(cfg, leaves, batch, taps, quant)
    inputs = list(leaves.values()) + (list(taps.values()) if taps else [])
    got = torch.autograd.grad(loss, inputs, allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g
           for x, g in zip(inputs, got)]
    grads = dict(zip(leaves, got[:len(leaves)]))
    b = None
    if capture:
        b = {}
        for p, g in zip(taps, got[len(leaves):]):
            c = count.get(p)
            b[p] = g if c is None else \
                g * (n_tokens / torch.clamp(c, min=1.0))[..., None]
    return loss.detach(), grads, a, b


def capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    """Slots an expert: ceil(T·k·cf / E), at least 8, up to a multiple of
    8."""
    c = int(math.ceil(n_tokens * top_k * factor / n_experts))
    return max(8, -(-c // 8) * 8)


