"""The control of ``correct``: the reference computed in float8, the
nearest precision below the configurations' bfloat16, as fp8 training
computes: every value the configuration holds in its compute dtype (each
matmul's operands and output, the residual stream, each norm's output and
activation; see ``common.Tape.r``) is rounded to e4m3 in the forward pass,
and the gradient flowing back through each such value to e5m2, both with
one scale a tensor (its largest magnitude mapped to the format's largest).
What the port keeps in float32 (softmax, the scan, the loss, the
optimizer) stays float32."""
from __future__ import annotations

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _round(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax(), min=1e-30) / torch.finfo(fmt).max
    return (x / scale).to(fmt).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return _round(x.detach(), E4M3)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, E5M2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _RoundFp8.apply(x)
