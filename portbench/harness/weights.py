"""Inputs drawn from the run's seed, the same for the program and the
reference: each weight leaf from a generator of its own (so that any leaf
can be drawn again alone), in the dtype it is stored in, on the device; and
the traffic's token batches, one draw of every batch's rows.

The seed may be any whole number (the driver's exceed 32 bits); each
stream's generator seed is a 63-bit hash of the seed and the stream's name.
"""
from __future__ import annotations

import hashlib
import math

import torch


def stream_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f'{int(seed)}/{name}'.encode()).digest()
    return int.from_bytes(digest[:8], 'little') & (2 ** 63 - 1)


def _generator(seed: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    return gen.manual_seed(stream_seed(seed, name))


def draw_leaf(spec: tuple, seed: int, path: str, device) -> torch.Tensor:
    """One leaf of ``(shape, dtype name, init, arg)``:

    * 'normal': N(0, arg²);
    * 'uniform': U(−arg, arg);
    * 'log_uniform': the log of U(arg[0], arg[1]) (Mamba's A_log);
    * 'inv_softplus': softplus⁻¹(dt), dt = exp(U(log arg[0], log arg[1]))
      at least 1e-4 (Mamba's dt_bias);
    * 'ones', 'zeros'.
    """
    shape, dtype, init, arg = spec
    dtype = getattr(torch, dtype)
    if init == 'zeros':
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == 'ones':
        return torch.ones(shape, dtype=dtype, device=device)
    gen = _generator(seed, f'weights/{path}', device)
    if init == 'normal':
        out = torch.randn(shape, dtype=dtype, device=device, generator=gen)
        return out.mul_(arg)
    if init == 'uniform':
        out = torch.rand(shape, dtype=dtype, device=device, generator=gen)
        return out.mul_(2 * arg).sub_(arg)
    u = torch.rand(shape, dtype=torch.float32, device=device, generator=gen)
    lo, hi = arg
    if init == 'log_uniform':
        return torch.log(lo + (hi - lo) * u).to(dtype)
    if init == 'inv_softplus':
        dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
        dt = torch.clamp(dt, min=1e-4)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    raise ValueError(f'unknown init {init!r}')


def make_weights(specs: dict, seed: int, device) -> dict:
    """{path: leaf} in sorted path order."""
    return {p: draw_leaf(specs[p], seed, p, device) for p in sorted(specs)}


def token_batches(traffic: dict, vocab: int, seed: int, device) -> list:
    """``traffic['batches']`` batches of ``batch`` rows of ``seq`` tokens:
    uniform token ids, each row's labels its tokens shifted by one."""
    n, b, s = traffic['batches'], traffic['batch'], traffic['seq']
    ids = torch.randint(0, vocab, (n, b, s + 1), device=device,
                        generator=_generator(seed, 'tokens', device))
    return [{'tokens': ids[i, :, :-1].to(torch.int32),
             'labels': ids[i, :, 1:].to(torch.int32)} for i in range(n)]
