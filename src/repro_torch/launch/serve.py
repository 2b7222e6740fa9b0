"""Serving launcher: batched prefill and decode for any registry arch —
PyTorch port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on the card unless ``--device cpu`` is given.  Weights and prompts are
random, drawn on the device from seeds 0 and 1.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced
from repro_torch.core import kv
from repro_torch.device import resolve_device
from repro_torch.models import module as M
from repro_torch.models.registry import build_model


def grow_cache(model, cache, batch: int, total: int, device='cuda', **kw):
    """A cache of ``total`` positions holding ``cache`` at its start, for a
    decode past the prefill's length; every leaf is copied (an SSM's state
    and conv buffer have no length: they are copied whole).  ``kw`` goes
    to ``model.init_cache`` (an encoder-decoder's ``enc_len``)."""
    grown = model.init_cache(batch, total, device=device, **kw)
    flat = kv.flatten_params(grown)
    for k, part in kv.flatten_params(cache).items():
        flat[k][tuple(slice(0, n) for n in part.shape)] = part
    return grown


def serve(arch: str, *, reduced: bool = False, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, device='cuda'):
    """Prefill a random prompt, then decode greedily: (generated tokens
    (batch, n), seconds).  As in the reference, the cache keeps its
    prefill size and each decode step writes at ``min(plen + i, plen -
    1)``, the last position."""
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    model = build_model(cfg)
    params = M.init_params(model.param_specs(),
                           torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    gen1 = torch.Generator(device=dev).manual_seed(1)
    b, s = batch, prompt_len
    inputs = {}
    if cfg.family == 'encdec':
        inputs['embeds'] = torch.randn((b, s, cfg.d_model), generator=gen1,
                                       device=dev).to(cfg.cdtype)
        inputs['tokens'] = torch.randint(
            0, cfg.vocab, (b, max(s // cfg.dec_ratio, 4)), generator=gen1,
            device=dev)
        plen = inputs['tokens'].shape[1]
    elif cfg.input_is_embeds:
        inputs['embeds'] = torch.randn((b, s, cfg.d_model), generator=gen1,
                                       device=dev).to(cfg.cdtype)
        plen = s
    else:
        inputs['tokens'] = torch.randint(0, cfg.vocab, (b, s), generator=gen1,
                                         device=dev)
        plen = s

    t0 = time.perf_counter()
    logits, cache = model.prefill_fn(params, inputs)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    for i in range(min(gen, plen) - 1):
        logits, cache = model.decode_fn(params, cache, tok,
                                        min(plen + i, plen - 1))
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    tokens = torch.stack(out, 1).cpu()
    return cfg, tokens, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', required=True, choices=list(ARCH_IDS))
    ap.add_argument('--reduced', action='store_true')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--gen', type=int, default=16)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    cfg, tokens, secs = serve(args.arch, reduced=args.reduced,
                              batch=args.batch, prompt_len=args.prompt_len,
                              gen=args.gen, device=args.device)
    print(f'{cfg.name}: {tokens.shape[0]}×{tokens.shape[1]} tokens in '
          f'{secs:.2f}s')
    print('first row:', tokens[0, :12].tolist())


if __name__ == '__main__':
    main()
