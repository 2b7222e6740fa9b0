"""Batched serving demo: prefill + greedy decode loop over the KV cache —
the PyTorch port's counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/serve_lm_torch.py [--tokens 32] \\
        [--batch 4] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import demo_lm
from repro_torch.data import LMStream
from repro_torch.launch.serve import grow_cache
from repro_torch.models import build_model
from repro_torch.models import module as M


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--tokens', type=int, default=32)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()

    cfg = demo_lm('small')
    model = build_model(cfg)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0),
                           device=args.device)
    prompts = LMStream(vocab=cfg.vocab, seq_len=args.prompt_len,
                       batch=args.batch, seed=7,
                       device=args.device).batch_at(0)['tokens']

    # serving caches must outlive the prompt: grow to prompt+gen
    total = args.prompt_len + args.tokens

    t0 = time.time()
    logits, cache = model.prefill_fn(params, {'tokens': prompts})
    cache = grow_cache(model, cache, args.batch, total, device=args.device)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    for i in range(args.tokens - 1):
        logits, cache = model.decode_fn(params, cache, tok,
                                        args.prompt_len + i)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    gen = torch.stack(out, dim=1).cpu()     # waits for the card
    dt = time.time() - t0
    print(f'generated {args.batch}×{args.tokens} tokens in {dt:.2f}s '
          f'({args.batch * args.tokens / dt:.1f} tok/s)')
    for b in range(args.batch):
        print(f'  seq {b}: {gen[b][:16].tolist()} ...')


if __name__ == '__main__':
    main()
