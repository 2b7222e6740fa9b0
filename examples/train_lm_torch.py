"""End-to-end training with the PyTorch port: the full trainer stack
on a decoder-only LM — the counterpart of ``examples/train_lm.py``.

Uses the production substrate: seekable data, async checkpointing + resume,
preemption handling, straggler watchdog, any optimizer from the registry.

    PYTHONPATH=src python examples/train_lm_torch.py               # quick demo
    PYTHONPATH=src python examples/train_lm_torch.py --scale 100m \\
        --steps 300 --opt eva                                      # the ~100M run
    PYTHONPATH=src python examples/train_lm_torch.py --opt sgd --compare eva
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
"""
import argparse
import time

import torch

from repro_torch.configs import demo_lm
from repro_torch.core import make_optimizer
from repro_torch.data import LMStream
from repro_torch.models import build_model
from repro_torch.models import module as M
from repro_torch.train import Trainer, TrainerConfig


def run_one(opt_name: str, args) -> list[float]:
    cfg = demo_lm(args.scale)
    model = build_model(cfg)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(args.seed),
                           device=args.device)
    n = M.count_params(model.param_specs())
    data = LMStream(vocab=cfg.vocab, seq_len=args.seq_len, batch=args.batch,
                    seed=args.seed, device=args.device)
    opt, capture = make_optimizer(opt_name, lr=args.lr)
    tc = TrainerConfig(total_steps=args.steps, log_every=args.log_every,
                       ckpt_every=args.ckpt_every,
                       out_dir=f'{args.out_dir}/{cfg.name}-{opt_name}')
    print(f'== {cfg.name} ({n/1e6:.1f}M params) × {opt_name} '
          f'(bigram CE floor {data.bigram_ce:.3f}) ==')
    t0 = time.time()
    _, _, history = Trainer(model, opt, capture, tc,
                            device=args.device).fit(params, data)
    print(f'   {len(history)} steps in {time.time()-t0:.1f}s; '
          f'loss {history[0]:.4f} -> {history[-1]:.4f}')
    return history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--scale', default='small', choices=['small', 'base', '100m'])
    ap.add_argument('--opt', default='eva')
    ap.add_argument('--compare', default=None,
                    help='also train with this optimizer and report both')
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--seq-len', type=int, default=64)
    ap.add_argument('--lr', type=float, default=0.05)
    ap.add_argument('--log-every', type=int, default=20)
    ap.add_argument('--ckpt-every', type=int, default=50)
    ap.add_argument('--out-dir', default='runs')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()

    h1 = run_one(args.opt, args)
    if args.compare:
        h2 = run_one(args.compare, args)
        n = min(len(h1), len(h2))
        print(f'\nfinal loss: {args.opt}={h1[n-1]:.4f} '
              f'{args.compare}={h2[n-1]:.4f}')


if __name__ == '__main__':
    main()
