"""Optimizer shoot-out (paper Tables 4/7 in miniature): every optimizer in
the registry on the same LM task, equal iteration budget — the PyTorch
port's counterpart of ``examples/optimizer_comparison.py``.

    PYTHONPATH=src python examples/optimizer_comparison_torch.py \\
        [--steps 80] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import demo_lm
from repro_torch.core import make_optimizer, optimizer_names
from repro_torch.data import LMStream
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models import module as M
from repro_torch.train import init_opt_state, make_train_step

LRS = {'sgd': 0.05, 'adagrad': 0.02, 'adamw': 1e-3, 'eva': 0.05,
       'eva_f': 0.05, 'eva_s': 0.05, 'shampoo': 0.05, 'mfac': 0.05}
SKIP = {'kfac', 'foof'}  # full-tap capture targets the MLP/AE models


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=80)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = demo_lm('small')
    data = LMStream(vocab=cfg.vocab, seq_len=64, batch=16, seed=0,
                    device=args.device)
    print(f'bigram CE floor: {data.bigram_ce:.4f}\n')
    print(f'{"optimizer":10s} {"final CE":>9s} {"ms/step":>8s}')
    for name in optimizer_names():
        if name in SKIP:
            continue
        model = build_model(cfg)
        params = M.init_params(model.param_specs(),
                               torch.Generator().manual_seed(0),
                               device=device)
        kw = {'m': 8} if name == 'mfac' else {}
        opt, capture = make_optimizer(name, lr=LRS.get(name, 0.05), **kw)
        state = init_opt_state(model, opt, capture, params, data.batch_at(0),
                               device=device)
        step = make_train_step(model, opt, capture, device=device)
        params, state, m = step(params, state, data.batch_at(0))  # warm-up
        _sync(device)
        t0 = time.time()
        for i in range(1, args.steps):
            params, state, m = step(params, state, data.batch_at(i))
        _sync(device)
        dt = (time.time() - t0) / max(args.steps - 1, 1) * 1e3
        print(f'{name:10s} {float(m["loss"]):9.4f} {dt:8.1f}')


if __name__ == '__main__':
    main()
