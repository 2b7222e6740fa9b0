"""Quickstart: train a small transformer LM with Eva in ~30 lines — the
PyTorch port's counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import demo_lm
from repro_torch.core import make_optimizer
from repro_torch.data import LMStream
from repro_torch.models import build_model
from repro_torch.models import module as M
from repro_torch.train import init_opt_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()

    cfg = demo_lm('small')
    model = build_model(cfg)
    params = M.init_params(model.param_specs(), torch.Generator().manual_seed(0),
                           device=args.device)
    data = LMStream(vocab=cfg.vocab, seq_len=64, batch=16, seed=0,
                    device=args.device)

    # the paper's optimizer: rank-one KV curvature + Sherman-Morrison (Eq. 13)
    opt, capture = make_optimizer('eva', lr=0.05, gamma=0.03, kl_kappa=1e-3)

    opt_state = init_opt_state(model, opt, capture, params, data.batch_at(0),
                               device=args.device)
    step = make_train_step(model, opt, capture, device=args.device)

    print(f'params: {M.count_params(model.param_specs()):,}   '
          f'bigram CE floor: {data.bigram_ce:.3f}')
    for i in range(100):
        params, opt_state, metrics = step(params, opt_state, data.batch_at(i))
        if i % 10 == 0:
            print(f'step {i:3d}  loss {float(metrics["loss"]):.4f}')
    print('done — Eva trains like SGD-with-momentum, at second-order quality.')


if __name__ == '__main__':
    main()
