"""Paper §5.1 / Fig. 4: the 8-layer deep autoencoder benchmark — the PyTorch
port's counterpart of ``examples/autoencoder_eva.py``.

Runs SGD / Adagrad / K-FAC / Shampoo / Eva on a synthetic MNIST-like stream
and prints the loss trajectory — the claim under test is the *relative*
ordering (Eva ≈ K-FAC, both well ahead of SGD at equal iterations).

    PYTHONPATH=src python examples/autoencoder_eva_torch.py [--steps 60] \\
        [--device cpu]
"""
import argparse

import torch

from repro_torch.core import make_optimizer
from repro_torch.data import AEStream
from repro_torch.models import ae_loss_fn, autoencoder
from repro_torch.models import module as M
from repro_torch.train import init_opt_state, make_train_step

LRS = {'sgd': 0.3, 'adagrad': 0.05, 'kfac': 0.15, 'shampoo': 0.3, 'eva': 0.15}


def train(name: str, steps: int, batch: int = 128,
          device='cuda') -> list[float]:
    model = autoencoder(hidden=(256, 64, 16, 64, 256), d_in=784)
    model.loss_fn = ae_loss_fn(model)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device=device)
    data = AEStream(batch=batch, device=device)
    opt, capture = make_optimizer(name, lr=LRS[name])
    taps_fn = (lambda p: model.make_taps(batch, capture, device=device)) \
        if capture.needs_taps else None
    state = init_opt_state(model, opt, capture, params, data.batch_at(0),
                           taps_fn=taps_fn, device=device)
    step = make_train_step(model, opt, capture, taps_fn=taps_fn, device=device)
    losses = []
    for i in range(steps):
        params, state, m = step(params, state, data.batch_at(i))
        losses.append(float(m['loss']))
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--steps', type=int, default=60)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    curves = {}
    for name in ('sgd', 'adagrad', 'kfac', 'shampoo', 'eva'):
        curves[name] = train(name, args.steps, device=args.device)
        c = curves[name]
        print(f'{name:8s} loss: {c[0]:.4f} -> {c[-1]:.4f}')
    print('\nstep ' + '  '.join(f'{n:>8s}' for n in curves))
    for i in range(0, args.steps, max(args.steps // 10, 1)):
        print(f'{i:4d} ' + '  '.join(f'{curves[n][i]:8.4f}' for n in curves))
    eva, kfac, sgd = (curves[n][-1] for n in ('eva', 'kfac', 'sgd'))
    print(f'\nEva/K-FAC final-loss ratio: {eva/kfac:.3f} (≈1 expected); '
          f'Eva/SGD: {eva/sgd:.3f} (<1 expected)')


if __name__ == '__main__':
    main()
