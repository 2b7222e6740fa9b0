"""The five ``examples/*_torch.py`` on the CPU.

Each runs as a script with ``--device cpu`` at a few steps, exits 0 and
prints its reference's lines.  ``autoencoder_eva_torch.train`` (all five
optimizers) and ``train_lm_torch.run_one`` (Eva, and SGD as ``--compare``
would run it), started from the reference's ``init_params(PRNGKey(0))``
(handed over by replacing the port's ``init_params`` in this test only),
give every step's loss within rtol 1e-4 of the reference example's own
functions.
"""
import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import demo_lm as jdemo_lm  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models.simple import autoencoder as jautoencoder  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / 'examples'
RTOL = 1e-4

SCRIPTS = {
    'quickstart_torch.py': ([], ['bigram CE floor', 'step  90  loss',
                                 'done — Eva trains']),
    'train_lm_torch.py': (['--steps', '4', '--log-every', '1', '--compare',
                           'sgd'],
                          ['== demo-small (0.4M params) × eva',
                           '4 steps in', 'final loss: eva=']),
    'autoencoder_eva_torch.py': (['--steps', '3'],
                                 ['eva      loss:', 'step      sgd',
                                  'Eva/K-FAC final-loss ratio']),
    'optimizer_comparison_torch.py': (['--steps', '3'],
                                      ['optimizer   final CE  ms/step',
                                       'shampoo', 'mfac']),
    'serve_lm_torch.py': (['--tokens', '8'],
                          ['generated 4×8 tokens in', '  seq 3: [']),
}


@pytest.mark.parametrize('script', list(SCRIPTS))
def test_example_runs_on_the_cpu(script, tmp_path):
    flags, lines = SCRIPTS[script]
    if script == 'train_lm_torch.py':
        flags = flags + ['--out-dir', str(tmp_path)]
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / script), '--device', 'cpu', *flags],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={'PYTHONPATH': str(ROOT / 'src'), 'OMP_NUM_THREADS': '2'})
    assert out.returncode == 0, out.stderr[-2000:]
    for line in lines:
        assert line in out.stdout, (line, out.stdout[-2000:])


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name.replace('.py', ''), EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inject(monkeypatch, ref_params):
    """The port's ``init_params`` hands out the reference's weights."""
    def init_params(specs, generator, device='cuda'):
        del specs, generator
        return M.params_from_numpy(ref_params, device)
    monkeypatch.setattr(M, 'init_params', init_params)


AE_STEPS = 3


@pytest.fixture(scope='module')
def ae_reference():
    mod = _load('autoencoder_eva.py')
    return {name: mod.train(name, AE_STEPS) for name in mod.LRS}


@pytest.mark.parametrize('name', ['sgd', 'adagrad', 'kfac', 'shampoo', 'eva'])
def test_autoencoder_train_tracks_reference(name, ae_reference, monkeypatch):
    ex = _load('autoencoder_eva_torch.py')
    _inject(monkeypatch, JM.init_params(
        jautoencoder(hidden=(256, 64, 16, 64, 256), d_in=784).param_specs(),
        jax.random.PRNGKey(0)))
    got = np.array(ex.train(name, AE_STEPS, device='cpu'))
    ref = np.array(ae_reference[name])
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    print(f'{name}: max rel loss diff {np.max(np.abs(got - ref) / ref):.3e}')


def _lm_args(out_dir, device=None):
    args = argparse.Namespace(scale='small', steps=5, batch=8, seq_len=32,
                              lr=0.05, log_every=1, ckpt_every=0,
                              out_dir=str(out_dir), seed=0)
    if device is not None:
        args.device = device
    return args


@pytest.mark.parametrize('opt', ['eva', 'sgd'])
def test_train_lm_run_one_tracks_reference(opt, tmp_path, monkeypatch):
    ref = np.array(_load('train_lm.py').run_one(opt,
                                                _lm_args(tmp_path / 'ref')))
    ex = _load('train_lm_torch.py')
    _inject(monkeypatch, JM.init_params(
        jbuild(jdemo_lm('small')).param_specs(), jax.random.PRNGKey(0)))
    got = np.array(ex.run_one(opt, _lm_args(tmp_path / 'port', 'cpu')))
    assert len(got) == len(ref) == 5
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    print(f'{opt}: max rel loss diff {np.max(np.abs(got - ref) / ref):.3e}')
