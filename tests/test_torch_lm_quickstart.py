"""``examples/quickstart.py`` under the port: ``demo_lm('small')`` trained
by Eva (``lr=0.05, gamma=0.03, kl_kappa=1e-3``) for 100 steps on
``LMStream(seq_len=64, batch=16, seed=0)``, from the reference's
``init_params(PRNGKey(0))``, beside the reference's own run of the same
script.

Both sides run f32 on the CPU in other summation orders, and 100
second-order steps carry the difference forward.  Stated tolerance: every
step's loss within rtol 1e-4 of the reference's (measured: up to 7.4e-7),
and the run learns: the last ten losses' mean at least 1.0 nat below the
first step's and within 2 nats of the chain's entropy (the CE floor).
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import demo_lm as jdemo_lm  # noqa: E402
from repro.core import make_optimizer as jmake  # noqa: E402
from repro.data import LMStream as JLMStream  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.train import init_opt_state as jinit  # noqa: E402
from repro.train import make_train_step as jstep_fn  # noqa: E402
from repro_torch.configs.registry import demo_lm  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.data.synthetic import LMStream  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa
from test_torch_lm_train import _one_thread  # noqa: E402,F401

STEPS = 100
OPT = dict(lr=0.05, gamma=0.03, kl_kappa=1e-3)


def _reference():
    cfg = jdemo_lm('small')
    model = jbuild(cfg)
    params = JM.init_params(model.param_specs(), jax.random.PRNGKey(0))
    data = JLMStream(vocab=cfg.vocab, seq_len=64, batch=16, seed=0)
    opt, capture = jmake('eva', **OPT)
    state = jinit(model, opt, capture, params, data.batch_at(0))
    step = jax.jit(jstep_fn(model, opt, capture))
    losses = []
    for i in range(STEPS):
        params, state, metrics = step(params, state, data.batch_at(i))
        losses.append(float(metrics['loss']))
    return np.array(losses)


def test_quickstart_tracks_reference():
    ref = _reference()
    cfg = demo_lm('small')
    model = build_model(cfg)
    params = M.params_from_numpy(
        JM.init_params(jbuild(jdemo_lm('small')).param_specs(),
                       jax.random.PRNGKey(0)), 'cpu')
    data = LMStream(vocab=cfg.vocab, seq_len=64, batch=16, seed=0,
                    device='cpu')
    opt, capture = make_optimizer('eva', **OPT)
    state = init_opt_state(model, opt, capture, params, data.batch_at(0),
                           device='cpu')
    step = make_train_step(model, opt, capture, device='cpu')
    losses = []
    for i in range(STEPS):
        params, state, metrics = step(params, state, data.batch_at(i))
        losses.append(float(metrics['loss']))
    losses = np.array(losses)
    np.testing.assert_allclose(losses, ref, rtol=1e-4, atol=0)
    tail = losses[-10:].mean()
    assert tail <= losses[0] - 1.0
    assert tail <= data.bigram_ce + 2.0
    print(f'max rel loss diff {np.max(np.abs(losses - ref) / ref):.3e}; '
          f'loss {losses[0]:.4f} -> {tail:.4f} (floor {data.bigram_ce:.4f})')
