"""3 Eva steps of every assigned architecture at its reduced config in
the port against the reference (composed Eva at lr 0.05, the reference's
default kernel path), from the same weights and batch as
``test_torch_families.py``.

Both sides run f32 on the CPU.  Stated tolerances: each step's loss rtol
1e-4, and the final parameters rtol 1e-4, atol 1e-5, as the LM's
trajectories (``test_torch_lm_train.py``).
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa
from test_torch_families import _setup, batch_for  # noqa: E402
from test_torch_lm_modules import _t  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

STEPS, LR = 3, 0.05


@pytest.mark.parametrize('arch', ARCH_IDS)
def test_three_eva_steps(arch):
    jcfg, jm, tm, jp, tp = _setup(arch)
    batch = batch_for(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    jopt, jcap = jmake('eva', lr=LR)
    jst = jinit(jm, jopt, jcap, jp, jbatch)
    jstep = jax.jit(jstep_fn(jm, jopt, jcap))
    topt, tcap = make_optimizer('eva', lr=LR)
    tst = init_opt_state(tm, topt, tcap, tp, tbatch, device='cpu')
    tstep = make_train_step(tm, topt, tcap, device='cpu')
    for i in range(STEPS):
        jp, jst, jmet = jstep(jp, jst, jbatch)
        tp, tst, tmet = tstep(tp, tst, tbatch)
        np.testing.assert_allclose(float(tmet['loss']), float(jmet['loss']),
                                   rtol=1e-4, err_msg=f'{arch} step {i}')
    jflat = jkv.flatten_params(jp)
    assert set(tp) == set(jflat)
    for k, v in tp.items():
        assert torch.isfinite(v).all(), k
        np.testing.assert_allclose(v.numpy(), np.asarray(jflat[k]),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f'{arch} {k}')
