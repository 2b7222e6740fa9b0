"""Eva-f and Eva-s training steps of the port against the reference
(``kernel_impl='pallas_interpret'``), from the same weights and batches,
composed and fused, on the MLP (25 steps) and the narrow autoencoder (10
steps).  The harness is ``test_torch_train.py``'s.

Stated tolerances, as for Eva: per-step loss rtol 1e-4 (atol 1e-6); final
parameters and every leaf of ``EvaFState`` / ``EvaSState`` (and the chained
momentum traces) rtol 1e-4, atol 1e-5; integer counters equal.  Both sides
run f32 on the CPU and sum in other orders.
"""
import pytest

torch = pytest.importorskip('torch')

from test_torch_train import CASES, _check, _run_both  # noqa: E402

from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('name', ['eva_f', 'eva_s'])
def test_eva_fs_slice_matches_reference(name, case, fused):
    _check(*_run_both(CASES[case], name=name, fused=fused))


@pytest.mark.parametrize('name', ['eva_f', 'eva_s'])
def test_eva_fs_weight_decay_matches_reference(name):
    """weight_decay > 0 turns off the kernel's folded inner products
    (``fold_kl=False`` for Eva-f, ``fold_graft=False`` for Eva-s): the tail
    takes them against the raw gradients instead."""
    case = dict(CASES['mlp'], steps=10)
    _check(*_run_both(case, name=name, fused=True, weight_decay=1e-3))


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('name', ['eva_f', 'eva_s'])
def test_eva_fs_cuda_impl_refuses_cpu_tensors(name, fused):
    """The registry gives the reference's capture; with
    ``kernel_impl='cuda'`` a step on CPU tensors raises instead of running
    the plain versions in the kernels' place."""
    opt, cap = make_optimizer(name, fused=fused, kernel_impl='cuda')
    jcap = jmake(name)[1]
    assert (cap.a, cap.b) == (jcap.a, jcap.b)
    model = simple.MLP([16, 32, 4])
    model.loss_fn = simple.classifier_loss_fn(model)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device='cpu')
    batch = tsyn.ClassStream(batch=8, dim=16, classes=4,
                             device='cpu').batch_at(0)
    state = init_opt_state(model, opt, cap, params, batch, device='cpu')
    step = make_train_step(model, opt, cap, device='cpu')
    with pytest.raises(ValueError, match="'cuda' needs CUDA tensors"):
        step(params, state, batch)
